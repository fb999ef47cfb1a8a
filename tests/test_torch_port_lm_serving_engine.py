"""``LMServingEngine``'s admission, streaming, scheduling and open-loop
accounting, held against the JAX package.

Split from ``test_torch_port_lm_serving.py``,
whose docstring states what is held against the JAX package and with which
tolerances; the helpers and fixtures come from there.  No test file of the
port holds more than 25 tests: pytest-xdist's ``loadfile`` scheduler hands
out the largest files first (ROADMAP.md, standing rules).
"""

import time

import numpy as np
import pytest
import torch

from bigdl_tpu.serving.loadgen import sample_lm_workload as jax_workload
import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.models.transformer import transformer_lm
from bigdl_tpu_torch.serving import (DeadlineExceeded, LMServingEngine,
                                     Overloaded, run_lm_open_loop,
                                     run_open_loop, sample_lm_workload,
                                     ServingDataError, ServingEngine,
                                     ServingInfraError, UnsupportedModelError)
from bigdl_tpu_torch.utils import config

from test_torch_port_lm_serving import (_clean_keys, _engine, _identity,
                                        _prompt, ENGINE, jax_engine, models,
                                        offline, SHAPE, VOCAB)


def test_non_lm_model_is_refused_structurally():
    m = (nn.Sequential().add(nn.Linear(4, 8, device="cpu")).add(nn.ReLU())
         .add(nn.Linear(8, 3, device="cpu")))
    with pytest.raises(UnsupportedModelError, match="transformer_lm-shaped"):
        LMServingEngine(m, device="cpu")


def test_max_context_beyond_position_table_is_refused(models):
    with pytest.raises(ValueError, match="PositionalEncoding"):
        LMServingEngine(models[1], max_context=128, device="cpu")


def test_never_fits_prompt_rejected_at_the_door(models):
    # 3 allocatable blocks x 4 slots = 12 tokens at most
    eng = _engine(models[1], warm=False, cache_blocks=4)
    with pytest.raises(Overloaded, match="kv blocks exhausted"):
        eng.submit(_prompt(8), max_new_tokens=8)
    eng.close()
    _identity(eng.stats())


def test_over_context_prompt_is_quarantined(models):
    with _engine(models[1]) as eng:
        eng.start()
        s = eng.submit(_prompt(30), max_new_tokens=8)   # 38 > 32
        with pytest.raises(ServingDataError, match="maxContext"):
            s.result(timeout=10)
        assert s.outcome == "quarantined"
        stats = eng.stats()
    _identity(stats)


def test_stream_iterates_tokens_and_completes(models, offline):
    with _engine(models[1]) as eng:
        eng.start()
        s = eng.submit(_prompt(6), max_new_tokens=6)
        got = list(s)
        assert got == s.result(timeout=10) and len(got) == 6
        assert s.outcome == "completed"
        assert s.ttft_ms() > 0 and s.latency_ms() >= s.ttft_ms()
        stats = eng.stats()
    _identity(stats)
    assert got == offline.generate(_prompt(6), max_new_tokens=6)


def test_eos_finishes_early(models):
    with _engine(models[1]) as eng:
        eng.start()
        toks = eng.submit(_prompt(6, seed=2),
                          max_new_tokens=8).result(timeout=10)
        s = eng.submit(_prompt(6, seed=2), max_new_tokens=8, eos_id=toks[2])
        assert s.result(timeout=10) == toks[:toks.index(toks[2]) + 1]
        assert s.outcome == "completed"


def test_iteration_level_batching_shares_decode_steps(models, offline):
    with _engine(models[1]) as eng:
        eng.start()
        streams = [eng.submit(_prompt(5, seed=i), max_new_tokens=8)
                   for i in range(8)]
        outs = [s.result(timeout=30) for s in streams]
        stats = eng.stats()
    assert all(len(o) == 8 for o in outs)
    # one decode step per token would take tokens - prefills steps
    assert stats["decode_steps"] < stats["tokens_out"] - stats["prefills"]
    _identity(stats)
    for i, o in enumerate(outs):
        assert o == offline.generate(_prompt(5, seed=i), max_new_tokens=8)


def test_blocks_free_after_drain(models):
    with _engine(models[1]) as eng:
        eng.start()
        for i in range(6):
            eng.submit(_prompt(4, seed=i), max_new_tokens=4)
        eng.stop()
        assert eng.cache.used_blocks == 0
        assert not eng.scheduler_alive()
        _identity(eng.stats())


def test_deadline_sheds_after_streamed_prefix(models):
    """The deadline check runs AFTER an iteration's emit, so a stream that
    expires mid-generation keeps its prefix and ends with a structured
    error.  The second decode step is slowed to 1 s, twice the
    deadline."""
    with _engine(models[1]) as eng:
        step, calls = eng._decode_step, []

        def slow_step(inputs):
            calls.append(None)
            if len(calls) == 2:
                time.sleep(1.0)
            return step(inputs)

        eng._decode_step = slow_step
        eng.start()
        s = eng.submit(_prompt(5), max_new_tokens=10, deadline_ms=500.0)
        got = []
        with pytest.raises(DeadlineExceeded):
            for tok in s:
                got.append(tok)
        assert s.outcome == "shed"
        assert len(got) >= 1 and got == s.tokens()
        stats = eng.stats()
    _identity(stats)
    assert eng.cache.used_blocks == 0


def test_generate_refused_while_scheduler_runs(models):
    with _engine(models[1], warm=False) as eng:
        eng.start()
        with pytest.raises(ServingInfraError, match="offline"):
            eng.generate(_prompt(4))


def test_submit_after_close_is_rejected(models):
    eng = _engine(models[1], warm=False, start=True)
    eng.close()
    with pytest.raises(Overloaded, match="closed"):
        eng.submit(_prompt(4))
    _identity(eng.stats())
    assert eng.terminal


def test_open_loop_accounting_and_tokens_match_jax(models, jax_engine):
    kw = dict(seed=7, prompt_lens=(4, 8, 16), output_lens=(4, 8))
    reqs = sample_lm_workload(12, VOCAB, **kw)
    for (p, o), (jp, jo) in zip(reqs, jax_workload(12, VOCAB, **kw)):
        assert o == jo and np.array_equal(p, jp)
    with _engine(models[1]) as eng:
        eng.start()
        rec = run_lm_open_loop(eng, reqs, rate_hz=500.0, seed=4)
        stats = eng.stats()
    _identity(rec)
    _identity(stats)
    assert rec["completed"] == 12 and eng.cache.used_blocks == 0
    assert rec["tokens_total"] == sum(o for _, o in reqs)
    assert rec["p99_ttft_ms"] is not None and rec["p99_itl_ms"] is not None
    for (prompt, max_new), (_, s) in zip(reqs, rec["streams"]):
        assert s.result(timeout=1) == jax_engine.generate(
            prompt, max_new_tokens=max_new)


def test_run_open_loop_drives_serving_engine():
    """The port's copy of the generic open loop, over ``ServingEngine``:
    every row completed, the identity exact, each result the model's."""
    model = transformer_lm(VOCAB, device="cpu", **SHAPE)
    rows = np.random.default_rng(8).integers(
        1, VOCAB + 1, (5, 8)).astype(np.float32)
    with ServingEngine(model, max_batch=2, deadline_ms=60000.0,
                       device="cpu") as eng:
        rec = run_open_loop(eng, rows, rate_hz=0.0)
    _identity(rec)
    assert rec["completed"] == 5 and len(rec["latency_ms"]) == 5
    with torch.no_grad():
        ref = model(torch.from_numpy(rows)).numpy()
    for i in range(5):
        np.testing.assert_allclose(rec["results"][str(i)], ref[i],
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["quantize_arg", "quantize_key",
                                  "stall_factor"])
def test_left_out_features_raise(case, models):
    """The int8 tier and the watchdog build, and every configuration has
    its recompile sentinels (they raised NotImplementedError before the
    port had them): one per step, ``lm_decode_int8`` with the int8 tier,
    every planned shape registered as a warmup plan, none a retrace."""
    kw = {}
    if case == "quantize_arg":
        kw["quantize"] = "int8"
    elif case == "quantize_key":
        config.set_property("bigdl.lm.quantize", "int8")
    else:
        config.set_property("bigdl.lm.stallFactor", 20.0)
    eng = LMServingEngine(models[1], device="cpu", **ENGINE, **kw)
    assert eng.quantize == ("off" if case == "stall_factor" else "int8")
    labels = {"lm_decode", "lm_prefill", "lm_full"}
    if eng.quantize == "int8":
        labels.add("lm_decode_int8")
    sentinels = eng.sentinels
    assert set(sentinels) == labels
    assert sentinels["lm_prefill"].compiles_in_warmup == len(eng._buckets)
    assert all(s.retraces == 0 for s in sentinels.values())
    eng.close()


def test_cuda_is_the_default_device(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LMServingEngine(models[1], **ENGINE)
