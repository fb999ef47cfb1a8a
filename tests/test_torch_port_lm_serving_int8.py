"""``LMServingEngine``'s int8 decode tier and failure taxonomy (preemption,
the hung-decode watchdog, prompt and block chaos), held against the JAX
package.

Split from ``test_torch_port_lm_serving.py``,
whose docstring states what is held against the JAX package and with which
tolerances; the helpers and fixtures come from there.  No test file of the
port holds more than 25 tests: pytest-xdist's ``loadfile`` scheduler hands
out the largest files first (ROADMAP.md, standing rules).
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import serving as jax_serving
from bigdl_tpu.serving import lm as jax_lm_serving
from bigdl_tpu.utils import elastic as jax_elastic
from bigdl_tpu_torch import serving as port_serving
from bigdl_tpu_torch.serving import (LMServingEngine, lm as port_lm_serving,
                                     QuantizationGateError)
from bigdl_tpu_torch.serving.engine import OUTCOMES
from bigdl_tpu_torch.serving.kv_cache import DUMP_BLOCK
from bigdl_tpu_torch.utils import config, elastic

from test_torch_port_lm_serving import (_clean_keys, _engine, _identity,
                                        _leaves, _np, _pair_engine, _prompt,
                                        _verdict, both, ENGINE, int8_pair,
                                        jax_engine, models, offline, PACKAGES,
                                        WEDGE)


def test_sentinels_raise_and_unknown_quantize_is_refused(models, offline,
                                                          jax_engine):
    """An unknown tier is refused; the offline engine (warmed up, then
    generating at mixed prompt lengths) shows zero post-warmup retraces
    under the JAX engine's labels."""
    for tier in ("fp8", "int4"):
        with pytest.raises(ValueError, match="int8"):
            LMServingEngine(models[1], device="cpu", quantize=tier, **ENGINE)
    for n in (3, 9, 17):
        offline.generate(_prompt(n, seed=n), max_new_tokens=3)
        offline.generate_sequential(_prompt(n, seed=n), max_new_tokens=2)
    sentinels = offline.sentinels
    assert set(sentinels) == set(jax_engine.sentinels)
    assert all(s.retraces == 0 and s.calls > 0 for s in sentinels.values())


def test_quantize_params_match_jax_bit_for_bit(int8_pair):
    jeng, peng = int8_pair
    got = dict(_leaves(peng._dp_q))
    ref = {k: v for k, v in _leaves(jeng._dp_q) if k in got}
    assert got.keys() == ref.keys()
    assert sum(k.endswith("/q") for k in got) == 2 * 6 + 1
    for k, v in got.items():
        assert v.dtype == ref[k].dtype and v.shape == ref[k].shape, k
        assert v.tobytes() == ref[k].tobytes(), k
    # an all-zero column (s -> 1, q 0) and steps of exactly .5 (half to
    # even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -2.5 -> -2)
    w = np.random.default_rng(4).standard_normal((8, 5)).astype(np.float32)
    w[:, 1] = 0.0
    w[:, 3] = [127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 3.5, 0.0]
    je = jax_lm_serving._quantize_entry({"w": jnp.asarray(w), "b": None})
    pe = port_lm_serving._quantize_entry(
        {"w": torch.from_numpy(np.ascontiguousarray(w.T)).t(), "b": None})
    assert _np(pe["q"]).tobytes() == np.asarray(je["q"]).tobytes()
    assert _np(pe["s"]).tobytes() == np.asarray(je["s"]).tobytes()
    assert _np(pe["q"])[:, 3].tolist() == [127, 0, 2, 2, -2, 0, 4, 0]
    assert _np(pe["s"])[1] == 1.0 and not _np(pe["q"])[:, 1].any()


def test_int8_prefill_and_decode_steps_match_jax(int8_pair):
    jeng, peng = int8_pair
    mb = peng._max_blocks
    shape = tuple(peng.cache.k.shape)
    jk = jv = jnp.zeros(shape, jnp.float32)
    pk, pv = torch.zeros(shape), torch.zeros(shape)
    inputs = peng._idle_inputs()
    jin = (np.ones((4, 1), np.int32), np.zeros((4,), np.int32),
           np.full((4, mb), DUMP_BLOCK, np.int32), np.zeros((4,), bool))
    # prompts of 8 and 6 ids: prefill bucket 8, which the JAX gate compiled
    for slot, (n, seed, blocks) in enumerate(((8, 11, [1, 2, 3]),
                                              (6, 12, [4, 5]))):
        prompt = _prompt(n, seed)
        padded = np.ones((1, 8), np.int32)
        padded[0, :n] = prompt
        table = np.full((mb,), DUMP_BLOCK, np.int32)
        table[:len(blocks)] = blocks
        jlp, jk, jv = jeng._prefill(jeng._dp, jk, jv, padded, np.int32(n),
                                    table)
        with torch.no_grad():
            plp = peng._prefill_fn(peng._dp, pk, pv,
                                   torch.from_numpy(padded).long(), n,
                                   torch.from_numpy(table).long())
        np.testing.assert_allclose(_np(plp), np.asarray(jlp), atol=1e-5,
                                   rtol=0)
        tok = int(np.argmax(np.asarray(jlp))) + 1
        inputs[slot, :3] = (tok, n, 1)
        inputs[slot, 3:] = table
        jin[0][slot, 0], jin[1][slot] = tok, n
        jin[2][slot], jin[3][slot] = table, True
    jlp, _, _ = jeng._decode_q(jeng._dp_q, jk, jv, *jin)
    with torch.no_grad():
        plp = peng._run_decode(pk, pv, torch.from_numpy(inputs),
                               quantized=True)
    np.testing.assert_allclose(_np(plp)[:2], np.asarray(jlp)[:2], atol=1e-5,
                               rtol=0)


def test_int8_generate_and_gate_report_match_jax(int8_pair):
    jeng, peng = int8_pair
    for n, seed in ((8, 13), (5, 14)):
        p = _prompt(n, seed)
        jt, jl = jeng.generate(p, max_new_tokens=10, return_logps=True)
        pt, pl = peng.generate(p, max_new_tokens=10, return_logps=True)
        assert pt == jt
        for a, b in zip(pl, jl):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0)
    rep = peng.quantization_report
    assert rep["audit_ok"] is None and "not ported" in rep["audit"]
    assert rep["allclose"] and (rep["rtol"], rep["atol"]) == (0.05, 0.05)
    assert set(jeng.quantization_report) <= set(rep)
    assert abs(rep["max_abs_diff"] -
               jeng.quantization_report["max_abs_diff"]) <= 1e-5
    assert peng.decode_captures == 0 and peng.cache.used_blocks == 0


def test_int8_gate_refuses_drift(models):
    config.set_property("bigdl.lm.quantizeRtol", 0.0)
    config.set_property("bigdl.lm.quantizeAtol", 1e-9)
    with pytest.raises(QuantizationGateError, match="drifted past"):
        LMServingEngine(models[1], quantize="int8", device="cpu", **ENGINE)


def test_int8_engine_streams(models, int8_pair):
    with _engine(models[1], quantize="int8") as eng:
        eng.start()
        s = eng.submit(_prompt(6, seed=15), max_new_tokens=6)
        assert s.result(timeout=30) == int8_pair[1].generate(
            _prompt(6, seed=15), max_new_tokens=6)
        stats = eng.stats()
    _identity(stats)
    assert eng.cache.used_blocks == 0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_preemption_drains_and_rejects_late_arrivals(pkg, models):
    mod, el = (jax_serving, jax_elastic) if pkg == "jax" else \
        (port_serving, elastic)
    with _pair_engine(pkg, models) as eng:
        eng.start()
        streams = [eng.submit(_prompt(4, seed=i), max_new_tokens=4)
                   for i in range(4)]
        el.request_preemption(reason="test SIGTERM")
        deadline = time.monotonic() + 5
        while True:
            try:
                eng.submit(_prompt(4))
            except mod.Overloaded as e:
                rejected = e
                break
            assert time.monotonic() < deadline
            time.sleep(0.005)
        assert rejected.reason in ("draining", "closed")
        assert rejected.retriable
        for s in streams:
            assert len(s.result(timeout=30)) == 4
        assert eng.draining
    stats = eng.stats()
    _identity(stats)
    assert stats["completed"] >= 4 and stats["rejected"] >= 1
    assert eng.cache.used_blocks == 0


def test_hung_decode_is_aborted_cooled_and_readmitted(models):
    both(bigdl__lm__stallFactor=50.0, bigdl__lm__warmupSteps=2,
         bigdl__lm__pollInterval=0.2,
         bigdl__chaos__hangDecodeAt=f"8:{WEDGE}")
    seen = {}
    for pkg, mod, _, _, _ in PACKAGES:
        verdicts, tokens = [], []
        with _pair_engine(pkg, models) as eng:
            eng.start()
            # decode steps 1-7 finish a clean stream and seed the EMA
            s = eng.submit(_prompt(4), max_new_tokens=8)
            tokens.append(s.result(timeout=30))
            verdicts.append(_verdict(s))
            t0 = time.monotonic()
            victim = eng.submit(_prompt(4, seed=1), max_new_tokens=8)
            with pytest.raises(mod.HungDispatchError, match="wedged past"):
                victim.result(timeout=30)
            abort_s = time.monotonic() - t0
            verdicts.append(_verdict(victim))
            assert abort_s < WEDGE, f"{pkg}: the abort took {abort_s:.2f} s"
            deadline = time.monotonic() + 5
            while eng.stats()["cooldown"] == 0:
                assert time.monotonic() < deadline
                time.sleep(0.002)
            with pytest.raises(mod.Overloaded) as ei:
                eng.submit(_prompt(4, seed=2), max_new_tokens=4)
            assert ei.value.reason == "cooldown" and ei.value.retriable
            verdicts.append(_verdict(None, ei.value))
            # the scheduler's next idle poll (the queue is empty) re-admits
            while eng.stats()["cooldown"] != 0:
                assert time.monotonic() < deadline + 5
                time.sleep(0.01)
            s = eng.submit(_prompt(4, seed=2), max_new_tokens=4)
            tokens.append(s.result(timeout=30))
            verdicts.append(_verdict(s))
            stats = eng.stats()
        _identity(stats)
        assert eng.cache.used_blocks == 0
        seen[pkg] = (verdicts, {o: stats[o] for o in OUTCOMES}, tokens)
    assert seen["port"] == seen["jax"]
    assert seen["port"][1] == {"completed": 2, "shed": 1, "rejected": 1,
                               "quarantined": 0}


def test_prompt_and_block_chaos_match_jax_per_index(models):
    """poisonPromptAt 1 quarantines the second stream; evictBlockAt 2
    evicts the first slot's blocks at decode step 2, which sheds the first
    stream with the prefix it streamed; the third completes."""
    both(bigdl__chaos__poisonPromptAt="1", bigdl__chaos__evictBlockAt=2)
    seen = {}
    for pkg, _, _, _, _ in PACKAGES:
        with _pair_engine(pkg, models) as eng:
            streams = [eng.submit(_prompt(4, seed=20 + i), max_new_tokens=6)
                       for i in range(3)]
            eng.start()
            for s in streams:
                try:
                    s.result(timeout=30)
                except Exception:
                    pass
            stats = eng.stats()
        _identity(stats)
        assert eng.cache.used_blocks == 0
        seen[pkg] = ([_verdict(s) for s in streams],
                     [s.tokens() for s in streams])
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == [("shed", "ServingInfraError"),
                               ("quarantined", "ServingDataError"),
                               ("completed", None)]
    tokens = seen["port"][1]
    assert len(tokens[0]) >= 1 and tokens[1] == [] and len(tokens[2]) == 6
