"""The port's ``ServingEngine`` held against the JAX package's.

Both engines serve the same 6 rows of 128 token ids over the same small
transformer LM (vocab 64, d_model 128, 1 head, 2 layers; the JAX parameters
carried over), the port's on ``device="cpu"``.  Per-request results agree to
atol 1e-4 (fp32 log-probs, as in ``test_torch_port_lm.py``), and the
accounting identity ``completed + shed + rejected + quarantined ==
submitted`` holds in both.  The admission and quarantine contracts are
checked in both packages side by side.  Every engine is closed by ``with``
or ``stop()``, which joins its batcher thread.
"""

import time

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import transformer_lm as jax_lm
from bigdl_tpu.serving import ServingEngine as JaxServingEngine
from bigdl_tpu.serving.engine import Overloaded as JaxOverloaded
from bigdl_tpu.serving.engine import ServingDataError as JaxServingDataError
from bigdl_tpu_torch.models.transformer import transformer_lm
from bigdl_tpu_torch.optim.predictor import Predictor
from bigdl_tpu_torch.serving import (DeadlineExceeded, Overloaded,
                                     ServingDataError, ServingEngine,
                                     ServingInfraError)
from bigdl_tpu_torch.serving.engine import OUTCOMES
from bigdl_tpu_torch.utils import config
from bigdl_tpu_torch.utils.convert import params_from_jax

VOCAB, T = 64, 128
SHAPE = dict(d_model=128, n_head=1, n_layers=2, max_len=256)
LONG = 60_000.0   # deadline (ms) no request can reach in these tests


@pytest.fixture(scope="module")
def models():
    jm = jax_lm(VOCAB, **SHAPE)
    jm.reset(jax.random.PRNGKey(0))
    pm = transformer_lm(VOCAB, flash=True, device="cpu", **SHAPE)
    params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), pm)
    return jm, pm


def _rows(n, seed=0):
    return np.random.default_rng(seed).integers(
        1, VOCAB + 1, (n, T)).astype(np.float32)


def _identity(stats):
    assert stats["unaccounted"] == 0, stats
    assert sum(stats[o] for o in OUTCOMES) == stats["submitted"], stats


def test_served_results_match_jax(models):
    jm, pm = models
    rows = _rows(6)
    outs = {}
    for name, engine in (
            ("jax", lambda: JaxServingEngine(jm, max_batch=4,
                                             deadline_ms=LONG)),
            ("port", lambda: ServingEngine(pm, max_batch=4,
                                           deadline_ms=LONG,
                                           device="cpu"))):
        with engine() as eng:
            eng.warmup(rows[0])
            handles = [eng.submit(r) for r in rows]
            outs[name] = [np.asarray(h.result(timeout=120)) for h in handles]
            stats = eng.stats()
        _identity(stats)
        assert stats["completed"] == 6
    for got, ref in zip(outs["port"], outs["jax"]):
        assert isinstance(got, np.ndarray) and got.shape == (T, VOCAB)
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_predictor_matches_served_rows(models):
    """The port's Predictor with a bucket plan: padded rows sliced off,
    results equal to the JAX model's forward."""
    jm, pm = models
    rows = _rows(5, seed=1)
    ref = np.asarray(jm.apply(jm.params, rows, jm.state)[0])
    config.set_property("bigdl.compile.buckets", "4")
    try:
        out = Predictor(pm, device="cpu").predict(rows, batch_size=3)
    finally:
        config.clear_property("bigdl.compile.buckets")
    assert out.shape == (5, T, VOCAB)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_ill_shaped_row_is_quarantined_in_both(models):
    jm, pm = models
    rows = _rows(2, seed=2)
    for engine, data_error in (
            (lambda: JaxServingEngine(jm, max_batch=4, deadline_ms=LONG),
             JaxServingDataError),
            (lambda: ServingEngine(pm, max_batch=4, deadline_ms=LONG,
                                   device="cpu"), ServingDataError)):
        with engine() as eng:
            eng.warmup(rows[0])
            good = [eng.submit(r) for r in rows]
            bad = eng.submit(rows[0][:T // 2])
            with pytest.raises(data_error, match="ill-shaped"):
                bad.result(timeout=120)
            for h in good:
                assert h.result(timeout=120).shape == (T, VOCAB)
            stats = eng.stats()
        _identity(stats)
        assert stats["quarantined"] == 1 and stats["completed"] == 2


def test_full_queue_rejects_in_both(models):
    jm, pm = models
    row = _rows(1, seed=3)[0]
    for engine, overloaded in (
            (lambda: JaxServingEngine(jm, max_queue_depth=2, start=False,
                                      deadline_ms=LONG), JaxOverloaded),
            (lambda: ServingEngine(pm, max_queue_depth=2, start=False,
                                   deadline_ms=LONG, device="cpu"),
             Overloaded)):
        eng = engine()
        try:
            eng.submit(row)
            eng.submit(row)
            with pytest.raises(overloaded) as ei:
                eng.submit(row)
            assert ei.value.reason == "queue full" and ei.value.retriable
            assert ei.value.queue_depth == 2 and ei.value.max_depth == 2
        finally:
            eng.stop()
        stats = eng.stats()
        _identity(stats)
        assert stats["rejected"] == 1
        assert stats["shed"] == 2     # a never-started engine sheds on stop


def test_non_numeric_payload_is_quarantined(models):
    _, pm = models
    with ServingEngine(pm, deadline_ms=LONG, device="cpu") as eng:
        h = eng.submit(np.array(["not", "numbers"]))
        with pytest.raises(ServingDataError, match="non-numeric"):
            h.result(timeout=120)
        assert h.outcome == "quarantined"
    _identity(eng.stats())


def test_expired_request_is_shed_at_dequeue(models):
    _, pm = models
    eng = ServingEngine(pm, start=False, device="cpu")
    try:
        h = eng.submit(_rows(1)[0], deadline_ms=0.001)
        time.sleep(0.01)
        eng.start()
        with pytest.raises(DeadlineExceeded):
            h.result(timeout=120)
        assert h.outcome == "shed"
    finally:
        eng.stop()
    _identity(eng.stats())


def test_projected_wait_rejects_at_the_door(models):
    _, pm = models
    eng = ServingEngine(pm, start=False, max_batch=2, deadline_ms=100.0,
                        device="cpu")
    try:
        eng._ema.ema = 500.0        # 500 ms per batch, observed
        with pytest.raises(Overloaded) as ei:
            eng.submit(_rows(1)[0])
        assert ei.value.reason == "projected wait"
        assert ei.value.projected_wait_ms >= 500.0
        assert eng.submit(_rows(1)[0], deadline_ms=LONG).index == 0
    finally:
        eng.stop()
    _identity(eng.stats())


def test_stop_is_terminal_and_idempotent(models):
    _, pm = models
    eng = ServingEngine(pm, device="cpu")
    eng.stop()
    eng.stop()
    assert eng.terminal and not eng.batcher_alive()
    with pytest.raises(Overloaded) as ei:
        eng.submit(_rows(1)[0])
    assert ei.value.reason == "closed"
    with pytest.raises(ServingInfraError):
        eng.start()
    _identity(eng.stats())


def test_entry_points_check_their_device(models):
    _, pm = models
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServingEngine(pm)       # default device: cuda
    # fold_bn serves a folded copy in eval mode; the caller's model stays
    eng = ServingEngine(pm, fold_bn=True, start=False, device="cpu")
    assert eng.model is not pm and not eng.model.training
    with pytest.raises(ValueError, match="not on"):
        Predictor(pm, device="meta")
