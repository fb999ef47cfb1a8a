"""The port's ``ServingEngine`` held against the JAX package's.

Both engines serve the same 6 rows of 128 token ids over the same small
transformer LM (vocab 64, d_model 128, 1 head, 2 layers; the JAX parameters
carried over), the port's on ``device="cpu"``.  Per-request results agree to
atol 1e-4 (fp32 log-probs, as in ``test_torch_port_lm.py``), and the
accounting identity ``completed + shed + rejected + quarantined ==
submitted`` holds in both.  The admission and quarantine contracts are
checked in both packages side by side.  Every engine is closed by ``with``
or ``stop()``, which joins its batcher thread.

The failure taxonomy runs the same ``bigdl.*`` keys and chaos plan through
both packages' engines (config, chaos and the preemption flag are each
package's own, set and cleared together by ``both``): the hung-dispatch
watchdog (stallFactor 20 over a batch EMA of about 6 ms on this CPU, a
1 s wedge), its cooldown (``pollInterval`` 0.2 s keeps the cooldown up
for 0.2 s after the abort, long enough to observe it), the drain on a
preemption request, the chaos hooks, the batcher's linger, the burst
arrivals, ``abandon`` and the lifecycle probes.
"""

import time

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import transformer_lm as jax_lm
from bigdl_tpu import serving as jax_serving
from bigdl_tpu.resources import GOVERNOR as JAX_GOVERNOR
from bigdl_tpu.serving import ServingEngine as JaxServingEngine
from bigdl_tpu.serving.engine import Overloaded as JaxOverloaded
from bigdl_tpu.serving.engine import ServingDataError as JaxServingDataError
from bigdl_tpu.utils import chaos as jax_chaos
from bigdl_tpu.utils import config as jax_config
from bigdl_tpu.utils import elastic as jax_elastic
from bigdl_tpu_torch import serving as port_serving
from bigdl_tpu_torch.models.transformer import transformer_lm
from bigdl_tpu_torch.optim.predictor import Predictor
from bigdl_tpu_torch.resources import GOVERNOR
from bigdl_tpu_torch.serving import (DeadlineExceeded, HungDispatchError,
                                     Overloaded, ServingDataError,
                                     ServingEngine, ServingInfraError)
from bigdl_tpu_torch.serving.engine import OUTCOMES
from bigdl_tpu_torch.utils import chaos, config, elastic
from bigdl_tpu_torch.utils.convert import params_from_jax
from test_torch_port_analysis import port_lock_witness  # noqa: F401

VOCAB, T = 64, 128
SHAPE = dict(d_model=128, n_head=1, n_layers=2, max_len=256)
LONG = 60_000.0   # deadline (ms) no request can reach in these tests
WEDGE = 1.0       # seconds of every injected wedge
_KEYS = ("bigdl.serving.stallFactor", "bigdl.serving.lingerMs",
         "bigdl.serving.warmupBatches", "bigdl.serving.pollInterval",
         "bigdl.chaos.slowRequestAt", "bigdl.chaos.poisonRequestAt",
         "bigdl.chaos.hangDispatchAt", "bigdl.chaos.burstArrivals")
#: (package name, its serving module, its chaos, its config, its elastic)
PACKAGES = (("jax", jax_serving, jax_chaos, jax_config, jax_elastic),
            ("port", port_serving, chaos, config, elastic))


@pytest.fixture(autouse=True)
def _clean():
    """Chaos disarmed, the preemption flags cleared and every key put back
    in both packages (all process-wide)."""
    yield
    for _, _, ch, cfg, el in PACKAGES:
        ch.uninstall()
        el.clear_preemption()
        for k in _KEYS:
            cfg.clear_property(k)


def both(**keys):
    """Set ``bigdl.*`` keys (dots as ``__``) in both packages and arm both
    chaos plans."""
    for _, _, ch, cfg, _ in PACKAGES:
        for k, v in keys.items():
            cfg.set_property(k.replace("__", "."), v)
        ch.install()


def _make(pkg, models, **kw):
    """An engine of either package over the same weights.  ``max_batch``
    defaults to 4, the one batch shape the JAX forward compiles here."""
    jm, pm = models
    kw = {"deadline_ms": LONG, "max_batch": 4, **kw}
    if pkg == "jax":
        return JaxServingEngine(jm, **kw)
    return ServingEngine(pm, device="cpu", **kw)


def _verdict(h, err=None):
    """(outcome, reason) of one submission: an Overloaded's reason, or the
    terminal error's class name."""
    if h is None:
        return ("rejected", err.reason)
    e = h.error()
    return (h.outcome, type(e).__name__ if e is not None else None)


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


def test_sentinel_sees_no_retrace_over_ragged_batches(models):
    """``bigdl.compile.buckets=1,2,4``: every padded batch is a planned
    shape, registered when the row family first runs (the JAX engine's
    bucket plan registers its variants the same way), so ragged batches
    after warmup are no retrace."""
    config.set_property("bigdl.compile.buckets", "1,2,4")
    try:
        with _make("port", models) as eng:
            eng.warmup(_rows(1)[0])
            sentinel = eng.sentinel
            assert sentinel is not None and sentinel.calls == 3
            assert sentinel.compiles_in_warmup == 3
            for n in (1, 3, 2, 4):
                handles = [eng.submit(r) for r in _rows(n, seed=n)]
                for h in handles:
                    h.result(timeout=120)
            assert sentinel.retraces == 0 and sentinel.calls > 3
            assert len(sentinel._seen) == 3
    finally:
        config.clear_property("bigdl.compile.buckets")


def _tanh_engine(pkg):
    """A shape-agnostic model (one ``Tanh``) behind either package's
    engine, so a drifted row still runs."""
    if pkg == "jax":
        import bigdl_tpu.nn as jnn
        m = jnn.Sequential().add(jnn.Tanh())
        m.reset(jax.random.PRNGKey(0))
        return JaxServingEngine(m, max_batch=4, deadline_ms=LONG)
    import bigdl_tpu_torch.nn as pnn
    return ServingEngine(pnn.Sequential().add(pnn.Tanh()), max_batch=4,
                         deadline_ms=LONG, device="cpu")


@pytest.mark.parametrize("drift", [np.zeros(6, np.float32),
                                   np.zeros(8, np.int32)],
                         ids=["width", "dtype"])
def test_drifted_row_after_warmup_retraces_as_in_jax(drift):
    """``bigdl.compile.buckets=1,2,4``: a row family first seen after
    warmup (re-pinned by a second ``warmup``) counts the same retraces and
    warmup plans in both packages, and a strict sentinel raises in both."""
    from bigdl_tpu.analysis.retrace import RetraceError as JaxRetraceError
    from bigdl_tpu_torch.analysis import RetraceError
    counts = {}
    for pkg, cfg, err in (("jax", jax_config, JaxRetraceError),
                          ("port", config, RetraceError)):
        cfg.set_property("bigdl.compile.buckets", "1,2,4")
        cfg.set_property("bigdl.analysis.retrace", "warn")
        try:
            with _tanh_engine(pkg) as eng:
                eng.warmup(np.zeros(8, np.float32))
                for n in (1, 3, 2, 4):
                    for h in [eng.submit(np.ones(8, np.float32))
                              for _ in range(n)]:
                        h.result(timeout=60)
                s = eng.sentinel
                before = (s.retraces, s.compiles_in_warmup)
                eng.warmup(drift)
                counts[pkg] = before + (s.retraces, s.compiles_in_warmup)
                s.mode = "strict"
                with pytest.raises(err, match="shape"):
                    eng.warmup(drift.astype(np.float16))
        finally:
            cfg.clear_property("bigdl.compile.buckets")
            cfg.clear_property("bigdl.analysis.retrace")
    assert counts["port"] == counts["jax"] == (0, 3, 1, 5), counts


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


# ---------------------------------------------------------------------------
# the failure taxonomy, both packages under the same keys and chaos plan
# ---------------------------------------------------------------------------

def test_watchdog_and_linger_keys_are_read(models):
    """A ServingEngine with ``stallFactor`` > 0 arms a watchdog on its
    batcher thread and one with ``lingerMs`` > 0 lingers; neither key is
    ignored."""
    config.set_property("bigdl.serving.stallFactor", 20.0)
    config.set_property("bigdl.serving.lingerMs", 7.5)
    with _make("port", models) as eng:
        assert eng.stall_factor == 20.0 and eng.linger_ms == 7.5
        deadline = time.monotonic() + 5
        while eng.watchdog is None:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        assert eng.watchdog.factor == 20.0
        assert eng.watchdog._driver_tid == eng.batcher_ident()
    assert eng.watchdog._thread is None     # joined by stop()
    eng = _make("port", models, stall_factor=3.0, cooldown_batches=5,
                start=False)
    assert (eng.stall_factor, eng.cooldown_batches) == (3.0, 5)
    eng.stop()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_preemption_drains_and_rejects_late_arrivals(pkg, models):
    rows = _rows(6, seed=8)
    _, mod, _, _, el = dict((p[0], p) for p in PACKAGES)[pkg]
    with _make(pkg, models) as eng:
        eng.warmup(rows[0])
        handles = [eng.submit(r) for r in rows]
        el.request_preemption(reason="test SIGTERM")
        deadline = time.monotonic() + 5
        while True:
            try:
                eng.submit(rows[0])
            except mod.Overloaded as e:
                rejected = e
                break
            assert time.monotonic() < deadline
            time.sleep(0.005)
        assert rejected.reason in ("draining", "closed")
        assert rejected.retriable
        for h in handles:
            assert h.result(timeout=60).shape == (T, VOCAB)
        assert eng.draining
    stats = eng.stats()
    _identity(stats)
    assert stats["completed"] >= len(rows) and stats["rejected"] >= 1


def test_hung_dispatch_is_aborted_cooled_and_readmitted(models):
    both(bigdl__chaos__hangDispatchAt=f"5:{WEDGE}",
         bigdl__serving__warmupBatches=2,
         bigdl__serving__pollInterval=0.2)
    row = _rows(1, seed=4)[0]
    seen = {}
    for pkg, mod, _, _, _ in PACKAGES:
        verdicts = []
        with _make(pkg, models, stall_factor=20.0,
                   cooldown_batches=2) as eng:
            eng.warmup(row)
            # the first heartbeat is set-up, the next 2 the warmup: 4
            # dispatches arm detection
            for _ in range(4):
                h = eng.submit(row)
                h.result(timeout=60)
                verdicts.append(_verdict(h))
            t0 = time.monotonic()
            victim = eng.submit(row)
            with pytest.raises(mod.HungDispatchError, match="wedged past"):
                victim.result(timeout=60)
            abort_s = time.monotonic() - t0
            verdicts.append(_verdict(victim))
            assert abort_s < WEDGE, f"{pkg}: the abort took {abort_s:.2f} s"
            deadline = time.monotonic() + 5
            while eng.stats()["cooldown"] == 0:
                assert time.monotonic() < deadline
                time.sleep(0.002)
            with pytest.raises(mod.Overloaded) as ei:
                eng.submit(row)
            assert ei.value.reason == "cooldown" and ei.value.retriable
            verdicts.append(_verdict(None, ei.value))
            # the batcher's next idle poll (the backlog is clear) re-admits
            while eng.stats()["cooldown"] != 0:
                assert time.monotonic() < deadline + 5
                time.sleep(0.01)
            h = eng.submit(row)
            out = h.result(timeout=60)
            verdicts.append(_verdict(h))
            stats = eng.stats()
        _identity(stats)
        seen[pkg] = (verdicts, {o: stats[o] for o in OUTCOMES}, out)
    assert seen["port"][:2] == seen["jax"][:2]
    assert seen["port"][1] == {"completed": 5, "shed": 1, "rejected": 1,
                               "quarantined": 0}
    np.testing.assert_allclose(seen["port"][2], seen["jax"][2], atol=1e-4,
                               rtol=0)
    assert isinstance(HungDispatchError("x"), ServingInfraError)


@pytest.mark.parametrize("plan", ["poisonRequestAt", "slowRequestAt"])
def test_request_chaos_matches_jax_per_index(plan, models):
    """poisonRequestAt 1 quarantines admission position 1 alone;
    slowRequestAt 1 stalls the first request 0.3 s, so the three queued
    behind it pass their 120 ms deadline and are shed at dequeue."""
    if plan == "poisonRequestAt":
        both(bigdl__chaos__poisonRequestAt="1")
        deadline = LONG
    else:
        both(bigdl__chaos__slowRequestAt="1:0.3")
        deadline = 120.0
    rows = _rows(4, seed=5)
    seen = {}
    for pkg, _, _, _, _ in PACKAGES:
        with _make(pkg, models, deadline_ms=deadline) as eng:
            eng.warmup(rows[0])
            handles = [eng.submit(r) for r in rows]
            outs = {}
            for h in handles:
                try:
                    outs[h.index] = np.asarray(h.result(timeout=60))
                except Exception:
                    pass
            stats = eng.stats()
        _identity(stats)
        seen[pkg] = ([_verdict(h) for h in handles], outs)
    assert seen["port"][0] == seen["jax"][0]
    want = ([("completed", None), ("quarantined", "ServingDataError"),
             ("completed", None), ("completed", None)]
            if plan == "poisonRequestAt" else
            [("completed", None)] + [("shed", "DeadlineExceeded")] * 3)
    assert seen["port"][0] == want
    assert seen["port"][1].keys() == seen["jax"][1].keys()
    for i, got in seen["port"][1].items():
        np.testing.assert_allclose(got, seen["jax"][1][i], atol=1e-4, rtol=0)


def test_linger_coalesces_like_jax(models):
    """lingerMs 150: three requests 20 ms apart ride one batch."""
    both(bigdl__serving__lingerMs=150.0)
    rows = _rows(3, seed=6)
    batches = {}
    for pkg, _, _, _, _ in PACKAGES:
        with _make(pkg, models) as eng:
            eng.warmup(rows[0])
            handles = []
            for r in rows:
                handles.append(eng.submit(r))
                time.sleep(0.02)
            for h in handles:
                h.result(timeout=60)
            stats = eng.stats()
        _identity(stats)
        batches[pkg] = stats["batches"]
    assert batches["port"] == batches["jax"] == 1


def test_burst_arrivals_match_jax(models):
    both(bigdl__chaos__burstArrivals="2:5")
    rows = _rows(6, seed=9)
    recs = {}
    for pkg, mod, _, _, _ in PACKAGES:
        with _make(pkg, models, max_queue_depth=64) as eng:
            eng.warmup(rows[0])
            recs[pkg] = mod.run_open_loop(eng, list(rows), rate_hz=0.0,
                                          seed=1)
        _identity(recs[pkg])
    rec = recs["port"]
    assert rec["submitted"] == recs["jax"]["submitted"] == 6 + 5
    assert rec["completed"] == 11
    assert [k for k, _ in rec["handles"]] == \
        [k for k, _ in recs["jax"]["handles"]]
    for j in range(5):
        np.testing.assert_array_equal(rec["results"][f"2+b{j}"],
                                      rec["results"]["2"])
    np.testing.assert_allclose(rec["results"]["2"],
                               recs["jax"]["results"]["2"], atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_abandon_is_first_wins_and_releases_bytes(pkg, models):
    gov = JAX_GOVERNOR if pkg == "jax" else GOVERNOR
    mod = jax_serving if pkg == "jax" else port_serving
    row = _rows(1, seed=10)[0]
    eng = _make(pkg, models, start=False)       # the handle stays queued
    h = eng.submit(row)
    acct = gov.account("serving_admission")
    charged = h.payload_nbytes
    assert charged == row.nbytes
    before = acct.nbytes
    assert not h.done() and h.error() is None
    assert h.abandon(reason="replica_crash") is True
    assert h.outcome == "shed" and h.done() and h.payload_nbytes == 0
    assert acct.nbytes == before - charged
    with pytest.raises(mod.ServingInfraError, match="abandoned"):
        h.result(timeout=0)
    assert isinstance(h.error(), mod.ServingInfraError)
    assert h.abandon() is False
    assert acct.nbytes == before - charged
    # the supervisor counts it: the engine's own identity leaves it out,
    # and the engine's later shed is a first-wins no-op
    eng.stop()
    stats = eng.stats()
    assert stats["unaccounted"] == 1 and stats["shed"] == 0
    with _make(pkg, models) as eng:            # completion wins over it
        h = eng.submit(row)
        out = h.result(timeout=60)
        assert h.abandon() is False and h.outcome == "completed"
        np.testing.assert_array_equal(out, h.result(timeout=0))
    _identity(eng.stats())


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_lifecycle_probes(pkg, models):
    eng = _make(pkg, models, start=False)
    assert eng.batcher_ident() is None and not eng.crashed()
    eng.start()
    assert not eng.terminal and not eng.draining
    assert eng.batcher_alive() and not eng.crashed()
    assert isinstance(eng.batcher_ident(), int)
    assert eng.queue_depth() == 0
    eng.stop()
    assert eng.terminal and not eng.batcher_alive()
    assert not eng.crashed()        # an orderly stop is not a crash
    _identity(eng.stats())
