"""The ingest engine's stage supervisor (restarts, stall detection, the
synchronous fallback) and its decode-pool autoscaler, held against the JAX
package on the CPU (the twins of ``tests/test_ingest_faults.py``'s
supervised-stage, stall and fallback cases and of
``tests/test_ingest_autoscale.py``).

Records, batches, crops and chaos plans as in
``test_torch_port_ingest_faults.py``, whose helpers these tests use: each
engine run under a plan is compared bit for bit with the JAX engine's run
under the same plan and with the port's synchronous path.
``AutoscalePolicy`` is held against the JAX policy decision by decision
over fixed and random signal traces.  Stall tests wedge the upstream for a
bounded time (a few seconds), never for good, so that every close joins
its threads; each has a stall timeout of 0.5 s.
"""

import threading
import time

import numpy as np
import pytest

from bigdl_tpu.dataset import ingest as jingest
from bigdl_tpu.dataset import image as jimage
from bigdl_tpu.utils import config as jconfig
from bigdl_tpu_torch.dataset import image, ingest
from bigdl_tpu_torch.utils import config, elastic
from test_torch_port_analysis import port_lock_witness  # noqa: F401
from test_torch_port_ingest import _live, _threads_before, seeded  # noqa: F401
from test_torch_port_ingest_faults import (_fast_retries, assert_stream_equal,  # noqa: F401
                                           batches, both_match, engine_run,
                                           plan, png_entries, sync_batches)

CROP = (32, 32)

_AUTOSCALE_KEYS = ("bigdl.ingest.autoscale.enabled",
                   "bigdl.ingest.autoscale.min",
                   "bigdl.ingest.autoscale.max",
                   "bigdl.ingest.autoscale.intervalSec",
                   "bigdl.ingest.autoscale.upStarveFrac",
                   "bigdl.ingest.autoscale.downStarveFrac",
                   "bigdl.ingest.autoscale.patience",
                   "bigdl.ingest.autoscale.cooldown")


@pytest.fixture(autouse=True)
def _autoscale_keys_put_back():
    yield
    for mod in (jconfig, config):
        for k in _AUTOSCALE_KEYS:
            mod.clear_property(k)


def _set_both(**keys):
    for mod in (jconfig, config):
        for k, v in keys.items():
            mod.set_property(k.replace("__", "."), v)


# ------------------------------------------------------- supervised stages

@pytest.mark.parametrize("kill", ["reader:4", "assembler:6", "decode:5"])
def test_killed_stage_restarts_to_bit_parity(kill):
    """A stage that dies silently (a decode worker's record is resubmitted)
    is restarted once; the stream equals the JAX engine's under the same
    plan and the synchronous path's: the clone-and-commit contract
    survives the restart."""
    e = png_entries()
    jeng, peng = both_match(e, e, {"killStageThread": kill})
    assert peng.supervisor.restarts == jeng.supervisor.restarts == 1
    assert peng.fault_stats()["stage_restarts"] == 1
    assert peng.run_history[-1]["stage_restarts"] == 1


def test_restart_budget_exhausted_escalates_with_diagnosis():
    with pytest.raises(ingest.IngestInfraError, match="assembler") as err:
        engine_run("port", png_entries(), {"killStageThread": "assembler:6"},
                   max_stage_restarts=0)
    assert set(err.value.diagnosis) >= {"read", "decode", "assemble"}
    assert "maxStageRestarts=0" in str(err.value)


def test_orderly_completion_never_restarts():
    got, eng = engine_run("port", png_entries(8))
    assert sum(len(y) for _, y in got) == 8
    assert eng.supervisor.restarts == 0 and eng.supervisor.failure is None


def test_teardown_joins_supervisor_and_stage_threads(_threads_before):
    recs = [image.LabeledImageBytes(*x) for x in png_entries(8)]

    def infinite():
        while True:
            yield from recs

    eng = ingest.StreamingIngest(4, crop=CROP, decode_workers=2)
    it = eng(infinite())
    next(it)
    names = {t.name for t in _live(_threads_before, "ingest-")}
    assert {"ingest-supervisor", "ingest-reader",
            "ingest-assembler"} <= names
    it.close()
    assert not _live(_threads_before, "ingest-")


# ------------------------------------------------------ stall and fallback

def _wedged(recs, seconds):
    """Two records, then an upstream read that hangs ``seconds``."""
    yield from recs[:2]
    threading.Event().wait(seconds)


def test_wedged_ring_detected_with_stage_diagnosis(_threads_before):
    """A hung upstream and a waiting consumer: the engine is declared dead
    within the stall window, with every stage's stats, in both packages;
    the port's close then joins the reader when the read returns."""
    for mod, cls in ((jingest, jimage.LabeledImageBytes),
                     (ingest, image.LabeledImageBytes)):
        recs = [cls(*x) for x in png_entries(4)]
        eng = mod.StreamingIngest(4, crop=CROP, decode_workers=2,
                                  stall_timeout=0.5)
        t0 = time.monotonic()
        with pytest.raises(mod.IngestStallError,
                           match="stallTimeoutSec") as err:
            list(eng(_wedged(recs, 1.5)))
        assert time.monotonic() - t0 < 10
        assert "read" in err.value.diagnosis
    assert not _live(_threads_before, "ingest-")


@pytest.mark.parametrize("kill", ["assembler:6", "reader:4"])
def test_fallback_finishes_epoch_on_sync_path_bit_identically(kill):
    e = png_entries()
    jeng, peng = both_match(e, e, {"killStageThread": kill},
                            max_stage_restarts=0, fallback_on_failure=True)
    assert peng.fallbacks == jeng.fallbacks == 1
    assert peng.fault_stats()["fallbacks"] == 1


def test_fallback_quarantines_bad_records_in_tail():
    e = png_entries()
    jeng, peng = both_match(e, e[:9] + e[10:],
                            {"killStageThread": "assembler:2",
                             "corruptRecordAt": "9"},
                            max_stage_restarts=0, fallback_on_failure=True,
                            max_bad_records=2)
    assert peng.fallbacks == 1 and peng.quarantine.count == 1
    assert jeng.quarantine.count == 1


def test_watchdog_stall_diagnostics_include_live_engines():
    recs = [image.LabeledImageBytes(*x) for x in png_entries(8)]
    eng = ingest.StreamingIngest(4, crop=CROP, decode_workers=2)
    it = eng(iter(recs))
    next(it)
    try:
        diag = elastic.stall_diagnostics()
        entry = diag["ingest"][eng.name]
        assert "read" in entry["stats"]
        assert set(entry["faults"]["ring_ages_s"]) == {"record_ring",
                                                       "batch_ring"}
    finally:
        it.close()
    assert eng.name not in elastic.stall_diagnostics()["ingest"]


# ---------------------------------------------------------- the policy

def _policies(**kw):
    args = (kw.pop("min_workers", 1), kw.pop("max_workers", 8),
            kw.pop("up", 0.2), kw.pop("down", 0.02), kw.pop("patience", 2),
            kw.pop("cooldown", 3))
    assert not kw
    return ingest.AutoscalePolicy(*args), jingest.AutoscalePolicy(*args)


def _run(trace, start=2, **kw):
    """Both policies over ``trace``; they must agree step by step."""
    pp, jp = _policies(**kw)
    workers, out = start, []
    for starve, bp, pressure in trace:
        d = pp.decide(starve, bp, workers, pressure)
        assert d == jp.decide(starve, bp, workers, pressure)
        workers += d
        out.append(d)
    return out, workers


def test_fixed_starve_trace_is_deterministic():
    trace = [(0.5, 0.0, False)] * 8
    assert _run(trace) == _run(trace)
    assert _run(trace)[0] == [0, 1, 0, 0, 0, 0, 1, 0]


def test_ceiling_floor_and_pressure_are_hard():
    acts, workers = _run([(0.9, 0.0, False)] * 20, max_workers=3,
                         patience=1, cooldown=0)
    assert workers == 3 and all(a >= 0 for a in acts)
    acts, workers = _run([(0.0, 0.0, False)] * 20, start=1, patience=1,
                         cooldown=0)
    assert workers == 1 and acts == [0] * 20
    acts, workers = _run([(0.9, 0.0, True)] * 6, start=4, patience=1,
                         cooldown=0)
    assert workers < 4 and all(a <= 0 for a in acts)
    acts, _ = _run([(0.5, 0.9, False)] * 4, start=4, patience=1, cooldown=0)
    assert acts[0] == -1


def test_policy_matches_jax_over_random_traces():
    rng = np.random.RandomState(0)
    for case in range(20):
        trace = [(float(rng.choice([0.0, 0.01, 0.1, 0.3, 0.9])),
                  float(rng.choice([0.0, 0.1, 0.5])),
                  bool(rng.rand() < 0.1)) for _ in range(40)]
        _run(trace, start=int(rng.randint(1, 6)),
             min_workers=int(rng.randint(1, 3)),
             max_workers=int(rng.randint(3, 9)),
             patience=int(rng.randint(1, 4)),
             cooldown=int(rng.randint(0, 4)))


# ------------------------------------------------------- the decode pool

def test_decode_pool_resizes_both_ways_and_propagates_errors(
        _threads_before):
    pool = ingest._DecodePool(2, thread_name_prefix="ingest-decode")
    try:
        assert pool.workers == 2
        assert pool.set_workers(4) == 4 and len(pool.threads) == 4
        assert [f.result(5) for f in
                [pool.submit(lambda v: v * v, i) for i in range(8)]] == \
            [i * i for i in range(8)]
        assert pool.set_workers(1) == 1
        with pytest.raises(ZeroDivisionError):
            pool.submit(lambda: 1 / 0).result(5)
        deadline = time.monotonic() + 5
        while (sum(t.is_alive() for t in pool.threads) > 1 and
               time.monotonic() < deadline):
            time.sleep(0.02)
        assert sum(t.is_alive() for t in pool.threads) == 1
    finally:
        pool.shutdown(cancel_futures=True)
        ingest.join_threads(pool.threads, "test pool")
    assert not _live(_threads_before, "ingest-decode")


# ------------------------------------------------- the autoscaler, end to end

def test_worker_gauges_surface_in_summary():
    recs = [image.LabeledImageBytes(*x) for x in png_entries(8)]
    eng = ingest.StreamingIngest(4, crop=CROP, decode_workers=2)
    it = eng(iter(recs))
    next(it)
    scalars = dict(ingest.summary_scalars())
    it.close()
    assert scalars[f"Ingest/{eng.name}/decode/workers"] == 2
    assert scalars[f"Ingest/{eng.name}/assemble/workers"] >= 1


def test_starved_decode_stage_scales_up_with_the_same_batches():
    """``starveStageAt`` throttles the decode stage; the assembler starves
    and the autoscaler adds decode workers, while the batches stay those
    of the JAX engine under the same plan and of the synchronous path."""
    _set_both(bigdl__ingest__autoscale__intervalSec=0.05,
              bigdl__ingest__autoscale__upStarveFrac=0.05,
              bigdl__ingest__autoscale__patience=1,
              bigdl__ingest__autoscale__cooldown=0,
              bigdl__ingest__autoscale__max=4)
    e = png_entries(48)
    jeng, peng = both_match(e, e, {"starveStageAt": "decode:1:10"},
                            decode_workers=1)
    assert peng.autoscale_events["up"] >= 1
    assert peng.stage_workers["decode"] >= 2
    assert peng.stage_workers["assemble"] == peng.stage_workers["decode"]
    assert jeng.autoscale_events["up"] >= 1


def test_autoscale_disabled_holds_worker_count():
    config.set_property("bigdl.ingest.autoscale.enabled", False)
    got, eng = engine_run("port", png_entries(16),
                          {"starveStageAt": "decode:1:10"},
                          decode_workers=1)
    assert sum(len(y) for _, y in got) == 16
    assert eng.autoscale_events == {"up": 0, "down": 0}
    assert eng.stage_workers["decode"] == 1


def test_defaults_are_the_reference_defaults():
    """The autoscaler on and two restarts: the JAX package's defaults."""
    for key in ("bigdl.ingest.autoscale.enabled",
                "bigdl.ingest.maxStageRestarts",
                "bigdl.ingest.fallbackOnFailure",
                "bigdl.ingest.stallTimeoutSec",
                "bigdl.ingest.zeroCopyUpload",
                "bigdl.ingest.epochCache",
                "bigdl.ingest.epochCacheSegmentRecords") + _AUTOSCALE_KEYS:
        assert config.get_property(key) == jconfig.get_property(key), key
    eng = ingest.StreamingIngest(4)
    jeng = jingest.StreamingIngest(4)
    for attr in ("autoscale", "max_stage_restarts", "fallback_on_failure",
                 "stall_timeout"):
        assert getattr(eng, attr) == getattr(jeng, attr), attr
