"""The port's telemetry held against the JAX package's, on the CPU.

The same inputs (numpy seeds, fixed timestamps) go through both packages'
metrics registry, step account, span tracer, TensorBoard encoders and
event files, training loop summaries and traced serving engines.

Comparisons:
- registry: ``summary_scalars()``, ``snapshot()`` and ``prometheus_text()``
  identical after the same operations on a fresh ``MetricsRegistry``;
- step account, slow-step detector, windowed percentiles: equal outputs
  for one seeded stream of step parts;
- span tracer: the Chrome traces of the same spans from three threads are
  equal once the timestamps, the lane ids and the process name are masked;
- events: ``encode_event`` and ``histogram_summary`` byte-identical for a
  fixed ``wall_time``; each package's reader decodes the other's files;
- training: a small MLP trained 4 steps by both ``LocalOptimizer``\\ s with a
  ``TrainSummary`` writes the same tags (``Loss``, ``Throughput``,
  ``LearningRate`` and the ``Telemetry/*`` scalars; the JAX package's
  ``Analysis/*`` have no port) and ``Loss`` equal at atol 1e-6 / rtol 1e-5
  (the training tests' fp32 tolerance);
- FLOPs: a small LM step with ``flash=True`` counts what it counts without
  flash, and the analytic count of its matrix products;
- serving: ``ServingEngine`` and ``LMServingEngine`` traced over one
  completed, one quarantined and one rejected request give the JAX
  engines' span-name chains, verdicts and counter increments.

Every test starts and ends with the port's registry, tracer, trace store,
incident ring and storage flags reset, the port's config keys put back and
every summary writer closed (which joins its thread).  The JAX package's
own are reset by ``tests/conftest.py``; the tests read the JAX registry's
counters as differences, because it is shared with the other tests of the
worker.
"""

import contextlib
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu import telemetry as jtel
from bigdl_tpu.dataset import LocalDataSet as JaxLocalDataSet
from bigdl_tpu.dataset.sample import Sample as JaxSample
from bigdl_tpu.models.transformer import transformer_lm as jax_lm
from bigdl_tpu.serving import LMServingEngine as JaxLMServingEngine
from bigdl_tpu.serving import ServingEngine as JaxServingEngine
from bigdl_tpu.telemetry import incident as jincident
from bigdl_tpu.telemetry import request_trace as jrt
from bigdl_tpu.utils.random_generator import \
    RandomGenerator as JaxRandomGenerator
from bigdl_tpu.visualization import proto as jproto
from bigdl_tpu.visualization import summary as jsummary
from bigdl_tpu.visualization import FileWriter as JaxFileWriter
from bigdl_tpu.visualization import read_records as jax_read_records
import bigdl_tpu_torch.nn as pnn
import bigdl_tpu_torch.optim as poptim
from bigdl_tpu_torch import telemetry as ptel
from bigdl_tpu_torch.dataset import LocalDataSet, Sample
from bigdl_tpu_torch.models.lenet import train as lenet_train
from bigdl_tpu_torch.models.transformer import transformer_lm
from bigdl_tpu_torch.resources import StorageExhaustedError
from bigdl_tpu_torch.resources import storage as pstorage
from bigdl_tpu_torch.serving import LMServingEngine, ServingEngine
from bigdl_tpu_torch.telemetry import incident as pincident
from bigdl_tpu_torch.telemetry import request_trace as prt
from bigdl_tpu_torch.utils import config as pconfig
from bigdl_tpu_torch.utils import file_io
from bigdl_tpu_torch.utils.checkpoint_manager import CheckpointManager
from bigdl_tpu_torch.utils.convert import params_from_jax
from bigdl_tpu_torch.utils.random_generator import RandomGenerator
from bigdl_tpu_torch.visualization import (FileWriter, decode_event,
                                           read_records)
from bigdl_tpu_torch.visualization import proto as pproto
from bigdl_tpu_torch.visualization import summary as psummary

ATOL, RTOL = 1e-6, 1e-5


def _reset_port():
    ptel.disarm()
    ptel.reset_tracer()
    prt.disarm()
    prt.reset()
    pincident.reset()
    pstorage.reset()
    ptel.REGISTRY.reset()


@pytest.fixture(autouse=True)
def port_telemetry_isolated():
    """The port's telemetry state is reset around each test, and every
    port config key a test sets is put back."""
    _reset_port()
    saved = dict(pconfig._OVERRIDES)
    yield
    pconfig._OVERRIDES.clear()
    pconfig._OVERRIDES.update(saved)
    _reset_port()


@contextlib.contextmanager
def seeded(seed):
    saved = [getattr(cls._tls, "inst", None)
             for cls in (JaxRandomGenerator, RandomGenerator)]
    JaxRandomGenerator._tls.inst = JaxRandomGenerator(seed)
    RandomGenerator._tls.inst = RandomGenerator(seed)
    try:
        yield
    finally:
        for cls, inst in zip((JaxRandomGenerator, RandomGenerator), saved):
            if inst is None:
                del cls._tls.inst
            else:
                cls._tls.inst = inst


def _counters(registry, prefixes):
    return {k: v for k, v in registry.snapshot()["counters"].items()
            if k.startswith(prefixes)}


def _delta(after, before):
    out = {k: v - before.get(k, 0.0) for k, v in after.items()}
    return {k: v for k, v in out.items() if v}


# ------------------------------------------------------------- registry

def _drive_registry(mod):
    reg = mod.MetricsRegistry()
    rng = np.random.default_rng(7)
    c = reg.counter("Serving/completed", summary=True, help="done")
    for v in rng.integers(1, 5, 6):
        c.inc(float(v))
    reg.counter("Serving/shed", labels={"reason": 'exp"ired\n'}).inc(2)
    reg.counter("Serving/shed", labels={"reason": "drained"}).inc()
    g = reg.gauge("Telemetry/step_ms", summary=True)
    for v in rng.normal(10, 2, 5):
        g.set(float(v))
    reg.gauge("Ingest/queue", labels={"stage": "decode"}).inc(3.5)
    h = reg.histogram("LM/ttft_ms", summary=True, help="first token",
                      window=16)
    for i, v in enumerate(rng.lognormal(3, 1, 40)):
        h.observe(float(v), exemplar=f"lm-{i:06d}" if i % 3 else None)
    reg.histogram("Serving/latency_ms")
    reg.register_provider("ingest", lambda: [("Ingest/a/read/throughput",
                                              12.5)])
    reg.gauge("Telemetry/gone", summary=True).set(1.0)
    reg.drop_prefix("Telemetry/gone")
    return reg


def test_registry_matches_jax():
    jreg, preg = _drive_registry(jtel.metrics), _drive_registry(ptel.metrics)
    assert preg.summary_scalars() == jreg.summary_scalars()
    assert preg.snapshot() == jreg.snapshot()
    assert preg.prometheus_text() == jreg.prometheus_text()
    h = preg.histogram("LM/ttft_ms")
    assert h.tail_exemplar() == jreg.histogram("LM/ttft_ms").tail_exemplar()


# ----------------------------------------------------------- step stats

def test_step_account_and_detector_match_jax():
    rng = np.random.default_rng(11)
    parts = rng.integers(1, 4_000_000, size=(60, 4)).astype(float)
    parts[30:33] *= 8.0          # one stall: three slow steps
    walls = parts.sum(axis=1) + rng.integers(-1000, 50_000, 60)
    outs = []
    for mod in (jtel, ptel):
        mod.REGISTRY.drop_prefix("Telemetry/")
        acct = mod.StepAccount(window=32, detector=mod.SlowStepDetector(
            3.0, warmup=4, cooldown=5))
        fired = [acct.account(int(w), **dict(zip(mod.PARTS, p)))
                 for w, p in zip(walls, parts)]
        wp = mod.WindowedPercentiles(window=20)
        for w in walls:
            wp.add(w / 1e6)
        outs.append((fired, acct.summary(), acct.percentile_scalars(),
                     acct.last, acct.detector.ema, acct.detector.fired,
                     wp.percentiles(), wp.percentile(37.5),
                     sorted((k, v) for k, v in mod.summary_scalars()
                            if k.startswith("Telemetry/"))))
        mod.REGISTRY.drop_prefix("Telemetry/")
    assert outs[0] == outs[1]
    assert sum(outs[1][0]) >= 1


# --------------------------------------------------------------- tracer

def _three_thread_trace(mod):
    mod.arm(ring_size=64)
    mod.reset_tracer()

    def work(i):
        mod.name_thread(f"stage-{i}")
        with mod.span("ingest/decode", item=i):
            with mod.span("ingest/inner"):
                pass
        mod.instant("driver/slow_step", iteration=i)
        mod.add_span("prefetch/fetch", mod.clock_ns(), mod.clock_ns() + 5,
                     {"bytes": 64 * i})

    for i in range(3):      # one after another: lanes register in order
        t = threading.Thread(target=work, args=(i,))
        t.start()
        t.join()
    doc = mod.export_chrome_trace()
    mod.reset_tracer()
    return doc


def _mask(doc):
    lanes = {}
    out = []
    for ev in doc["traceEvents"]:
        ev = dict(ev)
        if ev.get("pid") == 0 and ev["tid"]:
            ev["tid"] = lanes.setdefault(ev["tid"], len(lanes) + 1)
        if ev["name"] == "thread_sort_index":
            ev["args"] = {"sort_index": ev["tid"]}
        if ev["name"] == "process_name" and ev["pid"] == 0:
            ev["args"] = {"name": "<process>"}
        for k in ("ts", "dur"):
            if k in ev:
                ev[k] = 0
        out.append(ev)
    return {**doc, "traceEvents": out}


def test_chrome_trace_matches_jax():
    jdoc = _three_thread_trace(jtel)
    jtel.arm(ring_size=4096)      # as tests/conftest.py left it
    pdoc = _three_thread_trace(ptel)
    ptel.disarm()
    assert _mask(pdoc) == _mask(jdoc)
    assert [e["args"]["name"] for e in pdoc["traceEvents"]
            if e["name"] == "thread_name"] == ["stage-0", "stage-1",
                                               "stage-2"]
    json.dumps(pdoc)


def test_disarmed_tracer_records_nothing():
    ptel.disarm()
    assert ptel.span("x") is ptel.span("y")
    with ptel.span("driver/fetch"):
        ptel.instant("i")
        ptel.add_span("a", 0, 1)
    assert ptel.events() == []


# --------------------------------------------------------------- events

def test_event_encoding_is_byte_identical():
    rng = np.random.default_rng(5)
    values = np.concatenate([rng.normal(0, 1, 200), [0.0, 1e-13, -3e5]])
    for enc in (
            lambda p, s: p.encode_event(wall_time=1234.5, step=7,
                                        summary=s.scalar_summary("Loss",
                                                                 0.25)),
            lambda p, s: p.encode_event(wall_time=1.0, step=2**40,
                                        summary=s.histogram_summary(
                                            "layer/weight", values)),
            lambda p, s: p.encode_event(wall_time=3.0,
                                        file_version="brain.Event:2"),
            lambda p, s: s.histogram_summary("empty", np.zeros(0))):
        assert enc(pproto, psummary) == enc(jproto, jsummary)


def _write_events(writer_cls, path, rng):
    w = writer_cls(str(path))
    vals = rng.normal(0, 1, 50)
    for step in range(3):
        w.add_summary(psummary.scalar_summary("Loss", 1.0 / (step + 1)),
                      step)
    w.add_summary(psummary.histogram_summary("w", vals), 3)
    w.close()
    (f,) = [p for p in os.listdir(path) if p.startswith("events.out")]
    return os.path.join(path, f)


def _decoded(reader, decoder, path):
    return [(e["step"], e["file_version"],
             [(v["tag"], v["simple_value"], v["histo"])
              for v in e["values"]])
            for e in map(decoder, reader(path))]


def test_event_files_cross_decode(tmp_path):
    rng = np.random.default_rng(9)
    pfile = _write_events(FileWriter, tmp_path / "port", rng)
    rng = np.random.default_rng(9)
    jfile = _write_events(JaxFileWriter, tmp_path / "jax", rng)
    want = _decoded(jax_read_records, jproto.decode_event, jfile)
    assert _decoded(jax_read_records, jproto.decode_event, pfile) == want
    assert _decoded(read_records, decode_event, jfile) == want
    assert want[0][1] == "brain.Event:2" and len(want) == 5


# ------------------------------------------------------------- training

def _mlp(mod, **kw):
    return (mod.Sequential().add(mod.Linear(4, 8, **kw)).add(mod.ReLU())
            .add(mod.Linear(8, 3, **kw)).add(mod.LogSoftMax()))


def test_train_summary_tags_and_loss_match_jax(tmp_path):
    jm = _mlp(jnn)
    jm.reset(jax.random.PRNGKey(3))
    init = jax.tree_util.tree_map(np.asarray, jm.params)
    pm = params_from_jax(init, _mlp(pnn, device="cpu"))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = rng.integers(1, 4, 8).astype(np.float32)
    read = {}
    with seeded(12):
        for name, model, mod, nn_mod, sample, lds, vis, kw in (
                ("jax", jm, joptim, jnn, JaxSample, JaxLocalDataSet,
                 jsummary, {}),
                ("port", pm, poptim, pnn, Sample, LocalDataSet, psummary,
                 {"device": "cpu"})):
            ds = lds([sample(x[i], y[i]) for i in range(8)])
            opt = mod.Optimizer.create(model, ds, nn_mod.ClassNLLCriterion(),
                                       batch_size=4, **kw)
            opt.set_optim_method(mod.SGD(learning_rate=0.1, momentum=0.9))
            opt.set_end_when(mod.max_iteration(4))
            ts = vis.TrainSummary(str(tmp_path / name), "mlp")
            opt.set_train_summary(ts)
            opt.optimize()
            ts.flush()
            (f,) = os.listdir(ts.log_dir)
            read[name] = [decode_event(r) for r in read_records(
                os.path.join(ts.log_dir, f))]
            ts.close()
            if name == "port":
                losses = [h["loss"] for h in opt.history]

    def tags(events):
        return {v["tag"] for e in events for v in e["values"]
                if v["tag"] in ("Loss", "Throughput", "LearningRate") or
                v["tag"].startswith("Telemetry/")}

    def loss(events):
        return [(e["step"], v["simple_value"]) for e in events
                for v in e["values"] if v["tag"] == "Loss"]

    assert tags(read["port"]) == tags(read["jax"])
    assert "Telemetry/host_pull_ms" in tags(read["port"])
    jl, pl = loss(read["jax"]), loss(read["port"])
    assert [s for s, _ in pl] == [s for s, _ in jl] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in pl], [v for _, v in jl],
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal([v for _, v in pl],
                                  np.float32(losses))


def test_flash_step_counts_the_dense_flops():
    """One training step of a tiny LM (T 128, d 128 for the flash
    kernels' tile) counted with and without flash, and by hand: every
    matrix product of the forward (2 FLOPs a multiply-add) and twice that
    backward (the gradients of both operands)."""
    B, T, D, V, L = 2, 128, 128, 16, 1
    x = torch.tensor((np.arange(B * T).reshape(B, T) % V + 1).astype(
        np.float32))
    counts = []
    for flash in (False, True):
        torch.manual_seed(0)
        lm = transformer_lm(V, d_model=D, n_head=1, n_layers=L, max_len=T,
                            flash=flash, device="cpu")
        with ptel.StepFlops() as sf:
            loss = lm(x).mean()
            torch.autograd.grad(loss, list(lm.parameters()))
        counts.append(sf.total)
    n = B * T
    fwd = L * (2 * n * D * 3 * D + 2 * n * D * D + 2 * (2 * n * D * 4 * D)
               + 4 * B * T * T * D) + 2 * n * D * V
    assert counts == [3 * fwd, 3 * fwd]


# -------------------------------------------------------------- serving

def _chains(store, ids):
    out = []
    for tid in ids:
        tr = store.get(tid)
        out.append(([s["name"] for s in tr["spans"]], tr["verdict"],
                    tr["reason"]))
    return out


def _serve_three(eng_cls, model, row, bad, kw):
    """One completed, one quarantined (``bad``), one rejected (after stop)
    request, in that admission order; returns the handles' trace ids."""
    eng = eng_cls(model, max_batch=2, deadline_ms=60000.0, start=False, **kw)
    ok = eng.submit(row)
    poison = eng.submit(bad)
    eng.start()
    ok.result(timeout=60)
    with pytest.raises(Exception):
        poison.result(timeout=60)
    eng.stop()
    with pytest.raises(Exception) as rejected:
        eng.submit(row)
    return [ok.trace_id, poison.trace_id, rejected.value.trace_id]


def test_serving_engine_traces_match_jax(tmp_path):
    jm = _mlp(jnn)
    jm.reset(jax.random.PRNGKey(3))
    pm = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                         _mlp(pnn, device="cpu"))
    row = np.arange(4, dtype=np.float32)
    bad = np.array(["poison"])
    pconfig.set_property("bigdl.incident.dir", str(tmp_path))
    prefixes = ("Serving/", "Trace/")
    jrt.arm()
    before = _counters(jtel.REGISTRY, prefixes)
    jids = _serve_three(JaxServingEngine, jm, row, bad, {})
    jdelta = _delta(_counters(jtel.REGISTRY, prefixes), before)
    prt.arm()
    pids = _serve_three(ServingEngine, pm, row, bad, {"device": "cpu"})
    pdelta = _counters(ptel.REGISTRY, prefixes)
    assert _chains(prt, pids) == _chains(jrt, jids)
    assert [c[1] for c in _chains(prt, pids)] == ["completed", "quarantined",
                                                  "rejected"]
    assert pdelta == jdelta
    assert [e["kind"] for e in pincident.events()] == [
        e["kind"] for e in jincident.events()]
    (bundle,) = pincident.dumped()
    doc = json.load(open(bundle))
    assert doc["trace"]["verdict"] == "quarantined"
    assert doc["config"]["bigdl.incident.dir"] == str(tmp_path)
    hist = ptel.REGISTRY.histogram("Serving/latency_ms")
    assert hist.count == 1 and hist.tail_exemplar() == pids[0]


def test_lm_serving_engine_traces_match_jax(tmp_path):
    shape = dict(d_model=16, n_head=2, n_layers=1, max_len=32)
    jm = jax_lm(16, **shape)
    jm.reset(jax.random.PRNGKey(3))
    pm = transformer_lm(16, device="cpu", **shape)
    params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), pm)
    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    bad = np.array([0.5, 1.5])
    kw = dict(max_context=16, block_size=4, max_new_tokens=3)
    pconfig.set_property("bigdl.incident.autoDump", False)
    prefixes = ("LM/", "Trace/")
    jrt.arm()
    before = _counters(jtel.REGISTRY, prefixes)
    jids = _serve_three(JaxLMServingEngine, jm, prompt, bad, kw)
    jdelta = _delta(_counters(jtel.REGISTRY, prefixes), before)
    prt.arm()
    pids = _serve_three(LMServingEngine, pm, prompt, bad,
                        {**kw, "device": "cpu"})
    pdelta = _counters(ptel.REGISTRY, prefixes)
    chains = _chains(prt, pids)
    assert chains == _chains(jrt, jids)
    assert chains[0][0].count("request/decode_step") == 2
    assert pdelta == jdelta and pdelta["LM/tokens"] == 3
    for name in ("LM/ttft_ms", "LM/latency_ms"):
        assert ptel.REGISTRY.histogram(name).count == 1
    assert ptel.REGISTRY.histogram("LM/itl_ms").count == 2
    assert [e["kind"] for e in pincident.events()] == [
        e["kind"] for e in jincident.events()]


# ------------------------------------------- drivers, checkpoints, exports

def test_lenet_driver_log_dir_decodes_with_jax(tmp_path):
    lg = __import__("logging").getLogger("bigdl_tpu_torch")
    saved = (list(lg.handlers), lg.level, lg.propagate)
    pconfig.set_property("bigdl.utils.LoggerFilter.logFile",
                         str(tmp_path / "bigdl.log"))
    try:
        with seeded(3):
            opt = lenet_train.main(["--synthetic", "8", "-b", "4", "-i", "2",
                                    "--device", "cpu", "--log-dir",
                                    str(tmp_path / "tb"), "--profile-dir",
                                    str(tmp_path / "prof")])
    finally:
        for h in lg.handlers:
            if h not in saved[0]:
                h.close()
        lg.handlers, lg.level, lg.propagate = saved
    opt.train_summary.close()
    opt.validation_summary.close()
    d = tmp_path / "tb" / "lenet" / "train"
    (f,) = os.listdir(d)
    events = [jproto.decode_event(r) for r in jax_read_records(str(d / f))]
    losses = [v["simple_value"] for e in events for v in e["values"]
              if v["tag"] == "Loss"]
    np.testing.assert_array_equal(
        losses, np.float32([h["loss"] for h in opt.history]))
    assert os.listdir(tmp_path / "prof") == ["torch_profile.json"]


def test_trainer_exports_and_the_account_sums(tmp_path, monkeypatch):
    """An armed run writes its Chrome trace (driver, prefetcher and
    checkpoint-writer lanes, the last snapshot's write included though it
    ends after the last step) and ``telemetry.json``; the five timed parts
    are never negative and leave the untimed rest (the hyper-parameters,
    ``step_done``) under a tenth of the run's step time."""
    import time
    write = CheckpointManager._write_snapshot_files

    def slow_write(self, *args):
        time.sleep(0.2)
        return write(self, *args)

    monkeypatch.setattr(CheckpointManager, "_write_snapshot_files",
                        slow_write)
    rng = np.random.default_rng(4)
    samples = [Sample(rng.standard_normal(4).astype(np.float32),
                      np.float32(rng.integers(1, 4)))
               for _ in range(8)]
    for key, value in (("bigdl.telemetry.trace", True),
                       ("bigdl.telemetry.tracePath",
                        str(tmp_path / "trace.json")),
                       ("bigdl.telemetry.snapshotPath", str(tmp_path)),
                       ("bigdl.telemetry.mfu", True),
                       ("bigdl.telemetry.peakTflops", 1.0)):
        pconfig.set_property(key, value)
    opt = poptim.Optimizer.create(_mlp(pnn, device="cpu"), samples,
                                  pnn.ClassNLLCriterion(), batch_size=4,
                                  device="cpu")
    opt.set_end_when(poptim.max_iteration(4))
    opt.set_checkpoint(str(tmp_path / "ck"), poptim.every_epoch(),
                       async_write=True)
    with seeded(1):
        opt.optimize()
    doc = json.load(open(tmp_path / "trace.json"))
    lanes = {e["args"]["name"] for e in doc["traceEvents"]
             if e["name"] == "thread_name"}
    assert {"driver", "prefetch-fetch", "bigdl-ckpt-writer"} <= lanes
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"driver/fetch", "driver/device_step", "driver/host_wait",
            "checkpoint/capture", "checkpoint/write",
            "prefetch/fetch"} <= names
    assert [e["args"]["neval"] for e in doc["traceEvents"]
            if e["name"] == "checkpoint/write"] == [2, 4]
    snap = json.load(open(tmp_path / "telemetry.json"))
    assert snap["step_summary"]["steps"] == 4
    assert snap["gauges"]["Telemetry/mfu"] > 0
    # the products forward, both gradients of each backward, but the
    # first layer's input gradient, which nothing needs
    fwd = 2 * 4 * (4 * 8 + 8 * 3)
    assert opt._step_flops == 3 * fwd - 2 * 4 * 4 * 8
    last = opt._step_account.last
    assert min(last[p] for p in ptel.PARTS + ("unaccounted",)) >= 0
    assert snap["step_summary"]["unaccounted_frac"] < 0.1


def test_a_run_drops_the_parallel_gauges_of_an_earlier_one(tmp_path):
    """A ``DistriOptimizer`` run's ``Parallel/overlap_buckets`` does not
    reach a later ``LocalOptimizer`` run's summary."""
    ptel.gauge("Parallel/overlap_buckets", summary=True).set(4.0)
    samples = [Sample(np.full(4, i, np.float32), np.float32(i % 3 + 1))
               for i in range(4)]
    opt = poptim.Optimizer.create(_mlp(pnn, device="cpu"), samples,
                                  pnn.ClassNLLCriterion(), batch_size=4,
                                  device="cpu")
    ts = psummary.TrainSummary(str(tmp_path), "mlp")
    opt.set_train_summary(ts).set_end_when(poptim.max_iteration(1))
    with seeded(1):
        opt.optimize()
    ts.flush()
    (f,) = os.listdir(ts.log_dir)
    tags = {v["tag"] for r in read_records(os.path.join(ts.log_dir, f))
            for v in decode_event(r)["values"]}
    ts.close()
    assert "Loss" in tags and not any(t.startswith("Parallel/")
                                      for t in tags)


def test_checkpoint_degrades_to_memory_on_a_full_disk(tmp_path,
                                                      monkeypatch):
    model = _mlp(pnn, device="cpu")
    method = poptim.SGD(0.1)
    mgr = CheckpointManager(str(tmp_path), keep_last=1)
    mgr.save(model, method, 1)
    mgr.save(model, method, 2)

    def full(path, data, overwrite=True):
        raise StorageExhaustedError(path, OSError(28, "No space left"))

    monkeypatch.setattr(file_io, "write_bytes", full)
    with torch.no_grad():
        model.layers[0].weight.add_(1.0)
    mgr.save(model, method, 3)
    counters = ptel.REGISTRY.snapshot()["counters"]
    assert counters["Resources/memory_snapshots"] == 1
    assert counters["Resources/storage_degraded{component=checkpoints}"] == 1
    monkeypatch.undo()
    payload, _, n = mgr.load_latest()
    assert n == 3
    np.testing.assert_array_equal(payload["layers.0.weight"].numpy(),
                                  model.layers[0].weight.detach().numpy())
    assert pstorage.guarded_export("telemetry", lambda: full("x", b"")) \
        is False
    assert pstorage.is_degraded("telemetry")


def test_slow_step_dumps_and_parameter_histograms(tmp_path, monkeypatch):
    """A step past ``slowStepFactor`` x the EMA opens one anomaly window:
    an instant on the timeline, ``Telemetry/slow_steps``, a one-step
    profiler window and a timeline dump under ``profileOnSlowStep``; the
    "Parameters" trigger writes one histogram per parameter.  The fifth
    step's criterion moves the loop's clock 1000 s on; the factor of 1000
    keeps a step slowed by a loaded machine from opening the window
    first."""
    import time
    offset = [0]
    monkeypatch.setattr(ptel, "clock_ns",
                        lambda: time.monotonic_ns() + offset[0])
    for key, value in (("bigdl.telemetry.trace", True),
                       ("bigdl.telemetry.slowStepFactor", 1000.0),
                       ("bigdl.telemetry.slowStepWarmup", 2),
                       ("bigdl.telemetry.profileOnSlowStep", str(tmp_path))):
        pconfig.set_property(key, value)
    rng = np.random.default_rng(4)
    samples = [Sample(rng.standard_normal(4).astype(np.float32),
                      np.float32(rng.integers(1, 4))) for _ in range(8)]
    crit = pnn.ClassNLLCriterion()
    apply, calls = crit.apply, [0]

    def slow_fifth(*args):
        calls[0] += 1
        if calls[0] == 5:
            offset[0] += 10 ** 12
        return apply(*args)

    crit.apply = slow_fifth
    opt = poptim.Optimizer.create(_mlp(pnn, device="cpu"), samples, crit,
                                  batch_size=4, device="cpu")
    opt.set_end_when(poptim.max_iteration(7))
    ts = psummary.TrainSummary(str(tmp_path), "slow")
    ts.set_summary_trigger("Parameters", poptim.several_iteration(3))
    opt.set_train_summary(ts)
    with seeded(1):
        opt.optimize()
    ts.flush()
    (f,) = os.listdir(ts.log_dir)
    events = [decode_event(r) for r in read_records(
        os.path.join(ts.log_dir, f))]
    ts.close()
    histos = sorted((e["step"], v["tag"]) for e in events
                    for v in e["values"] if v["histo"] is not None)
    # the trigger sees the advanced counter (neval 3 and 6) and the
    # histograms are stamped with the iterations done, as in the JAX loop
    assert histos == [(s, t) for s in (2, 5)
                      for t in ("layers.0/bias", "layers.0/weight",
                                "layers.2/bias", "layers.2/weight")]
    assert opt._step_account.detector.fired == 1
    assert ptel.REGISTRY.gauge("Telemetry/slow_steps").value == 1
    assert [e["args"]["iteration"] for e in ptel.events()
            if e["name"] == "driver/slow_step"] == [5]
    assert os.path.isfile(tmp_path / "slowstep_5_timeline.json")
    assert os.path.isfile(tmp_path / "slowstep_profile" /
                          "torch_profile.json")
