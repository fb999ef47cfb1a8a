"""The port's failure taxonomy held against the JAX package, on the CPU:
the microbatch re-plan after a device OOM, preemption with its drain and
resume, the hung-step watchdog, training-state integrity, the host-memory
governor and the chaos hooks of the training loop and the checkpoint write
path (``bigdl_tpu_torch/resources/{microbatch,governor}.py``,
``utils/{chaos,elastic}.py``, ``integrity/``, the trainers' retry loop).

- Pure functions against their JAX twins: ``snap_k``/``next_k``;
  ``scan_mean`` (rtol 1e-6, atol 1e-7: the same Kahan order over the same
  float32 chunks); the device sign stream bit-identical to JAX
  ``_host_signs``; ``fingerprint_flat``/``fingerprint_tree`` against JAX's
  under x64 (rtol 1e-12: both accumulate in float64, in other orders);
  the verdict table of ``continuity_check`` identical; ``majority_split``
  and ``WeightHealthMonitor.observe`` identical; the chaos keys' parsing
  identical.
- The governor: the same call sequence gives the same totals, the same
  edge-triggered pressure and the same shrinker calls as JAX's;
  ``check_item`` raises ``HostMemoryError``.
- The watchdog (``tests/test_elastic.py::TestWatchdog``): one fire per
  stall with a cooldown; a pause every step excluded from the EMA; the
  warmup exempt.  Poll interval 0.05 s, stalls under 1 s.
- End to end on the JAX tests' MLP (Linear 4-16, Tanh, Linear 16-2,
  LogSoftMax; SGD 0.3, momentum 0.9; one full batch an epoch), its weights
  drawn by numpy, installed in the JAX model and carried into the port's
  twin (``params_from_jax``): the OOM re-plan
  against the port's uninjected run and JAX's injected run (rtol 1e-5,
  atol 1e-7, ``tests/test_resources.py::TestMicrobatchBackoff``'s), B=1
  fatal; preemption and resume bit-exact against the port's uninterrupted
  run, the marker's name and keys the JAX package's, a real SIGTERM drained
  with the previous handler back; a stall aborted, restored and finished;
  the bitflip's ``IntegrityError.iteration`` the JAX package's, healed to
  the uninjected weights bit for bit; ``failStepAt`` and ``nanLossAt``
  with the attempt counts and ``optim/*`` incident records of the JAX run;
  the checkpoint chaos keys committing and refusing the snapshots the JAX
  manager does; the governor's injected pressure shrinking the prefetcher
  without changing a bit of the weights.

The four-rank cases (a replica desync and a minority bitflip healed in
place) run in ``tests/test_torch_port_model_parallel.py``'s spawn.  Every
test restores the config keys, chaos plans, preemption flags, governors and
generators of both packages that it touches.
"""

import contextlib
import os
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu import integrity as jintegrity
from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch
from bigdl_tpu.dataset.dataset import LocalDataSet as JLocalDataSet
from bigdl_tpu.dataset.datasets import synthetic_separable
from bigdl_tpu.integrity import fingerprint as jfp
from bigdl_tpu.resources import GOVERNOR as JGOVERNOR
from bigdl_tpu.resources import microbatch as jmicrobatch
from bigdl_tpu.telemetry import incident as jincident
from bigdl_tpu.utils import chaos as jchaos
from bigdl_tpu.utils import config as jconfig
from bigdl_tpu.utils import elastic as jelastic
from bigdl_tpu.utils.checkpoint_manager import \
    CheckpointManager as JCheckpointManager
from bigdl_tpu.utils.random_generator import \
    RandomGenerator as JRandomGenerator
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu_torch import integrity, telemetry
from bigdl_tpu_torch.dataset import (LocalDataSet, Sample, SampleToMiniBatch,
                                     ShardedDataSet)
from bigdl_tpu_torch.optim import SGD, max_epoch, max_iteration
from bigdl_tpu_torch.optim import several_iteration
from bigdl_tpu_torch.optim.optimizer import LocalOptimizer
from bigdl_tpu_torch.resources import DeviceMemoryError, HostMemoryError
from bigdl_tpu_torch.resources import microbatch
from bigdl_tpu_torch.resources.governor import GOVERNOR
from bigdl_tpu_torch.telemetry import incident
from bigdl_tpu_torch.utils import chaos, config, elastic
from bigdl_tpu_torch.utils.checkpoint_manager import CheckpointManager
from bigdl_tpu_torch.utils.convert import params_from_jax, params_to_jax
from bigdl_tpu_torch.utils.random_generator import RandomGenerator

#: weights after an injected fault against an uninjected run, and the port
#: against the JAX package (tests/test_resources.py:470)
PARITY = dict(rtol=1e-5, atol=1e-7)

_KEYS = ("bigdl.failure.retryTimeInterval", "bigdl.failure.retryTimes",
         "bigdl.incident.autoDump", "bigdl.pipeline.depth",
         "bigdl.divergence.maxBadSteps", "bigdl.integrity.everyN",
         "bigdl.elastic.handleSignals", "bigdl.resources.hostMemBudgetMB",
         "bigdl.prefetch.depth", "bigdl.watchdog.stallFactor",
         "bigdl.watchdog.warmupSteps", "bigdl.watchdog.pollInterval",
         "bigdl.chaos.oomStepAt", "bigdl.chaos.preemptAt",
         "bigdl.chaos.stallStepAt", "bigdl.chaos.bitflipParamAt",
         "bigdl.chaos.failStepAt", "bigdl.chaos.nanLossAt",
         "bigdl.chaos.failWriteAt", "bigdl.chaos.truncateWriteAt",
         "bigdl.chaos.transientWrites", "bigdl.chaos.diskFullAt",
         "bigdl.chaos.corruptStateBeforeSaveAt",
         "bigdl.chaos.hostMemPressureAt", "bigdl.chaos.poisonRequestAt")


@pytest.fixture(autouse=True)
def _env():
    """Both packages: no retry waits, no incident bundles; afterwards
    every key above cleared, chaos disarmed, the preemption flags, the
    governors and the incident rings reset."""
    for mod in (config, jconfig):
        mod.set_property("bigdl.failure.retryTimeInterval", 0.0)
        mod.set_property("bigdl.incident.autoDump", False)
    yield
    for mod in (chaos, jchaos):
        mod.uninstall()
    for mod in (elastic, jelastic):
        mod.clear_preemption()
    for gov in (GOVERNOR, JGOVERNOR):
        gov.reset()
    for mod in (config, jconfig):
        for key in _KEYS:
            mod.clear_property(key)


def both(**keys):
    """Set ``keys`` (dots as ``__``) in both packages' configs."""
    for key, value in keys.items():
        for mod in (config, jconfig):
            mod.set_property(key.replace("__", "."), value)


def arm(**keys):
    both(**keys)
    chaos.install()
    jchaos.install()


@contextlib.contextmanager
def seeded(seed):
    saved = [getattr(cls._tls, "inst", None)
             for cls in (JRandomGenerator, RandomGenerator)]
    JRandomGenerator._tls.inst = JRandomGenerator(seed)
    RandomGenerator._tls.inst = RandomGenerator(seed)
    try:
        yield
    finally:
        for cls, inst in zip((JRandomGenerator, RandomGenerator), saved):
            if inst is None:
                del cls._tls.inst
            else:
                cls._tls.inst = inst


# ---- the MLP of the JAX tests and its twin ---------------------------------

_JAX_INIT = {}


def _build(mod, **kw):
    return (mod.Sequential().add(mod.Linear(4, 16, **kw)).add(mod.Tanh())
            .add(mod.Linear(16, 2, **kw)).add(mod.LogSoftMax()))


def _jax_mlp():
    """The JAX tests' MLP, its weights drawn once by numpy (U(-a, a) of
    variance 1 / fan-in; a JAX draw compiles its random ops) and
    installed."""
    m = _build(jnn)
    if "params" not in _JAX_INIT:
        rng = np.random.default_rng(11)

        def draw(sd):
            half = np.float32(np.sqrt(3.0 / sd.shape[-2 if len(sd.shape) > 1
                                                     else -1]))
            return (rng.random(sd.shape, dtype=np.float32) * 2 - 1) * half

        _JAX_INIT["params"] = jax.tree_util.tree_map(
            draw, jax.eval_shape(m._init_params, jax.random.PRNGKey(0)))
    m._params = jax.tree_util.tree_map(jax.numpy.asarray, _JAX_INIT["params"])
    m._state = jax.tree_util.tree_map(
        lambda sd: jax.numpy.zeros(sd.shape, sd.dtype),
        jax.eval_shape(m._init_state))
    m._grads = jax.tree_util.tree_map(jax.numpy.zeros_like, m._params)
    m._adopt()
    return m


def _port_mlp():
    return params_from_jax(
        jax.tree_util.tree_map(np.asarray, _jax_mlp().params),
        _build(pnn, device="cpu"))


def _records(n=128):
    return synthetic_separable(n, 4, n_classes=2, seed=7)


def _port_samples(records):
    return [Sample(np.asarray(r.features[0]), np.asarray(r.labels[0]))
            for r in records]


def _weights(model):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        params_to_jax(model))]


def _jax_weights(model):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(model.params)]


def port_train(records, end=None, ckpt=None, sharded=True, model=None,
               counter=None):
    """The port's run on the full batch (a 1-partition ShardedDataSet,
    whose shuffles replay on resume, or a LocalDataSet)."""
    samples = _port_samples(records)
    n = len(samples)
    ds = (ShardedDataSet(samples, 1) if sharded else LocalDataSet(samples))
    model = model or _port_mlp()
    opt = LocalOptimizer(model, ds.transform(SampleToMiniBatch(n)),
                         pnn.ClassNLLCriterion(), device="cpu")
    opt.set_optim_method(SGD(0.3, momentum=0.9))
    opt.set_end_when(end or max_iteration(8))
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt), several_iteration(1))
    if counter is not None:
        _count_attempts(opt, counter)
    opt.optimize()
    return model, opt


def jax_train(records, end=None, ckpt=None, counter=None):
    model = _jax_mlp()
    ds = JLocalDataSet(records).transform(JSampleToMiniBatch(len(records)))
    opt = joptim.Optimizer.create(model, ds, jnn.ClassNLLCriterion())
    opt.set_optim_method(joptim.SGD(learning_rate=0.3, momentum=0.9))
    opt.set_end_when(end or joptim.max_iteration(8))
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt), joptim.several_iteration(1))
    if counter is not None:
        _count_attempts(opt, counter)
    opt.optimize()
    return model, opt


def _count_attempts(opt, counter):
    inner = opt._optimize

    def counted():
        counter.append(1)
        return inner()

    opt._optimize = counted


# ---- pure functions against their JAX twins --------------------------------

def test_snap_k_and_next_k_match_jax():
    for b in (1, 2, 3, 6, 7, 8, 12, 64, 100):
        for k in range(0, 14):
            assert microbatch.snap_k(b, k) == jmicrobatch.snap_k(b, k)
            assert microbatch.next_k(b, k) == jmicrobatch.next_k(b, k)


def test_scan_mean_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.normal(size=(12, 5)).astype(np.float32)
    counts = np.full((12,), 3, np.int32)

    def jfn(tree):
        a, c = tree
        return {"sq": (a * a).sum(0), "sum": a.sum(), "n": c.sum()}

    def pfn(tree):
        a, c = tree
        return {"sq": (a * a).sum(0), "sum": a.sum(),
                "n": c.sum(dtype=torch.int32)}

    for k in (2, 3, 4):
        want = jmicrobatch.scan_mean(jfn, (x, counts), k)
        got = microbatch.scan_mean(pfn, (torch.from_numpy(x),
                                         torch.from_numpy(counts)), k)
        for key in ("sq", "sum"):
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), rtol=1e-6,
                                       atol=1e-7)
        assert got["n"].dtype == torch.int32
        assert int(got["n"]) == int(want["n"])


@pytest.mark.parametrize("n,seed", [(1, 0), (17, 0x51D0), (4096, 7),
                                    (70001, 0xFFFFFFFF), (3, 2 ** 35 + 9)])
def test_device_signs_bit_identical_to_jax(n, seed):
    want = jfp._host_signs(n, seed)
    np.testing.assert_array_equal(
        integrity.fingerprint._device_signs(n, seed).numpy(), want)
    # an offset chunk of a longer stream is the same stream's slice
    tail = integrity.fingerprint._device_signs(max(n - 1, 1), seed,
                                               offset=1).numpy()
    np.testing.assert_array_equal(tail[:n - 1], want[1:])


def test_fingerprints_match_jax_under_x64(monkeypatch):
    rng = np.random.RandomState(1)
    leaves = [rng.normal(size=s).astype(np.float32)
              for s in ((5, 3), (7,), (2, 3, 4))]
    monkeypatch.setattr(integrity.fingerprint, "DEVICE_CHUNK", 8)
    with jax.enable_x64(True):
        # one program each: eager JAX compiles every small op under x64
        jflat = np.asarray(jax.jit(
            lambda v: jfp.fingerprint_flat(v, 99))(leaves[0]))
        jtree = np.asarray(jax.jit(
            lambda t: jfp.fingerprint_tree(t, 5))(leaves))
    got_flat = integrity.fingerprint_flat(torch.from_numpy(leaves[0]), 99)
    got_tree = integrity.fingerprint_tree(
        [torch.from_numpy(a) for a in leaves], 5)
    np.testing.assert_allclose(got_flat.numpy(), jflat, rtol=1e-12)
    np.testing.assert_allclose(got_tree.numpy(), jtree, rtol=1e-12)


def test_continuity_verdict_table_matches_jax():
    """First step, match, mismatch, sticky latch, first bad tick."""
    fp = np.array([3.5, -1.25])
    fp_s = np.array([0.5, 2.0])
    steps = [(fp, fp_s, True), (fp, fp_s, True), (fp + 1e-3, fp_s, True),
             (fp, fp_s, True), (fp, fp_s + 1, True), (fp, fp_s, False)]
    with jax.enable_x64(True):
        check = jax.jit(jintegrity.continuity_check)
        carry_j = jintegrity.init_carry()
        carry_p = integrity.init_carry()
        for tick, (p_in, s_in, extra) in enumerate(steps, 1):
            j = check(carry_j, p_in, s_in, np.int32(tick), np.bool_(extra))
            p = integrity.continuity_check(
                carry_p, torch.from_numpy(p_in), torch.from_numpy(s_in),
                tick, extra_ok=torch.tensor(extra))
            assert [bool(j[0]), float(j[1]), float(j[2])] == \
                [bool(p[0]), float(p[1]), float(p[2])], tick
            carry_j = jintegrity.pack_carry(j[1], j[2], p_in, s_in)
            carry_p = integrity.pack_carry(p[1], p[2],
                                           torch.from_numpy(p_in),
                                           torch.from_numpy(s_in))
            np.testing.assert_array_equal(np.asarray(carry_j),
                                          carry_p.numpy())


def test_majority_split_and_health_gates_match_jax():
    for keys in ([b"aa", b"aa", b"bb", b"aa"], [b"xx", b"yy"],
                 [b"a", b"b", b"b", b"a"], [b"q"] * 3, [b"a", b"b", b"c"]):
        assert integrity.majority_split(keys) == \
            jintegrity.majority_split(keys)
    series = [1.0] * 6 + [50.0, 50.0, float("nan"), 1.0, 2.0, 60.0]
    for factor, warmup, cooldown in ((3.0, 3, 100), (3.0, 3, 1), (0.0, 5,
                                                                   50)):
        pm = integrity.WeightHealthMonitor(factor, warmup, cooldown)
        jm = jintegrity.WeightHealthMonitor(factor, warmup, cooldown)
        assert [pm.observe("g", v, i) for i, v in enumerate(series)] == \
            [jm.observe("g", v, i) for i, v in enumerate(series)]
        assert pm.anomalies == jm.anomalies


def test_chaos_key_parsing_matches_jax():
    for value in (None, "", "3", "3:7", "12:0"):
        assert chaos._parse_span(value) == jchaos._parse_span(value)
        assert chaos._parse_indexed(value, 1) == \
            jchaos._parse_indexed(value, 1)
    for value in (None, "6", "6:1.5", "2:0.25"):
        assert chaos._parse_stall(value) == jchaos._parse_stall(value)
    for value in (None, "2", "2:checkpoints,1:compile_cache", "1: x , 3"):
        assert chaos._parse_disk_full(value) == \
            jchaos._parse_disk_full(value)


def test_unported_chaos_keys_raise():
    both(bigdl__chaos__poisonRequestAt="2")
    with pytest.raises(NotImplementedError, match="poisonRequestAt"):
        chaos.install()
    model, samples = _port_mlp(), _port_samples(_records(8))
    opt = LocalOptimizer(model, LocalDataSet(samples).transform(
        SampleToMiniBatch(8)), pnn.ClassNLLCriterion(), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        opt.optimize()
    assert opt.history == []


# ---- the governor -----------------------------------------------------------

def test_governor_matches_jax():
    both(bigdl__resources__hostMemBudgetMB=1)
    calls = {"p": [], "j": []}
    GOVERNOR.register_shrinker("t", lambda: calls["p"].append(1))
    JGOVERNOR.register_shrinker("t", lambda: calls["j"].append(1))
    got = {"p": [], "j": []}
    for gov, tag in ((GOVERNOR, "p"), (JGOVERNOR, "j")):
        ring = gov.account("t_ring")
        window = gov.account("t_window")
        for op in ((ring.add, 1 << 19), (window.add, 1 << 19),
                   (ring.add, 1 << 19), (window.sub, 1 << 30),
                   (ring.set, 0), (ring.add, 3 << 20)):
            op[0](op[1])
            got[tag].append((gov.total_bytes(), gov.free_bytes(),
                             gov.poll(), gov.under_pressure()))
        got[tag].append(dict(gov.summary_scalars()))
        with pytest.raises(Exception) as ei:
            gov.check_item("t_batch", (1 << 20) + 1)
        got[tag].append((type(ei.value).__name__, ei.value.account,
                         ei.value.nbytes, ei.value.budget_bytes))
    assert got["p"] == got["j"]
    assert calls["p"] == calls["j"] == [1, 1]
    assert isinstance(ei.value, Exception)
    with pytest.raises(HostMemoryError):
        GOVERNOR.check_item("t_batch", 2 << 20)
    # injected pressure: once per plan, at the k-th poll
    GOVERNOR.reset()
    JGOVERNOR.reset()
    both(bigdl__resources__hostMemBudgetMB=0)
    arm(bigdl__chaos__hostMemPressureAt=2)
    assert [GOVERNOR.poll() for _ in range(4)] == \
        [JGOVERNOR.poll() for _ in range(4)] == [False, True, False, False]


# ---- the watchdog (tests/test_elastic.py::TestWatchdog) ---------------------

def _beats(wd, n, dt=0.005):
    for _ in range(n):
        time.sleep(dt)
        wd.heartbeat()


def test_watchdog_fires_once_per_stall_with_cooldown():
    fires = []
    wd = elastic.HungStepWatchdog(factor=2.0, warmup=2, cooldown=2,
                                  poll_interval=0.05, abort=False,
                                  on_fire=lambda o, t: fires.append(o))
    wd.start()
    try:
        _beats(wd, 6)
        time.sleep(0.2)               # one long stall, many polls
        assert wd.fired == 1
        wd.heartbeat()                # the stall ends: cooldown starts
        time.sleep(0.15)              # a second stall inside the cooldown
        assert wd.fired == 1
        _beats(wd, 4)
        time.sleep(0.2)               # re-armed
        assert wd.fired == 2
    finally:
        wd.stop()
    assert len(fires) == 2 and wd._thread is None


def test_watchdog_pause_excluded_and_warmup_exempt():
    wd = elastic.HungStepWatchdog(factor=3.0, warmup=2, poll_interval=0.05,
                                  abort=False)
    wd.start()
    try:
        for _ in range(6):
            time.sleep(0.005)
            with wd.paused():
                time.sleep(0.03)      # the pause dwarfs the step
            time.sleep(0.005)
            wd.heartbeat()
        thr = wd.threshold_ns()
        assert thr != float("inf") and thr < 3.0 * 25e6
        time.sleep(0.2)
        assert wd.fired == 1
    finally:
        wd.stop()
    cold = elastic.HungStepWatchdog(factor=2.0, warmup=4, poll_interval=0.05,
                                    abort=False)
    cold.start()
    try:
        cold.heartbeat()
        time.sleep(0.15)
        assert cold.fired == 0 and cold.threshold_ns() == float("inf")
    finally:
        cold.stop()


# ---- end to end on the MLP ---------------------------------------------------

def test_oom_replan_matches_jax_and_the_uninjected_run(tmp_path):
    records = _records()
    with seeded(3):
        clean, _ = port_train(records, end=max_epoch(4), sharded=False)
    replans = telemetry.counter("Resources/microbatch_replans").value
    arm(bigdl__chaos__oomStepAt=2)
    with seeded(3):
        got, opt = port_train(records, end=max_epoch(4), sharded=False,
                              ckpt=tmp_path / "p")
        want, jopt = jax_train(records, end=joptim.max_epoch(4),
                               ckpt=tmp_path / "j")
    assert chaos._state.oom_fired == 1 and jchaos._state.oom_fired == 1
    assert opt._microbatch_k == jopt._microbatch_k == 2
    assert telemetry.counter("Resources/microbatch_replans").value == \
        replans + 1
    assert "Resources/oom_replan_ms" in telemetry.REGISTRY.snapshot()[
        "gauges"]
    for a, b, c in zip(_weights(got), _weights(clean), _jax_weights(want)):
        np.testing.assert_allclose(a, b, **PARITY)
        np.testing.assert_allclose(a, c, **PARITY)
    # per-sample already: no split is left, the fault is fatal
    chaos.uninstall()
    arm(bigdl__chaos__oomStepAt=1, bigdl__failure__retryTimes=2)
    with pytest.raises(DeviceMemoryError):
        port_train(_records(1), end=max_epoch(2), sharded=False)


def test_preemption_resumes_bit_exact_and_its_marker_is_jax_s(tmp_path):
    records = _records(64)
    clean, _ = port_train(records)
    arm(bigdl__chaos__preemptAt=3, bigdl__failure__retryTimes=5)
    tries = []
    with pytest.raises(elastic.Preempted, match="drained"):
        port_train(records, ckpt=tmp_path / "p", counter=tries)
    assert tries == [1] and chaos._state.preempts == 1   # never retried
    chaos.uninstall()
    marker = elastic.read_preemption_marker(str(tmp_path / "p"))
    jelastic.request_preemption("chaos preemption at iteration 3")
    jelastic.write_preemption_marker(str(tmp_path / "j"), 2)
    jmarker = jelastic.read_preemption_marker(str(tmp_path / "j"))
    assert elastic.PREEMPT_MARKER == jelastic.PREEMPT_MARKER
    assert sorted(marker) == sorted(jmarker)
    assert [marker[k] for k in ("neval", "reason")] == \
        [jmarker[k] for k in ("neval", "reason")]
    assert "commit.2" in os.listdir(tmp_path / "p")
    # resumed in this process, from the grace snapshot, to the end
    model = _port_mlp()
    samples = _port_samples(records)
    opt = LocalOptimizer(model, ShardedDataSet(samples, 1).transform(
        SampleToMiniBatch(len(samples))), pnn.ClassNLLCriterion(),
        device="cpu")
    opt.set_optim_method(SGD(0.3, momentum=0.9))
    opt.set_end_when(max_iteration(8))
    opt.set_checkpoint(str(tmp_path / "p"), several_iteration(1))
    assert opt._restore_latest_checkpoint()
    opt.optimize()
    assert elastic.read_preemption_marker(str(tmp_path / "p")) is None
    for a, b in zip(_weights(model), _weights(clean)):
        np.testing.assert_array_equal(a, b)


def test_a_real_sigterm_drains_and_puts_the_handler_back(tmp_path):
    assert threading.current_thread() is threading.main_thread()
    both(bigdl__elastic__handleSignals=True)

    class KillAt:
        reads_loss = False

        def __init__(self, at):
            self.at, self.sent = at, False

        def __call__(self, state):
            if not self.sent and state["neval"] > self.at:
                self.sent = True
                os.kill(os.getpid(), signal.SIGTERM)
            return state["neval"] > 50

    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    before = telemetry.counter("Elastic/preemptions").value
    with pytest.raises(elastic.Preempted, match="signal"):
        port_train(_records(32), end=KillAt(2), ckpt=tmp_path)
    assert {s: signal.getsignal(s) for s in prev} == prev
    assert elastic.read_preemption_marker(str(tmp_path))["neval"] == 2
    assert telemetry.counter("Elastic/preemptions").value == before + 1


def test_a_stalled_step_is_aborted_restored_and_finished(tmp_path):
    records = _records(32)
    clean, _ = port_train(records, end=max_iteration(10))
    fired = telemetry.counter("Elastic/watchdog_fired").value
    arm(bigdl__watchdog__stallFactor=5.0, bigdl__watchdog__warmupSteps=2,
        bigdl__watchdog__pollInterval=0.05, bigdl__chaos__stallStepAt="6:0.3")
    model, opt = port_train(records, end=max_iteration(10), ckpt=tmp_path)
    assert opt.optim_method.state["evalCounter"] == 10
    assert telemetry.counter("Elastic/watchdog_fired").value == fired + 1
    assert "Elastic/watchdog_detect_ms" in telemetry.REGISTRY.snapshot()[
        "gauges"]
    for a, b in zip(_weights(model), _weights(clean)):
        np.testing.assert_array_equal(a, b)


def test_bitflip_is_caught_at_jax_s_iteration_and_healed(tmp_path):
    records = _records()
    both(bigdl__integrity__everyN=1, bigdl__pipeline__depth=1)
    clean, _ = port_train(records)
    # one attempt: the IntegrityError reaches the caller, naming its onset
    arm(bigdl__chaos__bitflipParamAt=4, bigdl__failure__retryTimes=1)
    with pytest.raises(integrity.IntegrityError) as got:
        port_train(records)
    with pytest.raises(jintegrity.IntegrityError) as want:
        jax_train(records)
    assert got.value.iteration == want.value.iteration == 4
    # with a snapshot every iteration it heals by restore
    chaos.uninstall()
    fails = telemetry.counter("Integrity/continuity_failures").value
    arm(bigdl__failure__retryTimes=5)
    healed, _ = port_train(records, ckpt=tmp_path)
    assert telemetry.counter("Integrity/continuity_failures").value == \
        fails + 1
    assert "Integrity/heal_ms" in telemetry.REGISTRY.snapshot()["gauges"]
    for a, b in zip(_weights(healed), _weights(clean)):
        np.testing.assert_array_equal(a, b)


def _optim_events(mod, since):
    return [(e["kind"], (e["fields"] or {}).get("error"))
            for e in mod.events()[since:]
            if e["kind"].startswith("optim/")]


@pytest.mark.parametrize("keys", [
    {"bigdl__chaos__failStepAt": 3},
    {"bigdl__chaos__nanLossAt": "2:3", "bigdl__divergence__maxBadSteps": 2}],
    ids=["failStepAt", "nanLossAt"])
def test_step_faults_match_jax_attempts_and_incidents(tmp_path, keys):
    records = _records(32)
    both(bigdl__pipeline__depth=1)
    arm(**keys)
    runs = {}
    for name, train, mod in (("port", port_train, incident),
                             ("jax", jax_train, jincident)):
        if name == "jax":
            jchaos.install()
        tries, since = [], len(mod.events())
        error = None
        with seeded(5):
            try:
                train(records, ckpt=tmp_path / name, counter=tries,
                      **({"sharded": False} if name == "port" else {}))
            except Exception as e:  # noqa: BLE001 compared below
                error = type(e).__name__
        runs[name] = (len(tries), error, _optim_events(mod, since))
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] >= 1


@pytest.mark.parametrize("key,value", [
    ("failWriteAt", 2), ("truncateWriteAt", 2), ("transientWrites", 1),
    ("diskFullAt", "5"), ("corruptStateBeforeSaveAt", 2)])
def test_checkpoint_chaos_keys_match_jax(tmp_path, key, value):
    """Three saves under the key: which raise, which the shallow scan
    takes, and which the full load restores, as the JAX manager."""
    from bigdl_tpu.resources import storage as jstorage
    from bigdl_tpu_torch.resources import storage as pstorage
    arm(**{f"bigdl__chaos__{key}": value})
    outcome = {}
    for name, mgr, model, method, store in (
            ("port", CheckpointManager(str(tmp_path / "p")), _port_mlp(),
             SGD(0.1), pstorage),
            ("jax", JCheckpointManager(str(tmp_path / "j")), _jax_mlp(),
             joptim.SGD(learning_rate=0.1), jstorage)):
        raised = []
        for n in (1, 2, 3):
            try:
                mgr.save(model, method, n)
                raised.append(None)
            except Exception as e:  # noqa: BLE001 compared below
                raised.append(type(e).__name__)
        mgr.join(raise_errors=False)
        latest = mgr.latest_valid()
        loaded = mgr.load_latest()
        outcome[name] = (raised, latest and latest[2],
                         loaded and loaded[2])
        store.reset()
    assert outcome["port"] == outcome["jax"]


def test_host_pressure_shrinks_the_prefetcher_and_changes_no_bit():
    records = _records(32)
    both(bigdl__prefetch__depth=2)
    clean, _ = port_train(records)
    pressure = telemetry.counter("Resources/host_pressure").value
    arm(bigdl__chaos__hostMemPressureAt=3)
    got, opt = port_train(records)
    assert telemetry.counter("Resources/host_pressure").value == \
        pressure + 1
    assert opt.prefetcher.limit == (2 + 2) // 2
    assert GOVERNOR.account("prefetch_slots").nbytes == 0
    for a, b in zip(_weights(got), _weights(clean)):
        np.testing.assert_array_equal(a, b)


def test_a_batch_over_the_host_budget_is_fatal():
    """One prefetched batch larger than ``bigdl.resources.hostMemBudgetMB``
    leaves no depth to shrink: ``HostMemoryError`` reaches the caller on
    the first attempt, never retried (the JAX taxonomy's fatal class)."""
    both(bigdl__resources__hostMemBudgetMB=1e-4, bigdl__prefetch__depth=2,
         bigdl__failure__retryTimes=5)
    tries = []
    with pytest.raises(HostMemoryError) as e:
        port_train(_records(32), counter=tries)
    assert tries == [1] and e.value.account == "prefetch_slots"
    assert GOVERNOR.account("prefetch_slots").nbytes == 0
