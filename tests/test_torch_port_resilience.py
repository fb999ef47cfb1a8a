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
import re
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
from test_torch_port_analysis import port_lock_witness  # noqa: F401

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
         "bigdl.chaos.hostMemPressureAt", "bigdl.chaos.hangCompileAt")


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
    for value in (None, "", "0", "2", "2:5", 3):
        assert chaos._parse_burst(value) == jchaos._parse_burst(value)
    for value in (None, "2", "2:checkpoints,1:compile_cache", "1: x , 3"):
        assert chaos._parse_disk_full(value) == \
            jchaos._parse_disk_full(value)


def test_unported_chaos_keys_raise():
    # a compile injector: the serving and fleet ones are ported
    both(bigdl__chaos__hangCompileAt="2")
    with pytest.raises(NotImplementedError, match="hangCompileAt"):
        chaos.install()
    model, samples = _port_mlp(), _port_samples(_records(8))
    opt = LocalOptimizer(model, LocalDataSet(samples).transform(
        SampleToMiniBatch(8)), pnn.ClassNLLCriterion(), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        opt.optimize()
    assert opt.history == []


#: each JAX key of a part the port lacks: a value that asks for the part,
#: and one that asks for nothing; ``zeroCopyUpload`` is honoured now, so
#: no value of it is refused (asks None)
UNHONOURED = [("bigdl.compile.cacheDir", "compile-cache", ""),
              ("bigdl.compile.timeoutSec", 30, 0),
              ("bigdl.compile.keepLast", 4, 0),
              ("bigdl.compile.lockTimeoutSec", 30.0, 0),
              ("bigdl.compile.lockStaleSec", 600.0, 0),
              ("bigdl.audit.collectives", "strict", "warn"),
              ("bigdl.audit.precision", "strict", "off"),
              ("bigdl.audit.memory", "strict", "warn"),
              ("bigdl.ingest.zeroCopyUpload", None, True),
              ("bigdl.resources.deviceMemBudgetMB", 1, 0)]


@pytest.mark.parametrize("key,asks,benign", UNHONOURED,
                         ids=[k for k, _, _ in UNHONOURED])
def test_unhonoured_keys_are_refused_where_each_path_starts(key, asks,
                                                            benign):
    """The trainers, both serving engines and ``StreamingIngest`` refuse a
    value that asks for what the port lacks, naming the key, before any
    work; a value that asks for nothing passes (for an honoured key, every
    value: ``StreamingIngest`` builds under it)."""
    from bigdl_tpu_torch.dataset.ingest import StreamingIngest
    from bigdl_tpu_torch.serving import LMServingEngine, ServingEngine
    model, samples = _port_mlp(), _port_samples(_records(8))
    opt = LocalOptimizer(model, LocalDataSet(samples).transform(
        SampleToMiniBatch(8)), pnn.ClassNLLCriterion(), device="cpu")
    starts = (opt.optimize,
              lambda: ServingEngine(model, start=False, device="cpu"),
              lambda: LMServingEngine(model, device="cpu"),
              lambda: StreamingIngest(8))
    try:
        if asks is not None:
            config.set_property(key, asks)
            for start in starts:
                with pytest.raises(NotImplementedError,
                                   match=re.escape(key)):
                    start()
            assert opt.history == []
        config.set_property(key, benign)
        chaos.refuse_unported_keys()
        if asks is None:
            StreamingIngest(8)
    finally:
        config.clear_property(key)


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

def _optim_events(mod, since):
    return [(e["kind"], (e["fields"] or {}).get("error"))
            for e in mod.events()[since:]
            if e["kind"].startswith("optim/")]
