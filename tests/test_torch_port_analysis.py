"""The port's runtime analysis passes, ``optim/metrics.py`` and ``LBFGS``
held against the JAX package, on the CPU.

Each case builds the JAX object and its port twin with the same arguments,
the same inputs from a numpy seed, and compares them:

- the host-sync guard (``analysis/hostsync.py``): the same verdict (raise,
  count or free) for each of eight conversions in each of the three modes
  (JAX arrays on its CPU backend, CPU tensors here: an unscoped guard
  reports every tensor, as the JAX one reports every array); ``host_pull``,
  ``allow_host_sync``, thread locality; the hot loop of ``LocalOptimizer``
  under strict: clean in both, a stray ``float()`` in a fetch transformer
  raises in both, and ``Analysis/retraces`` and
  ``Analysis/implicit_host_syncs`` reach TrainSummary with equal values;
- the recompile sentinel (``analysis/retrace.py``): equal diff lines for
  the same shape and dtype drift on numpy inputs, and the same retrace
  count for an uneven last batch through ``LocalOptimizer``;
- the lock witness (``analysis/lockwitness.py``): a two-lock cycle raises
  ``LockOrderViolation`` with the same edges, consistent orders stay
  clean, and ``bigdl.chaos.lockDelayAt`` stalls the named acquisition;
- the contract checker (``analysis/contracts.py``): the same violations
  (kind and container path) from the same model and input;
- ``Metrics``: the same ``summary()`` text for the same adds, and tensors
  parked without a sync under a strict guard;
- ``LBFGS``: the quadratic with and without the line search (``x`` and
  the losses within rtol 1e-5), and the trainer path from the same
  parameters (each iteration's loss and the final parameters within rtol
  1e-4 / atol 1e-5).

``port_lock_witness`` arms the port's lock witness strict around every
test of the files that import it (the port's threaded test files): the
JAX package's witness is the conftest's, and the two never share a lock.
Every config key a test sets is put back in both packages.
"""

import contextlib
import itertools
import logging
import operator
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu import analysis as janalysis
from bigdl_tpu.analysis import contracts as jcontracts
from bigdl_tpu.analysis import hostsync as jhostsync
from bigdl_tpu.analysis import lockwitness as jwitness
from bigdl_tpu.analysis import retrace as jretrace
from bigdl_tpu.dataset import LocalDataSet as JaxLocalDataSet
from bigdl_tpu.dataset import Sample as JaxSample
from bigdl_tpu.dataset import SampleToMiniBatch as JaxSampleToMiniBatch
from bigdl_tpu.dataset.datasets import synthetic_separable
from bigdl_tpu.optim.metrics import Metrics as JaxMetrics
from bigdl_tpu.optim.optimizer import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.utils import chaos as jchaos
from bigdl_tpu.utils import config as jconfig
from bigdl_tpu.utils.random_generator import \
    RandomGenerator as JaxRandomGenerator
import bigdl_tpu_torch.nn as pnn
import bigdl_tpu_torch.optim as poptim
from bigdl_tpu_torch import analysis as panalysis
from bigdl_tpu_torch.analysis import contracts as pcontracts
from bigdl_tpu_torch.analysis import hostsync as phostsync
from bigdl_tpu_torch.analysis import lockwitness as pwitness
from bigdl_tpu_torch.analysis import retrace as pretrace
from bigdl_tpu_torch.dataset import LocalDataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optimizer import LocalOptimizer
from bigdl_tpu_torch.utils import chaos as pchaos
from bigdl_tpu_torch.utils import config as pconfig
from bigdl_tpu_torch.utils.convert import params_from_jax, params_to_jax
from bigdl_tpu_torch.utils.random_generator import RandomGenerator

#: the passes' modes
MODES = ("strict", "warn", "off")


@pytest.fixture(autouse=True)
def port_lock_witness():
    """The port's lock witness armed strict for the test: an acquisition
    that closes a cycle in the port's acquisition-order graph raises
    ``LockOrderViolation`` before it blocks.  The graph and counters are
    dropped after, so one test's order never poisons another's."""
    pwitness.arm("strict")
    try:
        yield
    finally:
        pwitness.disarm()
        pwitness.reset()


@contextlib.contextmanager
def properties(**keys):
    """Set ``bigdl.*`` keys (dots as ``__``) in both packages; put every
    one back after."""
    saved = []
    for mod in (jconfig, pconfig):
        for key, value in keys.items():
            name = key.replace("__", ".")
            saved.append((mod, name, name in mod._OVERRIDES,
                          mod._OVERRIDES.get(name)))
            mod.set_property(name, value)
    try:
        yield
    finally:
        for mod, name, had, value in reversed(saved):
            if had:
                mod.set_property(name, value)
            else:
                mod.clear_property(name)


@contextlib.contextmanager
def seeded(seed):
    """Both packages' thread-local RandomGenerator replaced by a fresh one
    seeded with ``seed``; the previous ones are put back after."""
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


def _guard(pkg, mode):
    return pkg.HostSyncGuard(mode) if mode != "off" else pkg.NULL_GUARD


# ---------------------------------------------------------------------------
# the host-sync guard
# ---------------------------------------------------------------------------

#: name -> (the JAX conversion, the port's); a JAX array has no ``numpy``
#: method, and ``np.asarray`` of one reads its buffer without the hooked
#: ``__array__``: both port conversions pair with its ``__array__()``
CONVERSIONS = {
    "__float__": (float, float),
    "__int__": (int, int),
    "__bool__": (bool, bool),
    "__index__": (operator.index, operator.index),
    "item": (lambda x: x.item(), lambda t: t.item()),
    "tolist": (lambda x: x.tolist(), lambda t: t.tolist()),
    "numpy": (lambda x: x.__array__(), lambda t: t.numpy()),
    "__array__": (lambda x: x.__array__(), lambda t: t.__array__()),
}


def _verdict(pkg, guard, convert, value):
    before = pkg.STATS.snapshot()["implicit"]
    try:
        with guard.armed():
            convert(value)
    except pkg.HostSyncError:
        return "raise"
    return "count" if pkg.STATS.snapshot()["implicit"] > before else "free"


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(CONVERSIONS))
def test_conversion_verdicts_match_jax(name, mode, caplog):
    jconv, pconv = CONVERSIONS[name]
    caplog.set_level(logging.ERROR)       # warn mode logs once per site
    got = [_verdict(jhostsync, _guard(jhostsync, mode), jconv,
                    jnp.ones((), jnp.int32)),
           _verdict(phostsync, _guard(phostsync, mode), pconv,
                    torch.ones((), dtype=torch.int32))]
    assert got[0] == got[1] == {"strict": "raise", "warn": "count",
                                "off": "free"}[mode], got


def test_strict_report_names_the_call_site_and_the_fix():
    guard = phostsync.HostSyncGuard("strict")
    with guard.armed():
        with pytest.raises(phostsync.HostSyncError) as ei:
            float(torch.ones(()) * 3)
    msg = str(ei.value)
    assert "__float__" in msg and "host_pull" in msg
    assert "test_torch_port_analysis.py:" in msg     # the offending line


def test_host_pull_allow_and_threads_match_jax():
    """host_pull is the counted choke point in both; allow_host_sync opens
    a strict region; another thread is not guarded; NULL_GUARD is free."""
    for pkg, x, y in ((jhostsync, jnp.ones((4,)), jnp.ones(())),
                      (phostsync, torch.ones(4), torch.ones(()))):
        guard = pkg.HostSyncGuard("strict")
        before = pkg.STATS.snapshot()["explicit_pulls"]
        with guard.armed():
            out = pkg.host_pull({"a": x, "b": x * 2}, what="test")
            with pkg.allow_host_sync():
                assert float(y) == 1.0
            seen = {}
            t = threading.Thread(target=lambda: seen.setdefault(
                "v", float(y)))
            t.start()
            t.join()
        assert isinstance(out["a"], np.ndarray)
        np.testing.assert_array_equal(out["b"], np.full(4, 2.0, np.float32))
        assert pkg.STATS.snapshot()["explicit_pulls"] == before + 1
        assert seen["v"] == 1.0
        with pkg.NULL_GUARD.armed():
            assert float(y) == 1.0


def test_hooks_delegate_unchanged_outside_the_region():
    """Once installed (at the first arming, never at import), the hooks
    change nothing outside an armed region: every conversion gives what
    torch's own method gives, and torch ops behave as before."""
    with phostsync.HostSyncGuard("warn").armed():
        pass
    assert phostsync._installed["done"]
    assert hasattr(torch.Tensor.item, "_bigdl_hostsync_orig")
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3) / 3
    s = t[1, 2]
    base = torch._C.TensorBase
    assert float(s) == base.__float__(s) and s.item() == base.item(s)
    assert int(s) == base.__int__(s) and bool(s) == base.__bool__(s)
    assert operator.index(torch.tensor(4)) == 4
    assert t.tolist() == base.tolist(t)
    np.testing.assert_array_equal(t.numpy(), base.numpy(t))
    np.testing.assert_array_equal(np.asarray(t), base.numpy(t))
    before = phostsync.STATS.snapshot()
    u = torch.nonzero(t > 1)
    assert u.tolist() == [[1, 1], [1, 2]]
    assert [float(v) for v in t.flatten()] == base.tolist(t.flatten())
    assert phostsync.STATS.snapshot() == before


def test_tier1_sync_warnings_are_routed_by_thread():
    """Tier 1's routing (on the card the sync debug mode warns on the
    thread that synced), fed the warning a card raises: the armed thread's
    sync is reported (strict raises), an allowed one is free, another
    thread's is counted; all are dropped while the mode is the guard's
    alone, and go on to the previous handler when the caller had set the
    mode itself.  Other warnings always go on."""
    import warnings
    sync = warnings.WarningMessage(
        UserWarning(phostsync.SYNC_MESSAGE + " (Triggered internally)"),
        UserWarning, "x.py", 1)
    other = warnings.WarningMessage(UserWarning("unrelated"), UserWarning,
                                    "x.py", 2)
    seen = []
    saved = dict(phostsync._TIER1)

    def on_another_thread():
        t = threading.Thread(target=phostsync._on_warning, args=(sync,))
        t.start()
        t.join()

    try:
        phostsync._TIER1.update(users=1, prev=0, handler=seen.append)
        before = phostsync.STATS.snapshot()
        with phostsync.HostSyncGuard("strict").armed():
            with pytest.raises(phostsync.HostSyncError,
                               match="synchronizing CUDA call"):
                phostsync._on_warning(sync)
            with phostsync.allow_host_sync():
                phostsync._on_warning(sync)
            on_another_thread()
            phostsync._on_warning(other)
        after = phostsync.STATS.snapshot()
        assert seen == [other]
        assert after["implicit"] - before["implicit"] == 1
        assert after["other_thread"] - before["other_thread"] == 1
        phostsync._TIER1["prev"] = 1
        on_another_thread()
        assert seen == [other, sync]
    finally:
        phostsync._TIER1.clear()
        phostsync._TIER1.update(saved)


@pytest.mark.parametrize("mode", ["strict", "warn"])
def test_autograd_device_thread_sync_is_charged_to_the_region(mode):
    """A sync warning on a thread the C++ runtime made (a ``_DummyThread``,
    as the autograd engine's device threads are) while a region is armed:
    counted once, and in strict raised on the arming thread as its region
    ends (a raise on that thread itself would be lost in its C++ caller)."""
    import _thread
    import warnings
    sync = warnings.WarningMessage(
        UserWarning(phostsync.SYNC_MESSAGE + " (Triggered internally)"),
        UserWarning, "x.py", 1)
    saved = dict(phostsync._TIER1)
    done = threading.Event()
    seen = {}

    def device_thread():
        seen["dummy"] = isinstance(threading.current_thread(),
                                   threading._DummyThread)
        try:
            phostsync._on_warning(sync)
        except BaseException as e:     # nothing may escape to the caller
            seen["escaped"] = e
        done.set()

    try:
        phostsync._TIER1.update(users=1, prev=0, handler=lambda m: None)
        before = phostsync.STATS.snapshot()["implicit"]
        region = phostsync.HostSyncGuard(mode).armed()
        if mode == "strict":
            with pytest.raises(phostsync.HostSyncError,
                               match="autograd device thread"):
                with region:
                    _thread.start_new_thread(device_thread, ())
                    assert done.wait(10)
        else:
            with region:
                _thread.start_new_thread(device_thread, ())
                assert done.wait(10)
        assert seen == {"dummy": True}
        assert phostsync.STATS.snapshot()["implicit"] - before == 1
        assert not phostsync._PENDING
        with phostsync.HostSyncGuard(mode).armed():   # nothing left over
            pass
    finally:
        phostsync._TIER1.clear()
        phostsync._TIER1.update(saved)


# -- the trainers' hot loop --------------------------------------------------

class _Capture:
    def __init__(self):
        self.tags = {}

    def add_scalar(self, tag, value, step):
        self.tags.setdefault(tag, []).append(value)
        return self

    def save_parameters_due(self, state):
        return False


def _mlp(mod, **kw):
    return (mod.Sequential().add(mod.Linear(4, 8, **kw)).add(mod.Tanh())
            .add(mod.Linear(8, 2, **kw)).add(mod.LogSoftMax()))


def _pair_trainers(n=16, batch=8, iters=3, seed=0, poison=None,
                   ragged=False):
    """The same MLP, data and SGD in both packages (``poison``: a stray
    pull in each fetch, as a fetch transformer would make it; ``ragged``:
    each epoch's batches as a finite pass makes them, the last one short,
    which the looped training iterator never yields by itself)."""
    rng = np.random.RandomState(seed)
    xs = rng.randn(n, 4).astype(np.float32)
    ys = (1 + np.arange(n) % 2).astype(np.float32)
    jm = _mlp(jnn)
    jm.reset(jax.random.PRNGKey(seed))
    pm = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                         _mlp(pnn, device="cpu"))
    jopt = JaxLocalOptimizer(
        jm, JaxLocalDataSet([JaxSample(x, np.array([y])) for x, y in
                             zip(xs, ys)]).transform(
            JaxSampleToMiniBatch(batch)), jnn.ClassNLLCriterion())
    popt = LocalOptimizer(
        pm, LocalDataSet([Sample(x, np.array([y])) for x, y in
                          zip(xs, ys)]).transform(SampleToMiniBatch(batch)),
        pnn.ClassNLLCriterion(), device="cpu")
    for opt, mod, pull in ((jopt, joptim, lambda: float(jnp.asarray(1.0))),
                           (popt, poptim, lambda: float(torch.ones(())))):
        opt.set_optim_method(mod.SGD(learning_rate=0.1))
        opt.set_end_when(mod.max_iteration(iters))
        if ragged:
            batcher = (JaxSampleToMiniBatch if mod is joptim
                       else SampleToMiniBatch)(batch)
            batches = list(batcher(iter(opt.dataset.records)))
            opt.dataset.data = (lambda *a, _b=batches, **kw:
                                itertools.cycle(_b))
        if poison:
            orig = opt.dataset.data

            def poisoned(*a, _orig=orig, _pull=pull, **kw):
                for batch in _orig(*a, **kw):
                    _pull()                  # a device pull in the fetch
                    yield batch

            opt.dataset.data = poisoned
    return jopt, popt


@pytest.mark.parametrize("depth", [0, 2])
def test_hot_loop_strict_clean_and_gauges_match_jax(depth):
    """Under strict a 3-step run is sync-clean in both packages, and both
    chart Analysis/retraces and this run's Analysis/implicit_host_syncs at
    zero, each step; the loss read is one explicit pull a step."""
    with properties(bigdl__analysis__hostSync="strict",
                    bigdl__analysis__retrace="strict",
                    bigdl__prefetch__depth=depth):
        jopt, popt = _pair_trainers()
        caps = []
        for opt in (jopt, popt):
            cap = _Capture()
            opt.set_train_summary(cap)
            caps.append(cap)
        jopt.optimize()
        before = phostsync.STATS.snapshot()
        popt.optimize()
        after = phostsync.STATS.snapshot()
    for tag in ("Analysis/retraces", "Analysis/implicit_host_syncs"):
        assert caps[0].tags[tag] == caps[1].tags[tag] == [0, 0, 0], tag
    assert after["implicit"] == before["implicit"]
    assert after["explicit_pulls"] - before["explicit_pulls"] == 3
    assert popt._retrace_sentinel.calls == 3
    assert len(popt._retrace_sentinel._seen) == 1


@pytest.mark.parametrize("depth", [0, 2])
def test_stray_pull_in_a_fetch_transformer_raises_in_both(depth):
    """The fetch runs on the prefetcher's fetch thread at depth 2: the
    guard is armed there too, in both packages."""
    with properties(bigdl__analysis__hostSync="strict",
                    bigdl__prefetch__depth=depth,
                    bigdl__failure__retryTimes=1):
        jopt, popt = _pair_trainers(poison=True)
        for opt, err in ((jopt, jhostsync.HostSyncError),
                         (popt, phostsync.HostSyncError)):
            with pytest.raises(err) as ei:
                opt.optimize()
            assert "__float__" in str(ei.value)
            assert "test_torch_port_analysis.py" in str(ei.value)


def test_host_sync_gauge_counts_in_warn_and_is_independent_of_retrace():
    """Warn mode counts the stray pulls (one a fetch) and charts them per
    run, equal in both; with the retrace pass off no Analysis/retraces
    gauge is written, in both."""
    with properties(bigdl__analysis__hostSync="warn",
                    bigdl__analysis__retrace="off",
                    bigdl__prefetch__depth=0):
        jopt, popt = _pair_trainers(poison=True, iters=2)
        caps = []
        for opt in (jopt, popt):
            cap = _Capture()
            opt.set_train_summary(cap)
            opt.optimize()
            caps.append(cap)
    assert "Analysis/retraces" not in caps[0].tags
    assert "Analysis/retraces" not in caps[1].tags
    assert popt._retrace_sentinel is None
    # the JAX loop writes step 1's summary after step 2's fetch (its
    # dispatch pipeline); the run's count is the same
    assert caps[1].tags["Analysis/implicit_host_syncs"] == [1, 2]
    assert caps[0].tags["Analysis/implicit_host_syncs"][-1] == 2


def test_metrics_record_the_phase_counters():
    _, popt = _pair_trainers()
    popt.optimize()
    for name in ("get batch time", "computing time for each node",
                 "batch fetch time", "transfer block time"):
        assert popt.metrics.get(name) >= 0.0, name
    assert "computing time for each node" in popt.metrics.summary()


# ---------------------------------------------------------------------------
# the recompile sentinel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drift", ["shape", "dtype", "weak", "structure"])
def test_signature_diff_lines_match_jax(drift):
    a = np.zeros((8, 4), np.float32)
    old = (a, np.ones((8,), np.float32), {"lr": 0.1, "t": 1.0})
    new = {"shape": (np.zeros((12, 4), np.float32), old[1], old[2]),
           "dtype": (a.astype(np.float16), old[1].astype(np.int32), old[2]),
           "weak": (a, old[1], {"lr": np.float32(0.1), "t": 1}),
           "structure": (a, old[1], {"lr": 0.1})}[drift]
    lines = []
    for mod in (jretrace, pretrace):
        ko, kn = mod.abstract_signature(old), mod.abstract_signature(new)
        assert ko != kn and mod.abstract_signature(old) == ko
        lines.append(mod.signature_diff(ko, kn, mod._signature_paths(old)))
    if drift == "structure":     # the tree's own repr differs by package
        lines = [[l for l in ls if not l.startswith("argument tree")]
                 for ls in lines]
    assert lines[0] == lines[1] and lines[0], lines


def test_sentinel_counts_match_jax():
    for warmup, budget in ((1, 1), (2, 2)):
        counts = []
        for mod, arr in ((jretrace, jnp.zeros), (pretrace, torch.zeros)):
            s = mod.RetraceSentinel("t", mode="warn", warmup_steps=warmup,
                                    budget=budget)
            f = s.wrap(lambda x: x)
            for n in (2, 3, 4, 2, 5):
                f(arr((n,)))
            counts.append((s.calls, s.retraces, s.compiles_in_warmup))
        assert counts[0] == counts[1], counts


def test_uneven_last_batch_counts_the_same_retraces():
    """20 records at batch 8 (8, 8, then 4, each epoch): both sentinels
    count the ragged batch's signature once in warn (call 3, past the
    2-call warmup), and strict raises the diff naming the batch shape."""
    with properties(bigdl__analysis__retrace="warn"):
        jopt, popt = _pair_trainers(n=20, iters=6, ragged=True)
        jopt.optimize()
        popt.optimize()
    assert [h["records"] for h in popt.history] == [8, 8, 4] * 2
    j, p = jopt._retrace_sentinel, popt._retrace_sentinel
    assert (j.calls, j.retraces) == (p.calls, p.retraces) == (6, 1)
    assert len(j._seen) == len(p._seen) == 2
    with properties(bigdl__analysis__retrace="strict",
                    bigdl__failure__retryTimes=1):
        for opt, err in zip(_pair_trainers(n=20, iters=6, ragged=True),
                            (jretrace.RetraceError, pretrace.RetraceError)):
            with pytest.raises(err) as ei:
                opt.optimize()
            msg = str(ei.value)
            assert "shape" in msg and "(8, 4)" in msg and "(4, 4)" in msg


# ---------------------------------------------------------------------------
# the lock witness
# ---------------------------------------------------------------------------

def test_two_lock_cycle_raises_with_the_same_edges():
    """a -> b then b -> a: the second path raises before it blocks, in
    both packages, naming the same edge and reverse edge; the graph and
    the counters agree."""
    results = []
    for mod in (jwitness, pwitness):
        prev = mod.armed()
        mod.arm("strict")
        a, b = mod.make_lock("t20.a"), mod.make_lock("t20.b")
        try:
            with a:
                with b:
                    pass
            with b:
                with pytest.raises(mod.LockOrderViolation) as ei:
                    a.acquire()
            assert not a.locked()
            graph = {k: v for k, v in mod.order_graph().items()
                     if k.startswith("t20.")}
            results.append((ei.value.edge, ei.value.reverse_edge, graph,
                            "t20.a" in str(ei.value)))
        finally:
            mod.arm(prev) if prev != "off" else mod.disarm()
    assert results[0] == results[1]
    assert results[1][:2] == (("t20.b", "t20.a"), ("t20.a", "t20.b"))


def test_consistent_orders_and_rlocks_and_conditions_stay_clean():
    for mod in (jwitness, pwitness):
        a, b = mod.make_rlock("t20.r"), mod.make_lock("t20.s")
        cv = mod.make_condition("t20.cv")
        before = mod.snapshot()["violations"]
        for _ in range(3):
            with a:
                with a:              # reentrant: no edge
                    with b:
                        pass
        with cv:
            cv.wait(0.001)           # releases and re-takes through the wrapper
            with b:
                pass
        assert mod.snapshot()["violations"] == before


def test_lock_delay_widens_the_named_acquisition():
    """``bigdl.chaos.lockDelayAt="t20.d:2:0.2"``: the second acquisition of
    the named lock stalls 0.2 s, once, in both packages."""
    with properties(bigdl__chaos__lockDelayAt="t20.d:2:0.2"):
        for mod, chaos in ((jwitness, jchaos), (pwitness, pchaos)):
            chaos.install()
            try:
                lock = mod.make_lock("t20.d")
                times = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    with lock:
                        pass
                    times.append(time.perf_counter() - t0)
                assert times[1] >= 0.2 > max(times[0], times[2]), times
                assert chaos._state.lock_delays == 1
            finally:
                chaos.uninstall()


def test_unknown_pass_mode_is_off_and_logged_once(caplog):
    with properties(bigdl__analysis__retrace="sometimes"):
        with caplog.at_level(logging.WARNING):
            modes = [janalysis.pass_mode("retrace"),
                     panalysis.pass_mode("retrace"),
                     panalysis.pass_mode("retrace")]
    assert modes == ["off"] * 3
    port = [r for r in caplog.records if r.name == "bigdl_tpu_torch"]
    assert len(port) == 1 and "sometimes" in port[0].getMessage()


def test_public_names_and_defaults_match_jax():
    # program_contracts.py (CollectiveBound, StepContract, ...) waits for a
    # census of the port's own collectives
    jax_names = set(janalysis.__all__) - {
        "CollectiveBound", "ProgramContractError",
        "ProgramContractViolation", "StepContract"}
    assert set(panalysis.__all__) == jax_names
    for key in ("retrace", "retraceWarmupSteps", "retraceBudget", "hostSync",
                "hotLoopScope", "contracts", "lockWitness"):
        name = f"bigdl.analysis.{key}"
        assert pconfig._DEFAULTS[name] == jconfig._DEFAULTS[name], name


# ---------------------------------------------------------------------------
# the contract checker
# ---------------------------------------------------------------------------

def _convnet(mod, **kw):
    return (mod.Sequential()
            .add(mod.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1, **kw))
            .add(mod.ReLU())
            .add(mod.SpatialMaxPooling(2, 2, 2, 2))
            .add(mod.View(8 * 4 * 4))
            .add(mod.Linear(8 * 16, 10, **kw)))


def _zeros(jm):
    """Install zero parameters and state of the JAX model's shapes (from
    ``jax.eval_shape``; its own init compiles a random draw per shape, and
    the walk reads shapes only)."""
    def zeros(tree):
        return jax.tree_util.tree_map(
            lambda sd: jnp.zeros(sd.shape, sd.dtype), tree)
    jm._params = zeros(jax.eval_shape(jm._init_params,
                                      jax.random.PRNGKey(0)))
    jm._state = zeros(jax.eval_shape(jm._init_state))
    jm._grads = jm._params
    if hasattr(jm, "_adopt"):
        jm._adopt()
    return jm


def _both(build):
    """(JAX model with zero parameters, port model) from
    ``build(mod, **kw)``."""
    return _zeros(build(jnn)), build(pnn, device="cpu")


def _violations(rep):
    return [(v.kind, v.module) for v in rep.violations]


def _check_both(models, x, **kw):
    jm, pm = models
    jrep = jcontracts.check_model(jm, jnp.asarray(x), mode="off", **kw)
    prep = pcontracts.check_model(pm, x, mode="off", **kw)
    assert _violations(jrep) == _violations(prep), (str(jrep), str(prep))
    assert jrep.ok == prep.ok
    return jrep, prep


def test_clean_and_abstract_inputs_check_ok():
    models = _both(_convnet)
    _, prep = _check_both(models, np.zeros((2, 3, 8, 8), np.float32))
    assert prep.ok and prep.modules_checked >= 5
    spec = pretrace.Spec((2, 3, 8, 8), np.float32)
    assert pcontracts.check_model(models[1], spec, mode="off").ok


def test_int_input_violates_the_conv_dtype_contract():
    _, prep = _check_both(_both(_convnet), np.zeros((2, 3, 8, 8), np.int32))
    assert ("dtype", "Sequential[0].SpatialConvolution") in _violations(prep)


def test_declared_ndim_violation_names_the_container_path():
    def build(mod, **kw):
        inner = mod.Sequential().add(mod.Linear(4, 4, **kw))
        if mod is pnn:
            inner.layers[0].set_contract(input_ndim=(2,), dtypes="float")
        else:
            inner[0].declare_contract(input_ndim=(2,), dtypes="float")
        return mod.Sequential().add(mod.ReLU()).add(inner)
    _, prep = _check_both(_both(build), np.zeros((2, 3, 4), np.float32))
    ndim = [v for v in prep.violations if v.kind == "ndim"]
    assert ndim and ndim[0].module == "Sequential[1].Sequential[0].Linear"
    assert "Sequential[1].Sequential[0].Linear" in str(prep)


def _jax_pin():
    class F32Pin(jnn.Module):
        layout_role = "agnostic"

        def apply(self, params, input, state, training=False, rng=None):
            return input + jnp.ones(input.shape[-1:], jnp.float32), state
    return F32Pin()


def _port_pin():
    class F32Pin(pnn.Module):
        layout_role = "agnostic"

        def forward(self, input):
            return input + torch.ones(input.shape[-1:], dtype=torch.float32,
                                      device=input.device)
    return F32Pin()


def test_promotion_drift_flagged():
    """bf16 activations through an fp32-pinning module: promotion drift in
    both."""
    jm = _zeros(jnn.Sequential().add(_jax_pin()))
    pm = pnn.Sequential().add(_port_pin())
    jrep = jcontracts.check_model(jm, jnp.zeros((2, 4), jnp.bfloat16),
                                  mode="off")
    prep = pcontracts.check_model(pm, pretrace.Spec((2, 4), torch.bfloat16),
                                  mode="off")
    assert _violations(jrep) == _violations(prep) == [
        ("promotion", "Sequential[0].F32Pin")]


def test_nchw_op_inside_nhwc_region_flagged_and_strict_raises():
    jm = _zeros(jnn.to_channels_last(_convnet(jnn)))
    pm = pnn.to_channels_last(_convnet(pnn, device="cpu"))
    x = np.zeros((2, 3, 8, 8), np.float32)
    assert _check_both((jm, pm), x)[1].ok
    jm.find_modules(jnn.SpatialConvolution)[0].format = "NCHW"
    [m for m in pm.modules()
     if isinstance(m, pnn.SpatialConvolution)][0].format = "NCHW"
    _, prep = _check_both((jm, pm), x)
    assert prep.by_kind("layout")
    with pytest.raises(pcontracts.ContractError):
        pcontracts.check_model(pm, x, mode="strict")


def test_folded_serving_model_and_moe_block_check_clean():
    def build(mod, **kw):
        return (mod.Sequential()
                .add(mod.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1, **kw))
                .add(mod.SpatialBatchNormalization(8, **kw))
                .add(mod.ReLU()).add(mod.View(8 * 8 * 8))
                .add(mod.Linear(8 * 8 * 8, 10, **kw)))
    jm, pm = _both(build)
    jm.evaluate()
    pm.evaluate()
    folded = (_zeros(jnn.to_channels_last(jnn.fold_conv_bn(jm))),
              pnn.to_channels_last(pnn.fold_conv_bn(pm)))
    _, prep = _check_both(folded, np.zeros((2, 3, 8, 8), np.float32))
    assert prep.ok

    def moe(mod, **kw):
        expert = (mod.Sequential().add(mod.Linear(8, 16, **kw))
                  .add(mod.ReLU()).add(mod.Linear(16, 8, **kw)))
        return (mod.Sequential().add(mod.Linear(8, 8, **kw))
                .add(mod.MixtureOfExperts(8, expert, n_experts=4,
                                          capacity_factor=4.0, top_k=2,
                                          **kw))
                .add(mod.Linear(8, 3, **kw)))
    _, prep = _check_both(_both(moe), np.zeros((16, 8), np.float32))
    assert prep.ok and prep.modules_checked >= 3


def test_walk_leaves_no_hook_and_runs_no_flop():
    """The hooks are removed and the modes put back (the twin of
    test_restores_apply_after_walk); the walk runs on meta tensors, so it
    neither reads nor writes the model's tensors."""
    pm = _convnet(pnn, device="cpu")
    pm.evaluate()
    before = [p.clone() for p in pm.parameters()]
    pcontracts.check_model(pm, np.zeros((2, 3, 8, 8), np.float32),
                           training=True, mode="off")
    assert all(not m._forward_hooks and not m._forward_pre_hooks
               for m in pm.modules())
    assert not any(m.training for m in pm.modules())
    assert all(torch.equal(a, b) for a, b in zip(before, pm.parameters()))
    assert pm(torch.zeros(2, 3, 8, 8)).shape == (2, 10)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def test_metrics_summary_matches_jax():
    out = []
    for cls, arr in ((JaxMetrics, jnp.asarray), (Metrics, torch.tensor)):
        m = cls()
        m.add("t", 1.0)
        m.add("t", arr(2.0))
        m.add("t", 3)
        m.add("x", arr(2e9))
        m.set("y", 4e9, parallelism=2)
        m.add("z", arr(5.0))
        m.set("z", 1.0)
        m.set("per node", [1.0, 2.0])
        out.append((m.summary(), m.get("t"), m.get("z"), m.get("per node"),
                    m.aggregated("x")))
    assert out[0] == out[1]
    assert "x: 2.0 s" in out[1][0]


def test_metrics_park_device_scalars_without_a_sync():
    """Adds inside a strict region pull nothing, and compaction past
    COMPACT_AT is an on-device sum; one pull at the read, in both."""
    for pkg, cls, arr in ((jhostsync, JaxMetrics, jnp.asarray),
                          (phostsync, Metrics, torch.tensor)):
        m = cls()
        before = pkg.STATS.snapshot()
        with pkg.HostSyncGuard("strict").armed():
            for i in range(m.COMPACT_AT * 2 + 7):
                m.add("t", arr(1.0))
            assert len(m._pending["t"]) < m.COMPACT_AT
        assert m.get("t") == m.COMPACT_AT * 2 + 7
        after = pkg.STATS.snapshot()
        assert after["implicit"] == before["implicit"]
        assert after["explicit_pulls"] == before["explicit_pulls"] + 1


# ---------------------------------------------------------------------------
# LBFGS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("line_search", [False, True])
def test_lbfgs_quadratic_matches_jax(line_search):
    """The twin of test_optim.py's test_lbfgs_converges_fast: x and every
    loss within rtol 1e-5, and the method's state keys alike."""
    x0 = np.array([0.0, 10.0, -5.0], np.float32)
    jm = joptim.LBFGS(max_iter=10, line_search=line_search)
    pm = poptim.LBFGS(max_iter=10, line_search=line_search)
    jx, jl = jm.optimize(lambda x: (jnp.sum((x - 3.0) ** 2), 2 * (x - 3.0)),
                         jnp.asarray(x0))
    px, pl = pm.optimize(lambda x: (((x - 3.0) ** 2).sum(), 2 * (x - 3.0)),
                         torch.from_numpy(x0))
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-5)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    np.testing.assert_allclose(px.numpy(), 3.0, atol=1e-4)
    assert sorted(jm.state) == sorted(pm.state)
    assert jm.state["evalCounter"] == pm.state["evalCounter"] == 1


@pytest.mark.parametrize("line_search", [False, True])
def test_lbfgs_trainer_path_matches_jax(line_search):
    """The test_dead_apis.py LBFGS trainer path from the same parameters:
    Optimizer.create -> LocalOptimizer's feval step, each iteration's loss
    and the final parameters within rtol 1e-4 / atol 1e-5; no sentinel
    and no guard on the host-driven path, in both."""
    jm = _mlp(jnn)
    with seeded(5489):
        jm.reset(jax.random.PRNGKey(5))
    pm = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                         _mlp(pnn, device="cpu"))
    records = synthetic_separable(128, 4, n_classes=2, seed=3)
    samples = [Sample(s.features[0], s.labels[0]) for s in records]
    jopt = joptim.Optimizer.create(
        jm, JaxLocalDataSet(records).transform(JaxSampleToMiniBatch(128)),
        jnn.ClassNLLCriterion())
    popt = poptim.Optimizer.create(pm, samples, pnn.ClassNLLCriterion(),
                                   batch_size=128, device="cpu")
    caps = []
    for opt, mod in ((jopt, joptim), (popt, poptim)):
        opt.set_optim_method(mod.LBFGS(max_iter=8, line_search=line_search))
        opt.set_end_when(mod.max_iteration(4))
        cap = _Capture()
        opt.set_train_summary(cap)
        opt.optimize()
        caps.append(cap)
    assert isinstance(popt, LocalOptimizer)
    np.testing.assert_allclose(caps[1].tags["Loss"], caps[0].tags["Loss"],
                               rtol=1e-4, atol=1e-5)
    assert [h["loss"] for h in popt.history] == caps[1].tags["Loss"]
    for o, r in zip(jax.tree_util.tree_leaves(params_to_jax(pm)),
                    jax.tree_util.tree_leaves(jm.params)):
        np.testing.assert_allclose(np.asarray(o), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)
    assert (jopt.optim_method.state["evalCounter"] ==
            popt.optim_method.state["evalCounter"])
    assert popt._retrace_sentinel is None and popt._hostsync_base is None
    assert "Analysis/retraces" not in caps[1].tags


def test_lbfgs_refuses_bf16_and_the_sharded_trainers():
    """set_precision with a feval method raises the JAX text; the
    DistriOptimizer refuses LBFGS at its first step, as the JAX one's step
    does (its pure_update raises)."""
    pm = _mlp(pnn, device="cpu")
    samples = [Sample(np.ones(4, np.float32), np.array([1.0]))] * 8
    opt = poptim.Optimizer.create(pm, samples, pnn.ClassNLLCriterion(),
                                  batch_size=8, device="cpu")
    opt.set_optim_method(poptim.LBFGS()).set_precision("bf16")
    opt.set_end_when(poptim.max_iteration(1))
    with pytest.raises(ValueError, match="fp32-only; unset set_precision"):
        opt.optimize()
    with pytest.raises(NotImplementedError, match="use optimize"):
        poptim.LBFGS().pure_update([], [], {}, {})
    with pytest.raises(NotImplementedError, match="use optimize"):
        joptim.LBFGS().pure_update([], [], {}, {})
