"""The host-sync guard across threads, autograd and the trainers' hot loops,
the recompile sentinel and the lock witness, held against the JAX package.

Split from ``test_torch_port_analysis.py``,
whose docstring states what is held against the JAX package and with which
tolerances; the helpers and fixtures come from there.  No test file of the
port holds more than 25 tests: pytest-xdist's ``loadfile`` scheduler hands
out the largest files first (ROADMAP.md, standing rules).
"""

import logging
import operator
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import analysis as janalysis
from bigdl_tpu.analysis import (hostsync as jhostsync, retrace as jretrace,
                                lockwitness as jwitness)
from bigdl_tpu.utils import chaos as jchaos, config as jconfig
from bigdl_tpu_torch import analysis as panalysis
from bigdl_tpu_torch.analysis import (hostsync as phostsync,
                                      retrace as pretrace,
                                      lockwitness as pwitness)
from bigdl_tpu_torch.utils import chaos as pchaos, config as pconfig

from test_torch_port_analysis import (_Capture, _pair_trainers,
                                      port_lock_witness, properties)


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
