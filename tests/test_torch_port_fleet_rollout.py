"""The port's blue/green rollout, checkpoint promotion through
``CheckpointManager.watch_latest`` and the combined fleet chaos plan, held
against the JAX package's (``tests/test_fleet.py``), on the CPU.

The fleets, models, keys and tolerances are ``test_torch_port_fleet.py``'s
(its docstring states them).  A rollout's verdict, its reason with numbers
and fingerprint keys masked, its version and its shadow count agree
between the packages; the fingerprints themselves are each package's own
(the two parameter trees order and lay out their leaves differently).

The hot swap under load serves one bucket (``bigdl.compile.buckets`` "4",
``maxBatch`` 4) in both packages.  The reference's test serves buckets 2,
4 and 16: a live row's bits there depend on the batch it rode in, while
the shadow replay runs it alone (ROADMAP.md, Queue 3).  Here every batch
pads to the same shape, and each port output is held bit for bit against
a plain ``ServingEngine`` serving that row in the same bucket, and within
tolerance of the JAX fleet's output for the same row.
"""

import os
import threading
import time

import numpy as np
import pytest

from bigdl_tpu_torch.fleet import Fleet
from bigdl_tpu_torch.serving import ServingEngine

from test_torch_port_fleet import (_assert_identity, _each, _fleet_env,
                                   _model, _rows, _wait, arm, both, DIN,
                                   masked, OUT_TOL, PACKAGES,
                                   port_lock_witness, PORT)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _verdict(report):
    """What of a report both packages must share."""
    return (report.promoted, report.rolled_back, masked(report.reason),
            report.from_version, report.to_version, report.parity_mode)


# ---------------------------------------------------------------------------
# zero-downtime hot swap
# ---------------------------------------------------------------------------

def test_clean_rollout_under_load_loses_zero_requests():
    """Live traffic flows while the fleet swaps versions: no request is
    lost (nothing shed, quarantined or unaccounted; everything completed
    or was rejected at the door, retriably), in both packages."""
    both(bigdl__compile__buckets="4")
    plan = {"deadline_ms": 5000.0, "max_batch": 4}

    def run(p, fleet):
        stop = threading.Event()
        errors, served = [], []

        def load():
            rng = np.random.default_rng(1)
            while not stop.is_set():
                row = rng.standard_normal((DIN,)).astype(np.float32)
                try:
                    served.append((row, fleet.submit("svc", row)))
                except p.Overloaded:
                    served.append((row, None))  # rejected: not lost
                except Exception as e:          # anything else IS a loss
                    errors.append(e)
                time.sleep(0.003)

        t = threading.Thread(target=load)
        t.start()
        try:
            _wait(lambda: fleet.stats("svc")["completed"] > 5, 10.0)
            report = fleet.rollout("svc", _model(p), parity="bitwise")
            _wait(lambda: fleet.stats("svc")["completed"] > 0, 5.0)
        finally:
            stop.set()
            t.join(timeout=10)
        assert errors == []
        assert fleet.quiesce(15.0)
        s = fleet.stats("svc")
        _assert_identity(s)
        assert s["shed"] == 0 and s["quarantined"] == 0, \
            f"requests lost during a clean rollout: {s}"
        assert s["completed"] > 0 and s["version"] == "v2"
        assert _wait(lambda: fleet.stats("svc")["last_swap_to_serve_ms"]
                     is not None, 5.0)
        assert fleet.stats("svc")["last_swap_to_serve_ms"] >= 0.0
        outs = [(row, np.asarray(h.result(timeout=0))) for row, h in served
                if h is not None and h.outcome == "completed"]
        return _verdict(report), report.parity_checked > 0, outs

    got = _each(run, engine_kw=plan)
    assert got["port"][:2] == got["jax"][:2]
    assert got["port"][0][0], got["port"][0]
    # each port output is a plain engine's output for its row in the
    # same bucket, bit for bit; and the JAX fleet's within tolerance
    port_outs = got["port"][2]
    with ServingEngine(_model(PORT), device="cpu", **plan) as plain:
        want = [plain.submit(row) for row, _ in port_outs]
        for (row, out), h in zip(port_outs, want):
            np.testing.assert_array_equal(out, h.result(timeout=10.0))
    common = min(len(port_outs), len(got["jax"][2]))
    assert common > 5
    # the load generators draw the same rows; a rejection shifts which
    # of them completed, so rows are matched by value
    jax_by_row = {row.tobytes(): out for row, out in got["jax"][2]}
    matched = [(out, jax_by_row[row.tobytes()]) for row, out in port_outs
               if row.tobytes() in jax_by_row]
    assert len(matched) > 5
    np.testing.assert_allclose([m[0] for m in matched],
                               [m[1] for m in matched], **OUT_TOL)


def test_shadow_parity_runs_on_live_traffic():
    def run(p, fleet):
        for r in _rows(10):
            fleet.submit("svc", r).result(timeout=10.0)
        assert fleet.quiesce(10.0)
        report = fleet.rollout("svc", _model(p), parity="bitwise")
        return (_verdict(report), report.parity_checked,
                report.parity_max_abs_diff)

    got = _each(run, replicas=1)
    assert got["port"] == got["jax"]
    verdict, checked, diff = got["port"]
    assert verdict[0] and checked == 8 and diff == 0.0


def test_rollout_with_no_traffic_is_vacuously_clean():
    def run(p, fleet):
        report = fleet.rollout("svc", _model(p), parity="bitwise")
        return _verdict(report), report.parity_checked, report.notes

    got = _each(run, replicas=1)
    assert got["port"] == got["jax"]
    assert got["port"][0][0] and got["port"][1] == 0
    assert any("vacuously" in n for n in got["port"][2])


def test_sequential_rollouts_bump_versions():
    def run(p, fleet):
        reports = [_verdict(fleet.rollout("svc", _model(p, seed),
                                          parity="off"))
                   for seed in (7, 8)]
        fleet.submit("svc", np.zeros((DIN,), np.float32)).result(
            timeout=10.0)
        return reports, fleet.stats("svc")["version"]

    got = _each(run, replicas=1)
    assert got["port"] == got["jax"]
    assert got["port"][1] == "v3" and all(r[0] for r in got["port"][0])


# ---------------------------------------------------------------------------
# gated blue/green: rollback paths
# ---------------------------------------------------------------------------

def test_corrupt_candidate_rolls_back_on_fingerprint():
    """``bigdl.chaos.corruptCandidateAt``: weights rot after the expected
    fingerprint; VERIFY refuses and the incumbent answers the next request
    with the same bits as before."""
    arm(bigdl__chaos__corruptCandidateAt=1)
    row = np.zeros((DIN,), np.float32)

    def run(p, fleet):
        before = np.asarray(fleet.submit("svc", row).result(timeout=10.0))
        report = fleet.rollout("svc", _model(p), parity="bitwise")
        assert report.fingerprint_observed != report.fingerprint_expected
        after = np.asarray(fleet.submit("svc", row).result(timeout=10.0))
        np.testing.assert_array_equal(after, before)
        return (_verdict(report), p.chaos._state.candidate_corruptions,
                fleet.stats("svc")["version"])

    got = _each(run, replicas=1)
    assert got["port"] == got["jax"]
    verdict, corruptions, version = got["port"]
    assert verdict[1] and "fingerprint" in verdict[2]
    assert corruptions == 1 and version == "v1"


def test_divergent_candidate_rolls_back_on_parity():
    """Bit-for-bit shadow parity: a candidate with other weights never
    survives an infra-swap rollout."""
    def run(p, fleet):
        for r in _rows(6):
            fleet.submit("svc", r).result(timeout=10.0)
        assert fleet.quiesce(10.0)
        report = fleet.rollout("svc", _model(p, seed=99), parity="bitwise")
        assert report.parity_max_abs_diff > 0.0
        fleet.submit("svc", _rows(1)[0]).result(timeout=10.0)
        return _verdict(report), fleet.stats("svc")["version"]

    got = _each(run, replicas=1)
    assert got["port"] == got["jax"]
    assert got["port"][0][1] and "parity" in got["port"][0][2]


def test_allclose_parity_admits_tiny_drift_only():
    def run(p, fleet):
        for r in _rows(6):
            fleet.submit("svc", r).result(timeout=10.0)
        assert fleet.quiesce(10.0)
        same = fleet.rollout("svc", _model(p), parity="allclose")
        other = fleet.rollout("svc", _model(p, seed=99), parity="allclose")
        return _verdict(same), _verdict(other)

    got = _each(run, replicas=1)
    assert got["port"] == got["jax"]
    same, other = got["port"]
    assert same[0] and other[1] and "parity" in other[2]


def test_unknown_parity_mode_is_an_error():
    def run(p, fleet):
        with pytest.raises(ValueError, match="parity mode"):
            fleet.rollout("svc", _model(p), parity="vibes")
        return fleet.stats("svc")["version"]

    assert _each(run, replicas=1) == {"jax": "v1", "port": "v1"}


def test_preemption_mid_rollout_aborts_to_incumbent():
    """A SIGTERM between rollout phases: the router never points at a
    half-warmed candidate."""
    def run(p, fleet):
        p.elastic.request_preemption("test: mid-rollout SIGTERM")
        report = fleet.rollout("svc", _model(p), parity="off")
        return _verdict(report), fleet.stats("svc")["version"]

    got = _each(run, replicas=1)
    assert got["port"] == got["jax"]
    assert got["port"][0][1] and "preempted" in got["port"][0][2]


# ---------------------------------------------------------------------------
# checkpoint-to-serving promotion
# ---------------------------------------------------------------------------

def _save(pkg, path, seed=7, n=1):
    mgr = pkg.Manager(str(path))
    mgr.save(_model(pkg, seed), pkg.SGD(learning_rate=0.1), n)
    return mgr


def test_new_snapshot_promotes_as_one_verified_step(tmp_path):
    both(bigdl__fleet__promotionPollSec=0.05)
    row = np.zeros((DIN,), np.float32)

    def run(p, fleet):
        d = tmp_path / p.name
        d.mkdir()
        for r in _rows(4):
            fleet.submit("svc", r).result(timeout=10.0)
        fleet.watch("svc", str(d))
        _save(p, d, seed=7, n=3)
        svc = fleet._services["svc"]
        # last_promotion, not the version: the version flips at cutover,
        # a beat before promotion_tick records the report
        assert _wait(lambda: svc.last_promotion is not None, 15.0), \
            fleet.stats("svc")
        out = np.asarray(fleet.submit("svc", row).result(timeout=10.0))
        assert fleet.quiesce(10.0)
        _assert_identity(fleet.stats("svc"))
        # the same snapshot is never promoted twice
        time.sleep(0.5)
        return (_verdict(svc.last_promotion),
                svc.last_promotion.parity_checked,
                fleet.stats("svc")["version"], out)

    got = _each(run, replicas=1)
    assert got["port"][:3] == got["jax"][:3]
    assert got["port"][0][0] and got["port"][1] == 4
    assert got["port"][2] == "v2"
    np.testing.assert_allclose(got["port"][3], got["jax"][3], **OUT_TOL)


def test_corrupt_snapshot_never_reaches_serving(tmp_path):
    """A bit flip in the payload passes the cheap watch poll but fails deep
    verification at load: promotion is refused ONCE (no retry loop) and
    the incumbent keeps serving."""
    both(bigdl__fleet__promotionPollSec=0.05)

    def run(p, fleet):
        d = tmp_path / p.name
        d.mkdir()
        fleet.watch("svc", str(d))
        _save(p, d, seed=9, n=1)
        path = d / "model.1"
        blob = bytearray(path.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        path.write_bytes(bytes(blob))
        svc = fleet._services["svc"]
        assert _wait(lambda: svc._promo_attempted == 1, 15.0)
        time.sleep(0.3)
        fleet.submit("svc", np.zeros((DIN,), np.float32)).result(
            timeout=10.0)
        return fleet.stats("svc")["version"], svc.last_promotion

    assert _each(run, replicas=1) == {"jax": ("v1", None),
                                      "port": ("v1", None)}


def test_watch_latest_answers_like_jax(tmp_path):
    """The same save / uncommit / truncate sequence gives the same answers
    and the same number of directory scans in both packages, including the
    fast path: once the directory's mtime is 2 s old, a payload truncated
    in place (the directory untouched) is not seen until it moves."""
    answers, scans = {}, {}
    for p in PACKAGES:
        d = tmp_path / p.name
        d.mkdir()
        mgr = p.Manager(str(d))
        count = [0]
        candidates = mgr.candidates

        def counted():
            count[0] += 1
            return candidates()

        mgr.candidates = counted
        seq = [mgr.watch_latest()]
        for n in (1, 2):
            mgr.save(_model(p), p.SGD(learning_rate=0.1), n)
            seq += [mgr.watch_latest(), mgr.watch_latest()]
        os.remove(d / "commit.2")                   # torn: skipped
        seq.append(mgr.watch_latest())
        mgr.save(_model(p), p.SGD(learning_rate=0.1), 3)
        with open(d / "model.3", "r+b") as f:       # size != manifest
            f.truncate(8)
        seq.append(mgr.watch_latest())
        old = time.time() - 10.0
        os.utime(d, (old, old))                     # the directory cools
        seq += [mgr.watch_latest(), mgr.watch_latest()]
        with open(d / "model.1", "r+b") as f:       # in place: dir mtime
            f.truncate(8)                           # holds still
        seq.append(mgr.watch_latest())
        os.utime(d, None)                           # it moves: rescan
        seq.append(mgr.watch_latest())
        answers[p.name], scans[p.name] = seq, count[0]
    assert answers["port"] == answers["jax"] == [
        None, 1, 1, 2, 2, 1, 1, 1, 1, 1, 1]
    assert scans["port"] == scans["jax"]


def test_degraded_memory_snapshot_is_invisible_to_watch(tmp_path):
    """A disk-full snapshot kept in host memory is not committed durable
    state: ``watch_latest`` never answers with it, in both packages."""
    got = {}
    for p in PACKAGES:
        d = tmp_path / p.name
        d.mkdir()
        mgr = _save(p, d, n=1)
        mgr._storage_degraded = True
        mgr.save(_model(p), p.SGD(learning_rate=0.1), 2)
        assert mgr._memory_snapshot is not None
        got[p.name] = mgr.watch_latest()
    assert got == {"jax": 1, "port": 1}


# ---------------------------------------------------------------------------
# the combined chaos plan, the concurrency pass and the default device
# ---------------------------------------------------------------------------

def test_kill_plus_corrupt_plus_sigterm_exact_accounting():
    """One plan arms all three fleet injectors: a replica hard-kill
    mid-traffic, a corrupted candidate during the rollout (rolled back
    while the incumbent serves), then a fleet-wide SIGTERM.  The identity
    holds exactly across all of it and every fault fired, in both."""
    arm(bigdl__chaos__killReplicaAt="8:0",
        bigdl__chaos__corruptCandidateAt=1,
        bigdl__chaos__sigtermFleetAt=60)

    def run(p, fleet):
        for r in _rows(24, seed=1):
            try:
                fleet.submit("svc", r)
            except p.Overloaded:
                pass
            time.sleep(0.005)
        assert _wait(lambda: fleet.stats("svc")["restarts"] >= 1, 10.0)
        report = fleet.rollout("svc", _model(p), parity="bitwise")
        fleet.submit("svc", _rows(1)[0]).result(timeout=10.0)
        version = fleet.stats("svc")["version"]
        rejected_late = 0
        for r in _rows(60, seed=2):
            try:
                fleet.submit("svc", r)
            except p.Overloaded:
                rejected_late += 1
            time.sleep(0.004)
        assert p.elastic.preemption_requested() and rejected_late > 0
        assert fleet.quiesce(20.0)
        s = fleet.stats("svc")
        _assert_identity(s)
        agg = fleet.stats()["fleet"]
        assert agg["unaccounted"] == 0
        assert s["completed"] > 0 and s["rejected"] > 0
        st = p.chaos._state
        return (_verdict(report), version, s["submitted"],
                (st.replica_kills, st.candidate_corruptions,
                 st.fleet_sigterms))

    got = _each(run)
    assert got["port"] == got["jax"]
    verdict, version, submitted, fired = got["port"]
    assert verdict[1] and "fingerprint" in verdict[2]
    assert version == "v1" and submitted == 85 and fired == (1, 1, 1)


def test_concurrency_pass_adds_no_finding_in_the_port_fleet():
    """The JAX package's concurrency pass over the whole port: nothing in
    ``fleet/`` (lock order, guarded state, asynchronous aborts)."""
    from bigdl_tpu.analysis.concurrency import analyze
    findings = [f for f in analyze([os.path.join(_REPO, "bigdl_tpu_torch")])
                if "fleet" in f.path.replace("\\", "/").split("/")]
    assert findings == [], "\n".join(str(f) for f in findings)


def test_fleet_defaults_to_cuda_and_refuses_without_it():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Fleet(start=False)
