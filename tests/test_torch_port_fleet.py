"""The port's fleet control plane (``bigdl_tpu_torch/fleet``) held against
the JAX package's (``tests/test_fleet.py``, whose cases these twin), on the
CPU.

Each test builds the JAX fleet and its port twin (``device="cpu"``) over
the reference file's model, Linear(4, 16), Tanh, Linear(16, 3): the JAX
weights drawn by ``reset(PRNGKey(seed))`` and carried into the port with
``params_from_jax``.  The same scenario runs through both, each package's
config, chaos plan and preemption flag set and cleared together.  Held:

- per-request outputs: the port's within rtol 1e-5, atol 1e-6 of the JAX
  fleet's for the same rows (float32 in two libraries' summation orders);
- the accounting counts where the scenario fixes them, the identity
  (completed + shed + rejected + quarantined == submitted, nothing
  unaccounted) in every scenario, the rollout reports' verdicts and their
  reasons with numbers and fingerprints masked, and the chaos counters.
  Where a kill or a drain races live traffic, how many requests it sheds
  or rejects depends on timing in both packages, and only the identity and
  the fired faults are compared;
- :class:`FleetAutoscalePolicy`'s decisions step by step on the reference's
  signal sequences;
- the ``bigdl.fleet.*`` defaults against the JAX table, and the JAX
  package's ``unsupervised-thread-in-fleet`` lint rule over the port's
  fleet.

Rollouts, promotion and the combined chaos plan are in
``test_torch_port_fleet_rollout.py``.  Every fleet is stopped, which joins
the supervisor's threads and every replica's batcher.
"""

import os
import re
import shutil
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.analysis.lint import lint_paths
from bigdl_tpu.fleet import Fleet as JFleet
from bigdl_tpu.fleet import FleetAutoscalePolicy as JPolicy
from bigdl_tpu.serving.engine import Overloaded as JOverloaded
from bigdl_tpu.utils import chaos as jchaos
from bigdl_tpu.utils import config as jconfig
from bigdl_tpu.utils import elastic as jelastic
from bigdl_tpu.utils.checkpoint_manager import \
    CheckpointManager as JCheckpointManager
import bigdl_tpu_torch.nn as pnn
import bigdl_tpu_torch.optim as poptim
from bigdl_tpu_torch.fleet import Fleet, FleetAutoscalePolicy
from bigdl_tpu_torch.serving.engine import OUTCOMES, Overloaded
from bigdl_tpu_torch.utils import chaos, config, elastic
from bigdl_tpu_torch.utils.checkpoint_manager import CheckpointManager
from bigdl_tpu_torch.utils.convert import params_from_jax
from test_torch_port_analysis import port_lock_witness  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FLEET = os.path.join(_REPO, "bigdl_tpu_torch", "fleet")

DIN, DOUT = 4, 3
#: the port's per-request outputs against the JAX fleet's
OUT_TOL = dict(rtol=1e-5, atol=1e-6)

_FLEET_KEYS = (
    "bigdl.compile.buckets",
    "bigdl.fleet.replicas", "bigdl.fleet.maxReplicaRestarts",
    "bigdl.fleet.gracePeriod", "bigdl.fleet.shadowSample",
    "bigdl.fleet.parityMode", "bigdl.fleet.promotionPollSec",
    "bigdl.fleet.autoscale.enabled", "bigdl.fleet.autoscale.intervalSec",
    "bigdl.chaos.killReplicaAt", "bigdl.chaos.corruptCandidateAt",
    "bigdl.chaos.sigtermFleetAt",
)

#: each package's fleet, policy, config, chaos, preemption flag,
#: rejection, checkpoint manager and SGD
JAX = SimpleNamespace(name="jax", Fleet=JFleet, Policy=JPolicy,
                      config=jconfig, chaos=jchaos, elastic=jelastic,
                      Overloaded=JOverloaded, Manager=JCheckpointManager,
                      SGD=joptim.SGD, fleet_kw={})
PORT = SimpleNamespace(name="port", Fleet=Fleet, Policy=FleetAutoscalePolicy,
                       config=config, chaos=chaos, elastic=elastic,
                       Overloaded=Overloaded, Manager=CheckpointManager,
                       SGD=poptim.SGD, fleet_kw={"device": "cpu"})
PACKAGES = (JAX, PORT)


@pytest.fixture(autouse=True)
def _fleet_env():
    """Both packages: chaos disarmed, preemption cleared, the reference's
    bucket plan, and every fleet key put back after."""
    for p in PACKAGES:
        p.elastic.clear_preemption()
        p.config.set_property("bigdl.compile.buckets", "2,4")
    yield
    for p in PACKAGES:
        p.chaos.uninstall()
        p.elastic.clear_preemption()
        for k in _FLEET_KEYS:
            p.config.clear_property(k)


def both(**keys):
    """Set ``bigdl.*`` keys (dots as ``__``) in both packages."""
    for p in PACKAGES:
        for k, v in keys.items():
            p.config.set_property(k.replace("__", "."), v)


def arm(**keys):
    """Set the keys and arm both chaos plans."""
    both(**keys)
    for p in PACKAGES:
        p.chaos.install()


_JAX_PARAMS = {}


def _jax_model(seed):
    m = (jnn.Sequential().add(jnn.Linear(DIN, 16)).add(jnn.Tanh())
         .add(jnn.Linear(16, DOUT)))
    m.reset(jax.random.PRNGKey(seed))
    return m


def _model(pkg, seed=7):
    """The reference's model of ``seed`` in ``pkg``: the port's twin holds
    the JAX draw's weights."""
    if pkg is JAX:
        return _jax_model(seed)
    if seed not in _JAX_PARAMS:
        _JAX_PARAMS[seed] = jax.tree_util.tree_map(
            np.asarray, _jax_model(seed).params)
    port = (pnn.Sequential().add(pnn.Linear(DIN, 16, device="cpu"))
            .add(pnn.Tanh()).add(pnn.Linear(16, DOUT, device="cpu")))
    return params_from_jax(_JAX_PARAMS[seed], port)


_ROW = np.zeros((DIN,), np.float32)
#: generous per-request deadline: these tests hold accounting and
#: lifecycle, not tail latency
_ENGINE_KW = {"deadline_ms": 5000.0}


def _fleet(pkg, replicas=2, engine_kw=None, **kw):
    fleet = pkg.Fleet(poll_interval=0.02, **pkg.fleet_kw, **kw)
    fleet.add_model("svc", _model(pkg), replicas=replicas, warm_row=_ROW,
                    engine_kw=dict(engine_kw or _ENGINE_KW))
    return fleet


def _each(scenario, replicas=2, **kw):
    """``{package name: scenario(pkg, fleet)}``, each fleet stopped after
    its scenario."""
    out = {}
    for p in PACKAGES:
        fleet = _fleet(p, replicas=replicas, **kw)
        try:
            out[p.name] = scenario(p, fleet)
        finally:
            fleet.stop()
    return out


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, DIN)).astype(np.float32)


def _assert_identity(stats):
    assert stats["unaccounted"] == 0, stats
    assert sum(stats[o] for o in OUTCOMES) == stats["submitted"], stats


def _counts(stats):
    return {k: stats[k] for k in ("submitted",) + OUTCOMES +
            ("unaccounted", "replicas", "version", "restarts")}


def _wait(predicate, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def masked(reason: str) -> str:
    """A report's reason with fingerprint keys and numbers masked: the
    words both packages must share."""
    reason = re.sub(r"\b[0-9a-f]{32}\b", "<fp>", reason)
    return re.sub(r"[-+]?\d+(\.\d+)?(e[-+]?\d+)?", "<n>", reason)


# ---------------------------------------------------------------------------
# autoscale policy units
# ---------------------------------------------------------------------------

def _policies(patience=2, cooldown=3):
    return [p.Policy(1, 4, up_queue_frac=0.5, down_queue_frac=0.05,
                     p99_factor=0.8, patience=patience, cooldown=cooldown)
            for p in PACKAGES]


def _decide(policies, *args, **kw):
    """One interval's decision from both policies, which must agree."""
    got = [p.decide(*args, **kw) for p in policies]
    assert got[0] == got[1], got
    return got[1]


def test_scale_up_needs_patience():
    ps = _policies()
    assert _decide(ps, 0.9, 0.0, 100.0, 1) == 0
    assert _decide(ps, 0.9, 0.0, 100.0, 1) == 1


def test_hot_p99_scales_up_with_shallow_queue():
    ps = _policies()
    assert _decide(ps, 0.0, 90.0, 100.0, 1) == 0
    assert _decide(ps, 0.0, 90.0, 100.0, 1) == 1


def test_cooldown_holds_after_action():
    ps = _policies(patience=1, cooldown=2)
    assert _decide(ps, 0.9, 0.0, 100.0, 1) == 1
    assert _decide(ps, 0.9, 0.0, 100.0, 2) == 0      # cooldown 1
    assert _decide(ps, 0.9, 0.0, 100.0, 2) == 0      # cooldown 2
    assert _decide(ps, 0.9, 0.0, 100.0, 2) == 1


def test_scale_down_on_idle():
    ps = _policies(patience=2, cooldown=0)
    assert _decide(ps, 0.0, 0.0, 100.0, 3) == 0
    assert _decide(ps, 0.0, 0.0, 100.0, 3) == -1


def test_never_below_floor_or_above_ceiling():
    ps = _policies(patience=1, cooldown=0)
    assert _decide(ps, 0.0, 0.0, 100.0, 1) == 0      # at the floor
    assert _decide(ps, 0.99, 200.0, 100.0, 4) == 0   # at the ceiling


def test_memory_pressure_caps_and_steps_down():
    ps = _policies(patience=1, cooldown=0)
    # pressure forbids up even with a saturated queue...
    assert _decide(ps, 0.99, 0.0, 100.0, 1, under_pressure=True) == 0
    # ...and forces a step down while above the floor
    assert _decide(ps, 0.99, 0.0, 100.0, 3, under_pressure=True) == -1


def test_flapping_signal_never_acts():
    ps = _policies(patience=2, cooldown=0)
    for _ in range(5):
        assert _decide(ps, 0.9, 0.0, 100.0, 2) == 0
        assert _decide(ps, 0.2, 0.0, 100.0, 2) == 0  # streak reset


def test_deterministic_replay():
    seq = [(0.9, 0.0), (0.9, 0.0), (0.0, 90.0), (0.0, 0.0),
           (0.0, 0.0), (0.0, 0.0), (0.9, 0.0)]
    runs = []
    for _ in range(2):
        ps = _policies()
        runs.append([_decide(ps, q, lat, 100.0, 2) for q, lat in seq])
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# basics: routing, accounting, lifecycle
# ---------------------------------------------------------------------------

def test_serves_across_replicas_with_exact_identity():
    def serve(p, fleet):
        handles = [fleet.submit("svc", r) for r in _rows(24)]
        outs = [np.asarray(h.result(timeout=10.0)) for h in handles]
        assert fleet.quiesce(10.0)
        return outs, fleet.stats("svc")

    got = _each(serve)
    for outs, stats in got.values():
        assert all(o.shape == (DOUT,) for o in outs)
        assert stats["completed"] == 24 and stats["replicas"] == 2
        _assert_identity(stats)
    assert _counts(got["port"][1]) == _counts(got["jax"][1])
    np.testing.assert_allclose(got["port"][0], got["jax"][0], **OUT_TOL)


def test_results_bit_identical_across_replicas():
    """Round-robin is invisible: every replica of one version answers bit
    for bit alike, in both packages."""
    row = _rows(1)[0]

    def serve(p, fleet):
        return [np.asarray(fleet.submit("svc", row).result(timeout=10.0))
                for _ in range(4)]

    got = _each(serve)
    for outs in got.values():
        for o in outs[1:]:
            np.testing.assert_array_equal(o, outs[0])
    np.testing.assert_allclose(got["port"][0], got["jax"][0], **OUT_TOL)


def test_unknown_service_is_a_keyerror():
    def probe(p, fleet):
        with pytest.raises(KeyError, match="unknown service"):
            fleet.submit("nope", _ROW)
        with pytest.raises(ValueError, match="already registered"):
            fleet.add_model("svc", _model(p))
        return fleet.stats("svc")["replicas"]

    assert _each(probe, replicas=1) == {"jax": 1, "port": 1}


def test_stop_is_idempotent_and_final():
    for p in PACKAGES:
        fleet = _fleet(p, replicas=1)
        fleet.submit("svc", _ROW).result(timeout=10.0)
        fleet.stop()
        fleet.stop()
        assert not fleet.supervisor.alive()
        with pytest.raises(p.Overloaded):
            fleet.submit("svc", _ROW)
        s = fleet.stats("svc")
        _assert_identity(s)
        assert (s["submitted"], s["completed"], s["rejected"]) == (1, 1, 0)
        assert not any(t.is_alive() for t in fleet.supervisor.threads())


def test_supervisor_owns_every_fleet_thread():
    def probe(p, fleet):
        names = [t.name for t in fleet.supervisor.threads()]
        assert _wait(lambda: fleet.supervisor.ticks > 0, 5.0)
        assert fleet.supervisor.tick_errors == 0
        return names

    assert _each(probe, replicas=1) == {"jax": ["fleet-supervisor"],
                                        "port": ["fleet-supervisor"]}


# ---------------------------------------------------------------------------
# replica lifecycle supervision
# ---------------------------------------------------------------------------

def test_killed_replica_restarts_and_identity_survives():
    """``bigdl.chaos.killReplicaAt``: the asynchronous kill strands the
    batcher's in-flight batch; the sweep abandons it into ``shed``, the
    slot restarts, and the fleet identity stays exact in both."""
    arm(bigdl__chaos__killReplicaAt="10:0")

    def run(p, fleet):
        for r in _rows(40):
            try:
                fleet.submit("svc", r)
            except p.Overloaded:
                pass
            time.sleep(0.005)
        assert p.chaos._state.replica_kills == 1
        assert _wait(lambda: fleet.stats("svc")["restarts"] >= 1, 10.0)
        assert fleet.quiesce(15.0)
        s = fleet.stats("svc")
        _assert_identity(s)
        # the restarted fleet still serves
        fleet.submit("svc", _ROW).result(timeout=10.0)
        return s["submitted"], s["replicas"], s["restarts"]

    assert _each(run) == {"jax": (40, 2, 1), "port": (40, 2, 1)}


def test_restart_budget_exhausted_abandons_slot():
    both(bigdl__fleet__maxReplicaRestarts=0)

    def run(p, fleet):
        svc = fleet._services["svc"]
        assert svc.kill_replica(0)
        assert _wait(lambda: fleet.stats("svc")["replicas"] == 1, 10.0)
        assert _wait(lambda: not any(r.crashed() for r in
                                     svc.active_replicas()), 5.0)
        # N-1 replicas, still serving, identity intact
        fleet.submit("svc", _ROW).result(timeout=10.0)
        assert fleet.quiesce(10.0)
        s = fleet.stats("svc")
        _assert_identity(s)
        return s["replicas"], s["restarts"]

    assert _each(run) == {"jax": (1, 0), "port": (1, 0)}


def test_autoscale_wiring_adds_and_retires_replicas():
    """The supervisor's autoscale tick turns forced decisions into replica
    lifecycle, in both packages."""
    both(bigdl__fleet__autoscale__enabled=True,
         bigdl__fleet__autoscale__intervalSec=0.02)

    def run(p, fleet):
        svc = fleet._services["svc"]
        svc._policy.decide = lambda *a, **k: 1
        assert _wait(lambda: fleet.stats("svc")["replicas"] == 2, 10.0)
        svc._policy.decide = lambda *a, **k: -1
        assert _wait(lambda: fleet.stats("svc")["replicas"] == 1, 10.0)
        fleet.submit("svc", _ROW).result(timeout=10.0)
        assert fleet.quiesce(10.0)
        s = fleet.stats("svc")
        _assert_identity(s)
        return _counts(s)

    got = _each(run, replicas=1)
    assert got["port"] == got["jax"]


def test_fleet_sigterm_drains_with_exact_accounting():
    arm(bigdl__chaos__sigtermFleetAt=5)

    def run(p, fleet):
        rejected = 0
        for r in _rows(30):
            try:
                fleet.submit("svc", r)
            except p.Overloaded:
                rejected += 1
            time.sleep(0.01)
        assert p.chaos._state.fleet_sigterms == 1
        assert p.elastic.preemption_requested()
        assert rejected > 0, "late arrivals must reject retriably"
        assert fleet.quiesce(15.0)
        s = fleet.stats("svc")
        _assert_identity(s)
        assert s["completed"] > 0 and s["draining"]
        return s["submitted"]

    assert _each(run, replicas=1) == {"jax": 30, "port": 30}


# ---------------------------------------------------------------------------
# the unsupervised-thread-in-fleet lint rule over the port's fleet
# ---------------------------------------------------------------------------

RULE = "unsupervised-thread-in-fleet"


def _rules(path):
    return [f.rule for f in lint_paths([str(path)])]


def test_flags_raw_thread_in_fleet(tmp_path):
    """A raw thread written into a copy of the port's fleet is a finding,
    one per construction site."""
    dst = tmp_path / "fleet"
    shutil.copytree(PORT_FLEET, dst)
    with open(dst / "replica.py", "a", encoding="utf-8") as f:
        f.write("\nimport threading\n"
                "_t = threading.Thread(target=print)\n"
                "from threading import Thread\n"
                "_u = Thread(target=print)\n")
    assert _rules(dst).count(RULE) == 2


def test_outside_fleet_is_exempt():
    """The port's serving engines start their batchers raw: outside a
    fleet package the rule is silent."""
    assert RULE not in _rules(os.path.join(_REPO, "bigdl_tpu_torch",
                                           "serving"))


def test_inline_allow_silences(tmp_path):
    """The supervisor's one construction site carries the allow; a copy
    without it has exactly one finding."""
    dst = tmp_path / "fleet"
    shutil.copytree(PORT_FLEET, dst)
    assert RULE not in _rules(dst)
    sup = dst / "supervisor.py"
    sup.write_text(sup.read_text(encoding="utf-8").replace(
        f"# lint: allow({RULE})", ""), encoding="utf-8")
    assert _rules(dst).count(RULE) == 1


def test_shipped_fleet_package_is_clean():
    findings = lint_paths([PORT_FLEET])
    assert findings == [], "\n".join(str(f) for f in findings)


# ---------------------------------------------------------------------------
# the bigdl.fleet.* keys
# ---------------------------------------------------------------------------

_KEY = re.compile(r"bigdl\.fleet\.[A-Za-z0-9]+(?:\.[A-Za-z0-9]+)*")


def test_config_defaults_match_the_jax_table():
    """The port's ``bigdl.fleet.*`` keys and the three fleet chaos keys are
    the JAX table's, with its defaults."""
    def fleet_keys(table):
        return {k: v for k, v in table.items()
                if k.startswith("bigdl.fleet.")}

    assert fleet_keys(config._DEFAULTS) == fleet_keys(jconfig._DEFAULTS)
    assert len(fleet_keys(config._DEFAULTS)) == 18
    for k in ("bigdl.chaos.killReplicaAt", "bigdl.chaos.corruptCandidateAt",
              "bigdl.chaos.sigtermFleetAt"):
        assert config._DEFAULTS[k] == jconfig._DEFAULTS[k]


def test_fleet_package_reads_registered_keys_only():
    registered = set(k for k in config._DEFAULTS
                     if k.startswith("bigdl.fleet."))
    used = set()
    for fn in os.listdir(PORT_FLEET):
        if fn.endswith(".py"):
            with open(os.path.join(PORT_FLEET, fn), encoding="utf-8") as f:
                used |= set(_KEY.findall(f.read()))
    assert used and used - registered == set(), sorted(used - registered)
