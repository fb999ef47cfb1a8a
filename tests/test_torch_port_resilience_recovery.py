"""The trainers' recoveries end to end: OOM re-plan, preemption, the hung-step
watchdog, the bit-flip heal, step and checkpoint chaos and host-memory
pressure, held against the JAX package.

Split from ``test_torch_port_resilience.py``,
whose docstring states what is held against the JAX package and with which
tolerances; the helpers and fixtures come from there.  No test file of the
port holds more than 25 tests: pytest-xdist's ``loadfile`` scheduler hands
out the largest files first (ROADMAP.md, standing rules).
"""

import os
import signal
import threading

import numpy as np
import pytest

import bigdl_tpu.optim as joptim
from bigdl_tpu import integrity as jintegrity
from bigdl_tpu.telemetry import incident as jincident
from bigdl_tpu.utils import chaos as jchaos, elastic as jelastic
from bigdl_tpu.utils.checkpoint_manager import \
    CheckpointManager as JCheckpointManager
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu_torch import integrity, telemetry
from bigdl_tpu_torch.dataset import SampleToMiniBatch, ShardedDataSet
from bigdl_tpu_torch.optim import (max_epoch, max_iteration, several_iteration,
                                   SGD)
from bigdl_tpu_torch.optim.optimizer import LocalOptimizer
from bigdl_tpu_torch.resources import DeviceMemoryError, HostMemoryError
from bigdl_tpu_torch.resources.governor import GOVERNOR
from bigdl_tpu_torch.telemetry import incident
from bigdl_tpu_torch.utils import chaos, elastic
from bigdl_tpu_torch.utils.checkpoint_manager import CheckpointManager

from test_torch_port_resilience import (_env, _jax_mlp, _jax_weights,
                                        _optim_events, _port_mlp,
                                        _port_samples, _records, _weights, arm,
                                        both, jax_train, PARITY, port_train,
                                        seeded)


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
