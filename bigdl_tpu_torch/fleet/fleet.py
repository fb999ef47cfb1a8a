"""The :class:`Fleet` facade and per-service state
(``bigdl_tpu/fleet/fleet.py``).

A fleet runs N named services (one model each) x N replicas (one port
``ServingEngine`` each, on the card unless the fleet is built with
``device="cpu"``) under one :class:`FleetSupervisor`.  The fleet
owns the layer the engines deliberately do not: request accounting that
SURVIVES a replica crash, atomic traffic cutover between model
versions, replica restart/autoscale policy, and checkpoint-to-serving
promotion.

Fleet-level accounting: every handle the fleet returns is tracked until
terminal.  The engine's own identity (completed + shed + rejected +
quarantined == submitted) holds per engine only while the engine lives;
a hard-killed batcher strands its popped in-flight batch unaccounted.
The supervisor's sweep closes that hole with
``RequestHandle.abandon()`` — crashed-replica victims land in ``shed``,
retriable, and the FLEET identity holds exactly across every chaos
fault.

Routing: round-robin over the healthy replicas of the requested
service, snapshotted under the service lock — the same lock a rollout's
cutover swaps the replica list under, so any submit routes entirely to
the old set or entirely to the new, never to a half-swapped router.

Promotion: ``CheckpointManager.load_latest`` gives the port's snapshot
payload (a ``state_dict``), which goes into a copy of the served model
(:meth:`_Service.candidate_from_snapshot`) before the gated rollout.

Telemetry: the ``Fleet/rejected``, ``crash_sheds``, ``replica_restarts``,
``replica_abandoned``, ``replica_kills``, ``autoscale_actions``,
``promotions``, ``promotion_failures``, ``rollouts``, ``rollbacks``,
``parity_failures``, ``shadow_mirrored`` and ``supervisor_errors``
counters; the ``Fleet/replicas``, ``swap_ms`` and ``swap_to_serve_ms``
gauges; the incidents ``fleet/abandon``, ``slot_abandoned``,
``replica_restart``, ``autoscale``, ``promotion``, ``promotion_failure``,
``rollback``, ``cutover`` and ``preemption_drain``; a request the fleet
turns away gets a trace minted and closed ``rejected`` at the door.
"""

from __future__ import annotations

import copy
import logging
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from bigdl_tpu_torch import analysis, telemetry
from bigdl_tpu_torch.engine import DeviceLike, default_device
from bigdl_tpu_torch.fleet.autoscale import FleetAutoscalePolicy
from bigdl_tpu_torch.fleet.replica import Replica
from bigdl_tpu_torch.fleet.rollout import RolloutReport, run_rollout
from bigdl_tpu_torch.fleet.supervisor import FleetSupervisor
from bigdl_tpu_torch.resources import GOVERNOR
from bigdl_tpu_torch.serving.engine import (OUTCOMES, Overloaded,
                                            RequestHandle, ServingInfraError)
from bigdl_tpu_torch.telemetry import incident, request_trace
from bigdl_tpu_torch.utils import chaos, config, elastic

logger = logging.getLogger("bigdl_tpu_torch")


def _fleet_reject(service: str, reason: str) -> Overloaded:
    """Fleet-level rejection choke point: requests the fleet turns away
    never reach an engine's admission door, so the trace is minted AND
    terminated right here — a rejected submission still explains itself
    (``err.trace_id`` -> ``request_trace.get``)."""
    tid = request_trace.mint("fleet", service=service)
    err = Overloaded(reason)
    request_trace.verdict(tid, "rejected", error=err,
                          reason=reason.replace(" ", "_"))
    return err


class _Service:
    """One named model's serving state: active replicas, pending-handle
    ledger, shadow ring, restart budgets, promotion source."""

    def __init__(self, fleet: "Fleet", name: str, model,
                 replicas: int, warm_row: Optional[np.ndarray],
                 engine_kw: Optional[Dict[str, Any]]):
        self.fleet = fleet
        self.name = name
        self.model = model
        self.warm_row = warm_row
        self.engine_kw = dict(engine_kw or {})
        self._version_seq = 1        # guarded-by: _lock
        self.version = "v1"          # guarded-by: _lock
        self._lock = analysis.make_lock("fleet.service")
        self._rollout_lock = analysis.make_lock("fleet.rollout")
        self._slot_seq = 0           # guarded-by: _lock
        self._active: List[Replica] = []      # guarded-by: _lock
        #: (handle, replica) for every admitted request not yet tallied
        self._pending: List[Tuple[RequestHandle, Replica]] = []  # guarded-by: _lock
        self._counts: Dict[str, int] = dict.fromkeys(OUTCOMES, 0)  # guarded-by: _lock
        self._counts["submitted"] = 0
        self._rr = 0                 # guarded-by: _lock
        self._restarts: Dict[int, int] = {}   # guarded-by: _lock
        self.draining = False        # guarded-by: _lock
        shadow_n = max(1, config.get_int("bigdl.fleet.shadowSample", 8))
        #: recently COMPLETED (decoded payload, output) pairs — the
        #: rollout's shadow-traffic source.  Bounded: parity needs a
        #: sample, not a replay log.
        self.shadow: "deque[Tuple[Any, Any]]" = deque(maxlen=shadow_n)  # guarded-by: _lock
        self._cut_ns: Optional[int] = None            # guarded-by: _lock
        self._cut_version: Optional[str] = None       # guarded-by: _lock
        #: cutover -> first completed request on the new replica set
        self.last_swap_to_serve_ms: Optional[float] = None  # guarded-by: _lock
        self.last_promotion: Optional[RolloutReport] = None  # guarded-by: _lock
        self._watch_mgr = None
        self._promo_tick = 0         # guarded-by: _lock
        self._promo_interval = config.get_float(
            "bigdl.fleet.promotionPollSec", 0.2)
        self._last_promoted = -1     # guarded-by: _lock
        self._promo_attempted = -1   # guarded-by: _lock
        self._as_tick = 0            # guarded-by: _lock
        self._as_interval = config.get_float(
            "bigdl.fleet.autoscale.intervalSec", 0.25)
        self._policy = FleetAutoscalePolicy(
            config.get_int("bigdl.fleet.minReplicas", 1),
            config.get_int("bigdl.fleet.maxReplicas", 4),
            config.get_float("bigdl.fleet.autoscale.upQueueFrac", 0.5),
            config.get_float("bigdl.fleet.autoscale.downQueueFrac", 0.05),
            config.get_float("bigdl.fleet.autoscale.p99Factor", 0.8),
            config.get_int("bigdl.fleet.autoscale.patience", 2),
            config.get_int("bigdl.fleet.autoscale.cooldown", 3))
        for _ in range(max(1, replicas)):
            self._active.append(self.new_replica(model, self.version))
        self._publish_replica_gauge()

    # -- replica construction / router state ------------------------------

    def new_replica(self, model, version: str,
                    slot: Optional[int] = None) -> Replica:
        if slot is None:
            with self._lock:
                slot = self._slot_seq
                self._slot_seq += 1
        return Replica(self.name, slot, version, model,
                       warm_row=self.warm_row, engine_kw=self.engine_kw)

    def active_replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._active)

    def peek_next_version(self) -> str:
        return f"v{self._version_seq + 1}"

    def cutover(self, new: List[Replica], model, version: str,
                cut_ns: int) -> List[Replica]:
        """The atomic router swap: one pointer exchange under the
        service lock.  Returns the old replica set for the caller to
        drain."""
        with self._lock:
            old = self._active
            self._active = list(new)
            self.model = model
            self.version = version
            self._version_seq += 1
            self._cut_ns = cut_ns
            self._cut_version = version
            self.last_swap_to_serve_ms = None
        self._publish_replica_gauge()
        return old

    def shadow_sample(self, n: int) -> List[Tuple[Any, Any]]:
        with self._lock:
            return list(self.shadow)[-max(0, n):]

    def candidate_from_snapshot(self, payload: Dict[str, Any]):
        """A copy of the served model holding a snapshot's ``state_dict``
        (on the served model's device)."""
        with self._lock:
            model = self.model
        candidate = copy.deepcopy(model)
        candidate.load_state_dict(payload)
        return candidate

    def _publish_replica_gauge(self) -> None:
        telemetry.gauge("Fleet/replicas",
                        labels={"service": self.name}).set(
                            len(self._active))

    # -- request path ------------------------------------------------------

    def submit(self, payload, deadline_ms: Optional[float] = None
               ) -> RequestHandle:
        self.fleet._next_submit(self)
        with self._lock:
            self._counts["submitted"] += 1
            reps = [r for r in self._active if r.healthy()]
            if self.draining or not reps:
                self._counts["rejected"] += 1
                reason = ("fleet draining" if self.draining
                          else "no healthy replicas")
                telemetry.counter("Fleet/rejected",
                                  labels={"service": self.name}).inc()
                raise _fleet_reject(self.name, reason)
            self._rr += 1
            rep = reps[self._rr % len(reps)]
        try:
            h = rep.engine.submit(payload, deadline_ms)
        except Exception:
            # the engine said no (Overloaded) or escalated before
            # admission (e.g. a payload past the host-memory budget):
            # either way the request never entered a queue — it is a
            # fleet-level rejection and the identity stays closed
            with self._lock:
                self._counts["rejected"] += 1
            telemetry.counter("Fleet/rejected",
                              labels={"service": self.name}).inc()
            raise
        with self._lock:
            self._pending.append((h, rep))
        return h

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def sweep(self) -> None:
        """Tally terminal handles into the service counts; abandon the
        stranded in-flight requests of dead engines (the crash hole the
        engine itself cannot close).  Concurrent-safe by list swap: each
        sweeper owns the batch it swapped out."""
        with self._lock:
            batch, self._pending = self._pending, []
            cut_ns, cut_version = self._cut_ns, self._cut_version
        keep: List[Tuple[RequestHandle, Replica]] = []
        tally: Dict[str, int] = {}
        first_serve_ms = None
        abandoned = 0
        abandon_reason: Optional[str] = None
        abandon_tid: Optional[str] = None
        for h, rep in batch:
            if not h.done():
                eng = rep.engine
                if eng.terminal and not eng.batcher_alive():
                    # nothing can ever finish this handle: the batcher
                    # is dead and the leftover sweep already ran
                    crashed = rep.crashed()
                    h.abandon(ServingInfraError(
                        f"replica {rep.name} "
                        f"{'crashed' if crashed else 'went down'} with "
                        "this request in flight — retriable"),
                        reason="replica_crash" if crashed else
                        "replica_down")
                    abandoned += 1
                    abandon_reason = ("replica_crash" if crashed
                                      else "replica_down")
                    if abandon_tid is None:
                        abandon_tid = getattr(h, "trace_id", None)
                    if crashed:
                        telemetry.counter(
                            "Fleet/crash_sheds",
                            labels={"service": self.name}).inc()
                else:
                    keep.append((h, rep))
                    continue
            out = h.outcome or "shed"
            tally[out] = tally.get(out, 0) + 1
            if out == "completed":
                try:
                    result = h.result(timeout=0)
                except Exception:
                    result = None
                if result is not None:
                    with self._lock:
                        self.shadow.append((h.raw, result))
                if (cut_ns is not None and rep.version == cut_version
                        and h.finish_ns is not None
                        and h.finish_ns >= cut_ns):
                    ms = (h.finish_ns - cut_ns) / 1e6
                    if first_serve_ms is None or ms < first_serve_ms:
                        first_serve_ms = ms
        if abandoned:
            # the sweep just closed the crash hole — one flight-recorder
            # event (and at most one bundle per service+cause) for the
            # whole abandoned cohort, anchored on its first trace
            incident.record("fleet/abandon", service=self.name,
                            victims=abandoned, reason=abandon_reason)
            incident.maybe_dump(f"fleet/{self.name}/{abandon_reason}",
                                trace_id=abandon_tid,
                                reason=abandon_reason)
        with self._lock:
            for k, v in tally.items():
                self._counts[k] += v
            self._pending.extend(keep)
            if first_serve_ms is not None and self._cut_ns == cut_ns:
                self.last_swap_to_serve_ms = first_serve_ms
                self._cut_ns = None
                telemetry.gauge("Fleet/swap_to_serve_ms").set(
                    first_serve_ms)

    # -- supervision -------------------------------------------------------

    def check_restarts(self) -> None:
        """Replace crashed replicas within the per-slot restart budget;
        a slot past its budget is abandoned (better N-1 replicas than a
        crash loop soaking the supervisor)."""
        max_restarts = config.get_int("bigdl.fleet.maxReplicaRestarts", 2)
        for rep in self.active_replicas():
            if not rep.crashed():
                continue
            # zero-grace retire: out of the router either way, and the
            # engine's own stop path sweeps its leftovers
            rep.retire(0.0)
            with self._lock:
                try:
                    self._active.remove(rep)
                except ValueError:
                    continue            # a rollout already swapped it out
                used = self._restarts.get(rep.slot, 0)
            if used >= max_restarts:
                telemetry.counter("Fleet/replica_abandoned",
                                  labels={"service": self.name}).inc()
                incident.record("fleet/slot_abandoned",
                                service=self.name, replica=rep.name,
                                slot=rep.slot, restarts=used)
                logger.error(
                    "fleet %s: replica %s crashed past its restart "
                    "budget (%d) — slot abandoned", self.name, rep.name,
                    max_restarts)
                self._publish_replica_gauge()
                continue
            with self._lock:
                self._restarts[rep.slot] = used + 1
            telemetry.counter("Fleet/replica_restarts",
                              labels={"service": self.name}).inc()
            incident.record("fleet/replica_restart", service=self.name,
                            replica=rep.name, slot=rep.slot,
                            attempt=used + 1, budget=max_restarts)
            logger.warning(
                "fleet %s: replica %s crashed — restarting slot %d "
                "(restart %d/%d)", self.name, rep.name, rep.slot,
                used + 1, max_restarts)
            try:
                fresh = self.new_replica(self.model, self.version,
                                         slot=rep.slot)
            except Exception as e:
                telemetry.counter("Fleet/replica_abandoned",
                                  labels={"service": self.name}).inc()
                logger.error("fleet %s: slot %d restart failed: %r",
                             self.name, rep.slot, e)
                continue
            with self._lock:
                self._active.append(fresh)
            self._publish_replica_gauge()

    def kill_replica(self, index: int) -> bool:
        """Chaos entry: hard-kill the ``index``-th (mod count) active
        replica's batcher thread."""
        reps = self.active_replicas()
        if not reps:
            return False
        return reps[index % len(reps)].kill()

    def autoscale_tick(self, poll_interval: float) -> None:
        if not config.get_bool("bigdl.fleet.autoscale.enabled", False):
            return
        with self._lock:
            self._as_tick += 1
            tick = self._as_tick
        every = max(1, int(round(self._as_interval / poll_interval)))
        if tick % every:
            return
        reps = [r for r in self.active_replicas() if r.healthy()]
        if not reps:
            return
        queue_frac = sum(
            r.engine.queue_depth() / max(1, r.engine.max_queue_depth)
            for r in reps) / len(reps)
        p99 = telemetry.histogram("Serving/latency_ms").percentile(99)
        if not (isinstance(p99, (int, float)) and p99 == p99):  # NaN guard
            p99 = 0.0
        action = self._policy.decide(
            queue_frac, float(p99), reps[0].engine.deadline_ms,
            len(reps), GOVERNOR.under_pressure())
        if action > 0:
            fresh = self.new_replica(self.model, self.version)
            with self._lock:
                self._active.append(fresh)
            telemetry.counter("Fleet/autoscale_actions",
                              labels={"service": self.name,
                                      "direction": "up"}).inc()
            incident.record("fleet/autoscale", service=self.name,
                            direction="up", queue_frac=round(queue_frac, 3),
                            p99_ms=round(float(p99), 2))
            logger.info("fleet %s: autoscale +1 replica (queue %.2f, "
                        "p99 %.1f ms) -> %d", self.name, queue_frac,
                        p99, len(reps) + 1)
        elif action < 0:
            with self._lock:
                victim = self._active.pop() if len(self._active) > 1 \
                    else None
            if victim is not None:
                victim.retire(self.fleet.grace_period)
                telemetry.counter("Fleet/autoscale_actions",
                                  labels={"service": self.name,
                                          "direction": "down"}).inc()
                incident.record("fleet/autoscale", service=self.name,
                                direction="down",
                                queue_frac=round(queue_frac, 3))
                logger.info("fleet %s: autoscale -1 replica -> %d",
                            self.name, len(reps) - 1)
        self._publish_replica_gauge()

    def promotion_tick(self, poll_interval: float) -> None:
        """Checkpoint-to-serving promotion as ONE verified step: a new
        committed snapshot (cheap ``watch_latest`` poll) is deep-loaded
        — payload checksums AND the save-time semantic fingerprint
        verify inside ``load_latest`` — then rolled out through the full
        gated state machine.  A snapshot that fails any gate is recorded
        and never retried (the NEXT snapshot gets its chance); the
        incumbent keeps serving throughout."""
        if self._watch_mgr is None:
            return
        with self._lock:
            self._promo_tick += 1
            tick = self._promo_tick
        every = max(1, int(round(self._promo_interval / poll_interval)))
        if tick % every:
            return
        try:
            newest = self._watch_mgr.watch_latest()
        except Exception as e:
            logger.warning("fleet %s: promotion watch failed: %r",
                           self.name, e)
            return
        if (newest is None or newest <= self._last_promoted or
                newest == self._promo_attempted):
            return
        with self._lock:
            self._promo_attempted = newest
        model = None
        try:
            loaded = self._watch_mgr.load_latest()
            if loaded:
                payload, _optim, n = loaded
                model = self.candidate_from_snapshot(payload)
        except Exception as e:
            logger.error("fleet %s: snapshot %d failed verified load: %r",
                         self.name, newest, e)
        if model is None:
            telemetry.counter("Fleet/promotion_failures",
                              labels={"service": self.name}).inc()
            return
        report = run_rollout(self, model)
        with self._lock:
            self.last_promotion = report
        if report.promoted:
            with self._lock:
                self._last_promoted = max(n, newest)
            telemetry.counter("Fleet/promotions",
                              labels={"service": self.name}).inc()
            incident.record("fleet/promotion", service=self.name,
                            snapshot=n, to_version=report.to_version)
            logger.info("fleet %s: snapshot %d promoted to %s",
                        self.name, n, report.to_version)
        else:
            telemetry.counter("Fleet/promotion_failures",
                              labels={"service": self.name}).inc()
            incident.record("fleet/promotion_failure",
                            service=self.name, snapshot=n,
                            reason=report.reason)

    # -- teardown / introspection -----------------------------------------

    def drain_all(self, grace: float) -> None:
        with self._lock:
            self.draining = True
        for rep in self.active_replicas():
            rep.retire(grace)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = dict(self._counts)
            pending = len(self._pending)
            replicas = len(self._active)
            version = self.version
            draining = self.draining
            restarts = sum(self._restarts.values())
            swap_ms = self.last_swap_to_serve_ms
        out["unaccounted"] = out["submitted"] - sum(
            out[o] for o in OUTCOMES)
        out["pending"] = pending
        out["replicas"] = replicas
        out["version"] = version
        out["draining"] = draining
        out["restarts"] = restarts
        out["last_swap_to_serve_ms"] = swap_ms
        return out


class Fleet:
    """The control-plane facade.  Typical shape::

        fleet = Fleet()                  # device="cuda"; the models lie there
        fleet.add_model("ranker", model, replicas=2, warm_row=row)
        fleet.watch("ranker", CheckpointManager(ckpt_dir))  # promotion
        h = fleet.submit("ranker", payload)
        out = h.result(timeout=1.0)
        report = fleet.rollout("ranker", candidate)   # manual blue/green
        fleet.stop()

    All knobs default from ``bigdl.fleet.*``.  Every replica's engine
    serves on ``device`` unless a service's ``engine_kw`` names another.
    ``stop()`` is one-way and idempotent, mirroring the engine
    contract."""

    def __init__(self, poll_interval: Optional[float] = None,
                 grace_period: Optional[float] = None,
                 start: bool = True, device: DeviceLike = "cuda"):
        self.device = default_device(device)
        self.poll_interval = float(
            poll_interval if poll_interval is not None else
            config.get_float("bigdl.fleet.pollInterval", 0.05))
        self.grace_period = float(
            grace_period if grace_period is not None else
            config.get_float("bigdl.fleet.gracePeriod", 5.0))
        self._services: Dict[str, _Service] = {}
        self._seq_lock = analysis.make_lock("fleet.seq")
        self._submit_seq = 0
        self._closed = False
        self._preempt_seen = False
        self.supervisor = FleetSupervisor(self, self.poll_interval)
        if start:
            self.supervisor.start()

    # -- service management ------------------------------------------------

    def add_model(self, name: str, model,
                  replicas: Optional[int] = None,
                  warm_row: Optional[np.ndarray] = None,
                  engine_kw: Optional[Dict[str, Any]] = None) -> None:
        """Register ``name`` and bring up its replicas (with ``warm_row``,
        each runs every bucket once before taking traffic)."""
        if self._closed:
            raise ServingInfraError("fleet is stopped — build a new one")
        if name in self._services:
            raise ValueError(f"service {name!r} already registered")
        n = int(replicas if replicas is not None else
                config.get_int("bigdl.fleet.replicas", 1))
        kw = dict(engine_kw or {})
        kw.setdefault("device", self.device)
        self._services[name] = _Service(self, name, model, n, warm_row, kw)
        logger.info("fleet: service %s up (%d replica(s))", name, n)

    def watch(self, name: str, checkpoint) -> None:
        """Arm checkpoint-to-serving promotion for ``name``:
        ``checkpoint`` is a ``CheckpointManager`` or a directory path.
        The supervisor polls ``watch_latest()`` every
        ``bigdl.fleet.promotionPollSec`` and promotes each NEW committed
        snapshot through the verified rollout path."""
        from bigdl_tpu_torch.utils.checkpoint_manager import \
            CheckpointManager
        svc = self._service(name)
        if isinstance(checkpoint, str):
            checkpoint = CheckpointManager(checkpoint)
        svc._watch_mgr = checkpoint

    def _service(self, name: str) -> _Service:
        try:
            return self._services[name]
        except KeyError:
            raise KeyError(f"unknown service {name!r}; registered: "
                           f"{sorted(self._services)}") from None

    # -- request path ------------------------------------------------------

    def submit(self, name: str, payload,
               deadline_ms: Optional[float] = None) -> RequestHandle:
        """Route one request to a healthy replica of ``name`` (or raise
        a structured retriable :class:`Overloaded`)."""
        if self._closed:
            raise _fleet_reject(name, "fleet stopped")
        return self._service(name).submit(payload, deadline_ms)

    def _next_submit(self, service: _Service) -> int:
        """Fleet-wide submit sequencing — also the chaos choke point:
        ``killReplicaAt`` and ``sigtermFleetAt`` count THESE."""
        with self._seq_lock:
            self._submit_seq += 1
            n = self._submit_seq
        victim = chaos.kill_replica(n)
        if victim is not None:
            service.kill_replica(victim)
        chaos.sigterm_fleet(n)
        return n

    # -- rollout -----------------------------------------------------------

    def rollout(self, name: str, candidate_model,
                expected_fingerprint: Optional[str] = None,
                replicas: Optional[int] = None,
                parity: Optional[str] = None,
                grace: Optional[float] = None) -> RolloutReport:
        """Blue/green swap ``name`` to ``candidate_model`` through the
        gated state machine (see :mod:`bigdl_tpu_torch.fleet.rollout`).
        Returns the report; on any gate violation the candidate is
        rolled back and the incumbent never stopped serving."""
        return run_rollout(self._service(name), candidate_model,
                           expected_fingerprint=expected_fingerprint,
                           replicas=replicas, parity=parity,
                           grace=grace if grace is not None
                           else self.grace_period)

    # -- supervision tick --------------------------------------------------

    def _tick(self) -> None:    # thread-root: fleet-supervisor monitor
        preempted = elastic.preemption_requested()
        if preempted and not self._preempt_seen:
            self._preempt_seen = True
            logger.warning("fleet: preemption observed — all services "
                           "draining (replicas self-drain, rollouts "
                           "abort)")
            # the signal handler itself only appended the ring event
            # (async-signal-safe); the supervisor thread is where the
            # flight-recorder bundle is safe to write
            incident.record("fleet/preemption_drain",
                            services=sorted(self._services))
            incident.maybe_dump("preemption", reason="preemption")
            for svc in list(self._services.values()):
                with svc._lock:
                    svc.draining = True
        for svc in list(self._services.values()):
            svc.sweep()
            if not preempted and not svc.draining:
                svc.check_restarts()
                svc.autoscale_tick(self.poll_interval)
                svc.promotion_tick(self.poll_interval)

    # -- accounting / teardown --------------------------------------------

    def stats(self, name: Optional[str] = None) -> Dict[str, Any]:
        """Per-service outcome counters plus the fleet aggregate.  The
        identity (``completed + shed + rejected + quarantined ==
        submitted``; ``unaccounted == 0``) is exact after
        :meth:`quiesce` (or :meth:`stop`)."""
        if name is not None:
            return self._service(name).stats()
        services = {n: s.stats() for n, s in self._services.items()}
        total: Dict[str, int] = dict.fromkeys(
            ("submitted",) + OUTCOMES, 0)
        for s in services.values():
            for k in total:
                total[k] += s[k]
        total["unaccounted"] = total["submitted"] - sum(
            total[o] for o in OUTCOMES)
        return {"services": services, "fleet": total,
                "submit_seq": self._submit_seq}

    def quiesce(self, timeout: float = 30.0) -> bool:
        """Sweep until every issued handle is terminal (True) or the
        timeout lapses (False) — call before asserting the exact
        identity."""
        deadline = time.monotonic() + timeout
        while True:
            pending = 0
            for svc in list(self._services.values()):
                svc.sweep()
                pending += svc.pending_count()
            if pending == 0:
                return True
            if time.monotonic() > deadline:
                return False
            time.sleep(0.01)

    def stop(self, grace: Optional[float] = None) -> None:
        """Fleet-wide graceful shutdown: supervisor down (its threads
        joined), every replica drains via the engine stop contract, then a
        final sweep closes the accounting.  Idempotent and one-way."""
        if self._closed:
            return
        self._closed = True
        budget = grace if grace is not None else self.grace_period
        self.supervisor.stop()
        for svc in list(self._services.values()):
            svc.drain_all(budget)
        self.quiesce(timeout=budget + 10.0)

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
