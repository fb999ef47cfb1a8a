"""One serving replica: a port ``ServingEngine`` plus the fleet-side
lifecycle state the supervisor keys on (``bigdl_tpu/fleet/replica.py``).

A replica is DISPOSABLE: the engine's stop is one-way, so a replica is
never revived.  A crashed or retired slot is replaced by a fresh replica,
whose warmup runs one forward per ``bigdl.compile.buckets`` size before it
takes traffic.  The fleet tells two ends of life apart:

* **retired**: the fleet took it out of rotation on purpose (a rollout's
  old side, a scale-down, fleet stop).  Queued work drains within the
  grace window; nothing to repair.
* **crashed**: the batcher thread died without an orderly drain (an
  asynchronous kill, an escaped internal error).  The supervisor sweeps
  the replica's stranded in-flight requests into ``shed`` (the accounting
  identity survives the crash) and restarts the slot within its budget.

:meth:`Replica.kill` (``bigdl.chaos.killReplicaAt``) raises
:class:`ReplicaKilled` in the batcher thread with
``PyThreadState_SetAsyncExc``, which lands when that thread next runs
Python bytecode.  On the card a batcher inside one CUDA call (a forward's
host pull waiting on its kernels) receives it only when that call returns,
as the engines' hung-dispatch abort does (``serving/engine.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from bigdl_tpu_torch import analysis, telemetry
from bigdl_tpu_torch.serving.engine import ServingEngine
from bigdl_tpu_torch.utils import elastic


class ReplicaKilled(BaseException):
    """Raised asynchronously into a replica's batcher thread by the chaos
    harness (``bigdl.chaos.killReplicaAt``).  A ``BaseException`` on
    purpose: the batcher's ``except Exception`` recovery must NOT absorb
    it; it models a hard crash, not a dispatch error."""


class Replica:
    """A supervised serving replica: engine, slot and lifecycle flags.
    ``slot`` survives restarts (the restart budget is per slot, not per
    engine); ``version`` names the model generation it serves."""

    def __init__(self, service: str, slot: int, version: str, model,
                 warm_row: Optional[np.ndarray] = None,
                 engine_kw: Optional[Dict[str, Any]] = None):
        self.service = service
        self.slot = slot
        self.version = version
        self._lock = analysis.make_lock("fleet.replica")
        self.retired = False         # guarded-by: _lock
        self.engine = ServingEngine(model, **(engine_kw or {}))
        if warm_row is not None:
            # every bucket runs once BEFORE the replica takes traffic, so
            # the first routed request pays no first-call cost
            self.engine.warmup(warm_row)

    @property
    def name(self) -> str:
        return f"{self.service}/{self.version}#{self.slot}"

    def healthy(self) -> bool:
        """Routable: in rotation, batcher alive, admission open."""
        return (not self.retired and not self.engine.terminal and
                not self.engine.draining and self.engine.batcher_alive())

    def crashed(self) -> bool:
        """Died WITHOUT an orderly drain: the restart signal."""
        return not self.retired and self.engine.crashed()

    def retire(self, grace: Optional[float] = None  # thread-root: also entered from the fleet supervisor (check_restarts / autoscale down / drain_all)
               ) -> None:
        """Deliberate end of life: out of rotation first (the flag), then
        the engine's graceful drain.  Idempotent.  Entered from the user's
        thread (fleet stop, a rollout's drain) and from the supervisor
        (crash replacement, autoscale down); the lifecycle lock makes the
        flag flip a clean happens-before edge for ``healthy()``."""
        with self._lock:
            self.retired = True
        self.engine.stop(grace)

    def kill(self) -> bool:
        """Chaos only: hard-kill the batcher thread with an asynchronously
        raised :class:`ReplicaKilled`.  True when the injection was
        delivered (the thread was alive to receive it).  The engine's
        ``finally`` still closes the engine and sheds QUEUED requests, but
        a popped in-flight batch is stranded unaccounted: the hole the
        supervisor's sweep (``RequestHandle.abandon``) plugs."""
        tid = self.engine.batcher_ident()
        if tid is None or not self.engine.batcher_alive():
            return False
        # deliberately NO completion re-check under the engine lock: this
        # injection MODELS the stray abort the async-abort-unguarded rule
        # exists to prevent; the supervisor's sweep is the system under
        # test
        delivered = elastic._async_raise(tid, ReplicaKilled)  # lint: allow(async-abort-unguarded)
        if delivered:
            telemetry.counter("Fleet/replica_kills",
                              labels={"service": self.service}).inc()
        return delivered
