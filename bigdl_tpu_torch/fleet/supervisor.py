"""The fleet's thread-ownership authority and monitor loop
(``bigdl_tpu/fleet/supervisor.py``).

Every thread of the fleet control plane is born HERE, through
:meth:`FleetSupervisor.spawn`: the JAX package's
``unsupervised-thread-in-fleet`` lint rule, which the port's tests run over
``bigdl_tpu_torch/fleet/``, makes a raw ``threading.Thread`` anywhere else
in the package a finding, so a thread the supervisor cannot see (cannot
join at fleet stop, cannot report) cannot be written by accident.  The
replicas' batcher threads belong to their engines and end through the
engines' own ``stop``.

The monitor loop ticks the fleet every ``bigdl.fleet.pollInterval``
seconds: it sweeps request accounting, restarts crashed replicas, runs the
autoscale decisions, polls checkpoint directories for promotable snapshots
and notices a fleet-wide preemption.  A tick that raises is counted
(``Fleet/supervisor_errors``) and logged but never kills the monitor:
supervision that dies of the fault it supervises is no supervision.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, List, Optional

from bigdl_tpu_torch import analysis, telemetry
from bigdl_tpu_torch.utils import config

logger = logging.getLogger("bigdl_tpu_torch")


class FleetSupervisor:
    """Monitor thread and thread factory of one
    :class:`~bigdl_tpu_torch.fleet.Fleet`.  See the module docstring for
    the contract."""

    def __init__(self, fleet, poll_interval: Optional[float] = None):
        self._fleet = fleet
        self.poll_interval = float(
            poll_interval if poll_interval is not None else
            config.get_float("bigdl.fleet.pollInterval", 0.05))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._spawned: List[threading.Thread] = []   # guarded-by: _lock
        self._lock = analysis.make_lock("fleet.supervisor")
        self.tick_errors = 0
        self.ticks = 0

    def spawn(self, name: str, target: Callable[[], None]
              ) -> threading.Thread:
        """The ONE place fleet threads are constructed: registers the
        thread (fleet stop joins what it spawned; diagnostics can list it)
        and starts it daemonic, so a fleet never pins an interpreter
        open."""
        t = threading.Thread(  # lint: allow(unsupervised-thread-in-fleet)
            target=target, daemon=True, name=name)
        # the allow above IS the registration point the rule demands:
        # every other construction site in this package is a finding
        with self._lock:
            self._spawned.append(t)
        t.start()
        return t

    def threads(self) -> List[threading.Thread]:
        with self._lock:
            return list(self._spawned)

    def start(self) -> "FleetSupervisor":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = self.spawn("fleet-supervisor", self._monitor)
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the monitor loop and join every thread spawned here
        (idempotent).  The replicas' batcher threads belong to their
        engines and drain through the fleet's retire path."""
        self._stop.set()
        for t in self.threads():
            if t.is_alive() and t is not threading.current_thread():
                t.join(timeout=timeout)

    def alive(self) -> bool:
        t = self._thread
        return bool(t is not None and t.is_alive())

    def _monitor(self) -> None:
        telemetry.name_thread("fleet-supervisor")
        while not self._stop.wait(self.poll_interval):
            self.ticks += 1
            try:
                self._fleet._tick()
            except Exception as e:
                # a failing tick must not kill supervision: count it, log
                # it, keep ticking (the NEXT tick may be the one that
                # restarts the crashed replica)
                self.tick_errors += 1
                telemetry.counter("Fleet/supervisor_errors").inc()
                logger.error("fleet supervisor tick failed: %r", e)
