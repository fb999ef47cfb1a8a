"""Replica-count autoscaling policy (``bigdl_tpu/fleet/autoscale.py``, copied
as it is: the hysteresis is pure Python) — the serving-side sibling of the
JAX package's ingest ``AutoscalePolicy``.

Pure deterministic hysteresis: no clocks, no randomness — a fixed
sequence of signal samples always produces the same action sequence, so
autoscaling can never make a fleet nondeterministic in anything but
wall-clock.  The supervisor samples two load signals per decision
interval (``bigdl.fleet.autoscale.intervalSec``):

* **queue fill fraction** — mean admission-queue depth across the
  service's replicas over their ``maxQueueDepth`` (the registry's
  queue-depth signal).  Sustained fill means admission control is about
  to shed; more replicas spread the arrival stream.
* **p99 latency vs deadline** — the ``Serving/latency_ms`` histogram's
  p99 against ``bigdl.fleet.autoscale.p99Factor`` x the service
  deadline.  A p99 brushing the deadline sheds next, even while queues
  look shallow.

``patience`` consecutive same-direction signals are required before
acting, and after an action the policy holds for ``cooldown`` intervals
so the new replica count's effect is measured before the next decision.
The host-memory governor is the upper-bound authority: under pressure
the policy never scales up and steps down toward the floor — replica
count yields to memory, not the other way around.
"""

from __future__ import annotations


class FleetAutoscalePolicy:
    """Deterministic hysteresis over (queue fill, p99 latency) producing
    +1 / -1 / 0 replica-count actions.  See the module docstring for the
    signal semantics."""

    def __init__(self, min_replicas: int, max_replicas: int,
                 up_queue_frac: float, down_queue_frac: float,
                 p99_factor: float, patience: int, cooldown: int):
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.up_queue_frac = float(up_queue_frac)
        self.down_queue_frac = float(down_queue_frac)
        self.p99_factor = float(p99_factor)
        self.patience = max(1, int(patience))
        self.cooldown = max(0, int(cooldown))
        self._up_streak = 0
        self._down_streak = 0
        self._hold = 0

    def decide(self, queue_frac: float, p99_ms: float, deadline_ms: float,
               replicas: int, under_pressure: bool = False) -> int:
        """One interval's decision: +1 add a replica, -1 retire one, 0
        hold.  ``p99_ms`` may be 0.0 when the latency histogram has no
        samples yet (an idle service never scales on latency)."""
        if self._hold > 0:
            self._hold -= 1
            return 0
        hot_p99 = (deadline_ms > 0 and p99_ms > 0 and
                   p99_ms >= self.p99_factor * deadline_ms)
        down = (replicas > self.min_replicas and
                (under_pressure or
                 (queue_frac <= self.down_queue_frac and not hot_p99)))
        up = (not down and not under_pressure and
              replicas < self.max_replicas and
              (queue_frac >= self.up_queue_frac or hot_p99))
        if up:
            self._up_streak += 1
            self._down_streak = 0
        elif down:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._down_streak = 0
        if self._up_streak >= self.patience:
            self._up_streak = 0
            self._hold = self.cooldown
            return 1
        if self._down_streak >= self.patience:
            self._down_streak = 0
            self._hold = self.cooldown
            return -1
        return 0
