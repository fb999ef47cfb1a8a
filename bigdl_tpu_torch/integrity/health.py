"""Weight-health monitor: EMA anomaly gates over integrity series
(``bigdl_tpu/integrity/health.py``).

The gradient norm and the update ratio cross their healthy band many
iterations before the first NaN reaches the divergence guard.  Each series
feeds a :class:`~bigdl_tpu_torch.telemetry.SlowStepDetector` (EMA seeded
from the warmup's minimum, one fire per anomaly window with a cooldown,
``factor <= 0`` disables, anomalies never drag the EMA up).  A fire is a
flag, not a fault: it logs, bumps ``Integrity/health_anomalies`` and leaves
the run alone.
"""

from __future__ import annotations

import logging
import math
from typing import Dict

from bigdl_tpu_torch import telemetry

logger = logging.getLogger("bigdl_tpu_torch")


class WeightHealthMonitor:
    """One anomaly gate per named series (``grad_norm``, ``update_ratio``,
    per-bucket ratios), created at the series' first observation."""

    def __init__(self, factor: float, warmup: int = 5, cooldown: int = 50):
        self.factor = float(factor)
        self.warmup = int(warmup)
        self.cooldown = int(cooldown)
        self._gates: Dict[str, telemetry.SlowStepDetector] = {}
        self.anomalies = 0

    @property
    def enabled(self) -> bool:
        return self.factor > 0

    def observe(self, series: str, value: float, iteration: int) -> bool:
        """Feed one observation; True iff it opened a new anomaly window.
        Non-finite values are ignored: the divergence guard owns them."""
        if not self.enabled or not math.isfinite(value):
            return False
        gate = self._gates.get(series)
        if gate is None:
            gate = telemetry.SlowStepDetector(
                self.factor, warmup=self.warmup, cooldown=self.cooldown)
            self._gates[series] = gate
        fired = gate.observe(value)
        if fired:
            self.anomalies += 1
            telemetry.counter(
                "Integrity/health_anomalies",
                help="weight-health EMA gates fired (finite but "
                     "exploding state)").inc()
            logger.warning(
                "Weight-health anomaly at iteration %d: %s = %.3e (> %.1fx "
                "the healthy EMA %.3e) - state is finite but trending away "
                "from its baseline; a divergence guard fire may follow",
                iteration, series, value, self.factor,
                gate.ema if gate.ema else float("nan"))
        return fired
