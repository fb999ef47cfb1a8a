"""Step-time decomposition, rolling latency percentiles, anomaly detection
and the step's FLOP count (``bigdl_tpu/telemetry/step_stats.py``).

Where does the step time go?  The trainers' loop measures, per iteration:

``data_wait``
    the loop's time blocked in the prefetcher's call (the batch queue, or
    the synchronous fetch at ``bigdl.prefetch.depth`` 0).  Interval ``i``
    spans ``t0(i) -> t0(i+1)`` and so contains iteration ``i+1``'s fetch;
    the loop charges the fetch to the interval it ran in.
``compute``
    the eager step's call: the host's time to enqueue the forward, the
    backward, the update and the divergence guard on the device (plus
    whatever the host waits for inside it, such as the caching allocator
    or a collective's wait).  The device's own time overlaps the next
    parts and is not a part of its own.
``host_pull``
    the one read of the iteration's loss on the host, which waits for the
    device to finish the step.
``bookkeeping``
    the loop's accounting around the step: the history record, the log
    line, the summary writes.
``unaccounted``
    the SIGNED residual ``wall − (data_wait + compute + host_pull +
    bookkeeping)``, so the parts sum to the wall time exactly.

Everything here runs on host floats from the tracer's clock, never on a
tensor, so the account adds no host-device synchronisation.

The JAX package reads a step's FLOPs from XLA's cost analysis of the
lowered program.  The port's step is eager, so :class:`StepFlops` counts
the first step it wraps with ``torch.utils.flop_counter.FlopCounterMode``
(matrix products and convolutions, forward and backward, as executed).  A
hand kernel is no aten operation the counter sees: its wrapper reports the
dense count of the plain path it replaces through :func:`counted_as`,
which also hides the plain path's own operations from the counter, so the
CPU (plain path) and the card (kernel) count one step the same.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Dict, List, Optional, Tuple

PARTS = ("data_wait", "compute", "host_pull", "bookkeeping")


class WindowedPercentiles:
    """Exact rolling percentiles over the most recent ``window`` samples
    (numpy linear interpolation — the estimator is *exact* over its
    window, so it degrades by forgetting, never by approximating)."""

    def __init__(self, window: int = 512):
        self._window: deque = deque(maxlen=max(1, int(window)))

    def add(self, value: float) -> None:
        self._window.append(float(value))

    def __len__(self) -> int:
        return len(self._window)

    def percentile(self, q: float) -> float:
        import numpy as np
        if not self._window:
            return float("nan")
        return float(np.percentile(np.asarray(self._window), q))

    def percentiles(self, qs=(50, 95, 99)) -> Dict[int, float]:
        import numpy as np
        if not self._window:
            return {q: float("nan") for q in qs}
        arr = np.asarray(self._window)
        return {q: float(np.percentile(arr, q)) for q in qs}


class SlowStepDetector:
    """Flag steps slower than ``factor`` x the EMA of recent steps.

    Fires at most once per *anomaly window*: the first observation over
    threshold fires, then the detector holds fire until ``cooldown``
    further observations have passed AND a step has landed back under
    threshold — a sustained stall (one long pause spanning many steps, or
    a genuine regime change) reports once, not once per step.  The first
    ``warmup`` observations are only collected; the EMA then seeds from
    their MINIMUM — compile/first-dispatch steps can only inflate a
    warmup window, so the fastest warmup step is the closest thing to a
    steady-state baseline, and ``factor`` (>= 2 in any sane config)
    absorbs the jitter above it.  ``factor <= 0`` disables.
    """

    def __init__(self, factor: float, warmup: int = 5, cooldown: int = 50,
                 alpha: float = 0.1):
        self.factor = float(factor)
        self.warmup = max(0, int(warmup))
        self.cooldown = max(0, int(cooldown))
        self.alpha = alpha
        self.ema: Optional[float] = None
        self.seen = 0
        self.fired = 0
        self._warmup_vals: List[float] = []
        self._cool = 0          # observations left before re-arm
        self._in_window = False

    @property
    def enabled(self) -> bool:
        return self.factor > 0

    def threshold(self) -> float:
        if self.ema is None:
            return math.inf
        return self.factor * self.ema

    def observe(self, value: float) -> bool:
        """Feed one step time; True iff this observation opens a new
        anomaly window (the caller should capture/dump now)."""
        if not self.enabled:
            return False
        self.seen += 1
        if self.seen <= self.warmup:
            self._warmup_vals.append(value)
            return False
        if self.ema is None:
            self.ema = (min(self._warmup_vals) if self._warmup_vals
                        else value)
        slow = value > self.factor * self.ema
        if slow:
            # anomalies do not drag the EMA up: the baseline tracks the
            # healthy regime the threshold is defined against
            fired = not self._in_window and self._cool == 0
            self._in_window = True
            if fired:
                self.fired += 1
                self._cool = self.cooldown
                return True
            return False
        if self._cool > 0:
            self._cool -= 1
        self._in_window = False
        self.ema = (value if self.ema is None
                    else (1 - self.alpha) * self.ema + self.alpha * value)
        return False


class StepAccount:
    """Per-run step accounting: decomposition gauges, rolling latency
    percentiles, and the slow-step detector — all surfaced as
    ``Telemetry/*`` registry metrics the driver's single emission loop
    charts into TrainSummary."""

    def __init__(self, window: int = 512,
                 detector: Optional[SlowStepDetector] = None):
        from bigdl_tpu_torch.telemetry.metrics import REGISTRY
        self._reg = REGISTRY
        self.detector = detector or SlowStepDetector(0.0)
        self.steps = 0
        self.totals_ns: Dict[str, float] = {p: 0.0 for p in PARTS}
        self.totals_ns["unaccounted"] = 0.0
        self.totals_ns["wall"] = 0.0
        self.last: Dict[str, float] = {}
        # the registry histogram IS the rolling wall-latency window —
        # percentile reads come from it, one copy of the samples
        self._hist = REGISTRY.histogram(
            "Telemetry/step_latency_ms", window=window,
            help="wall step time (inter-dispatch interval)")

    def account(self, wall_ns: int, **parts_ns: float) -> bool:
        """Fold one finished iteration in.  ``parts_ns`` maps any subset
        of :data:`PARTS` to nanoseconds; the signed remainder becomes
        ``unaccounted``.  Returns True when this step opened a slow-step
        anomaly window."""
        wall_ns = max(int(wall_ns), 0)
        decomp = {p: float(parts_ns.get(p, 0.0)) for p in PARTS}
        decomp["unaccounted"] = wall_ns - sum(decomp.values())
        decomp["wall"] = float(wall_ns)
        self.steps += 1
        for k, v in decomp.items():
            self.totals_ns[k] += v
        self.last = decomp
        self._hist.observe(wall_ns / 1e6)
        g = self._reg.gauge
        for p in PARTS + ("unaccounted",):
            g(f"Telemetry/{p}_ms", summary=True).set(decomp[p] / 1e6)
        g("Telemetry/step_ms", summary=True).set(wall_ns / 1e6)
        fired = self.detector.observe(float(wall_ns))
        if self.detector.enabled:
            g("Telemetry/slow_steps", summary=True).set(self.detector.fired)
        return fired

    def percentile_scalars(self) -> List[Tuple[str, float]]:
        """Rolling p50/p95/p99 wall latency in ms, as summary pairs.
        Computed lazily (one small sort per call) so runs without a
        TrainSummary never pay for it."""
        return [(f"Telemetry/step_p{q}_ms", self._hist.percentile(q))
                for q in (50, 95, 99) if self._hist.count]

    def summary(self) -> dict:
        """End-of-run roll-up (for ``telemetry.json`` / logs): mean
        decomposition shares plus latency percentiles."""
        if not self.steps:
            return {"steps": 0}
        wall = self.totals_ns["wall"] or 1.0
        out = {"steps": self.steps,
               "mean_step_ms": wall / self.steps / 1e6,
               "slow_steps": self.detector.fired}
        for p in PARTS + ("unaccounted",):
            out[f"{p}_frac"] = self.totals_ns[p] / wall
            out[f"{p}_ms_mean"] = self.totals_ns[p] / self.steps / 1e6
        st = self._hist.stats()
        for q in (50, 95, 99):
            v = st.get(f"p{q}")
            if v is not None and not math.isnan(v):
                out[f"p{q}_ms"] = v
        return out


class StepFlops:
    """``with StepFlops() as sf: step()`` counts the FLOPs of everything
    dispatched inside (the whole step, its backward included) into
    ``sf.total``; None where the counter is unavailable.  The operations
    run as they would without it: the results are the same bits."""

    def __init__(self):
        self.total: Optional[float] = None
        self._mode = None

    def __enter__(self) -> "StepFlops":
        try:
            from torch.utils.flop_counter import FlopCounterMode
            self._mode = FlopCounterMode(display=False)
        except Exception:       # noqa: BLE001 - an older torch: no count
            return self
        self._mode.__enter__()
        _COUNTERS.append(self._mode)
        return self

    def __exit__(self, *exc):
        mode = self._mode
        if mode is None:
            return False
        _COUNTERS.remove(mode)
        mode.__exit__(*exc)
        total = float(mode.get_total_flops())
        self.total = total if math.isfinite(total) and total > 0 else None
        return False


#: the flop counters of the :class:`StepFlops` blocks now open
_COUNTERS: list = []


class _Uncounted:
    __slots__ = ("_ctx",)

    def __init__(self, name: str, flops: float):
        from torch.utils._python_dispatch import _disable_current_modes
        for mode in _COUNTERS:
            mode.flop_counts["Global"][name] += int(flops)
        self._ctx = _disable_current_modes()

    def __enter__(self):
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)


class _NullCount:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_COUNT = _NullCount()


def counted_as(name: str, flops: float):
    """``with counted_as("flash_attention_fwd", 4*B*H*T*T*D): ...`` — while
    a :class:`StepFlops` block is open, add ``flops`` to its count under
    ``name`` and hide the operations inside from it; otherwise a no-op."""
    if not _COUNTERS:
        return _NULL_COUNT
    return _Uncounted(name, flops)
