"""Metrics registry: one naming scheme, one flush path for every counter
(``bigdl_tpu/telemetry/metrics.py``).

- :class:`Counter` (monotonic), :class:`Gauge` (set-to-latest) and
  :class:`Histogram` (count/sum/min/max, exact percentiles over a bounded
  window, cumulative Prometheus buckets and exemplar trace ids), each with
  optional ``{label: value}`` labels;
- metrics created with ``summary=True`` are charted: the trainers' ONE
  emission loop (``Optimizer._summarize_train``) walks
  :meth:`MetricsRegistry.summary_scalars` and writes each pair as a
  TrainSummary scalar under its registry name, which is the TensorBoard
  tag;
- subsystems whose values are snapshots of live state (the ingest engine's
  per-stage throughput) register a *provider* callable, which the same
  loop pulls;
- :meth:`~MetricsRegistry.snapshot` serialises everything to the per-run
  ``telemetry.json``; :meth:`~MetricsRegistry.prometheus_text` renders the
  same data in the Prometheus text format.

``REGISTRY`` is this package's own table (the JAX package's is another
object), empty at import.  Thread safety: one registry lock around the name
table; each metric carries its own lock.
"""

from __future__ import annotations

import bisect
import json
import logging
import math
import re
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple
from bigdl_tpu_torch.analysis.lockwitness import make_lock

logger = logging.getLogger("bigdl_tpu_torch")

#: unbounded label cardinality is a slow host-memory leak (and a
#: Prometheus scrape bomb): past this many labeled variants of one base
#: name, further variants fold into a single ``{overflow="true"}``
#: series instead of minting new ones
MAX_LABEL_VARIANTS = 64


def _label_key(name: str, labels: Optional[dict]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Prometheus metric names cannot carry ``/``-style paths; fold every
    illegal character to ``_`` (``Ingest/read/throughput`` →
    ``Ingest_read_throughput``)."""
    return _PROM_BAD.sub("_", name)


def _prom_escape(value) -> str:
    """Label-VALUE escaping per the exposition format: backslash, double
    quote, and newline must be escaped inside ``{k="v"}``."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


#: default histogram bucket upper bounds — a log-ish ladder sized for the
#: millisecond-latency histograms this registry actually holds
#: (``Serving/latency_ms``, ``LM/ttft_ms``, ``Telemetry/step_latency_ms``);
#: the +Inf bucket is implicit
DEFAULT_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                   500.0, 1000.0, 2500.0, 5000.0, 10000.0)

#: exemplar trace ids retained per histogram: the K largest observations
#: that carried one (tail-bucket forensics — "show me a p99 request")
MAX_EXEMPLARS = 8


class _Metric:
    kind = "metric"

    def __init__(self, name: str, labels: Optional[dict], summary: bool,
                 help: str = ""):
        self.name = name
        self.labels = dict(labels) if labels else None
        self.summary = summary
        self.help = help
        self._lock = make_lock("telemetry.metric")


class Counter(_Metric):
    """Monotonically increasing count (items decoded, slow steps, …)."""

    kind = "counter"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._value = 0.0

    def inc(self, value: float = 1.0) -> None:
        with self._lock:
            self._value += value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Metric):
    """Set-to-latest value (ring occupancy, current decomposition ms)."""

    kind = "gauge"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, value: float = 1.0) -> None:
        with self._lock:
            self._value += value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Metric):
    """Streaming distribution: exact count/sum/min/max over the full
    stream plus exact percentiles over the most recent ``window``
    observations (the rolling-window estimator the step-latency
    p50/p95/p99 ride on — see :class:`~bigdl_tpu_torch.telemetry.
    step_stats.WindowedPercentiles` for the standalone form).  Also keeps
    Prometheus-conformant cumulative bucket counts (fixed ``le`` ladder
    plus the implicit ``+Inf``) and bounded **exemplars**: observations
    tagged with a request trace id retain the ``MAX_EXEMPLARS`` largest
    ``(value, trace_id)`` pairs, so a tail-bucket latency resolves to a
    real request in one lookup (:meth:`tail_exemplar`)."""

    kind = "histogram"

    def __init__(self, name, labels=None, summary=False, help="",
                 window: int = 512, buckets=DEFAULT_BUCKETS):
        super().__init__(name, labels, summary, help)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._window: deque = deque(maxlen=max(1, int(window)))
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # one slot per finite bound + the +Inf slot; rendered cumulative
        self._bucket_counts = [0] * (len(self.buckets) + 1)
        self._exemplars: List[Tuple[float, str]] = []

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        value = float(value)
        with self._lock:
            self.count += 1
            self.sum += value
            self.min = min(self.min, value)
            self.max = max(self.max, value)
            self._window.append(value)
            self._bucket_counts[bisect.bisect_left(self.buckets,
                                                   value)] += 1
            if exemplar is not None:
                self._exemplars.append((value, exemplar))
                if len(self._exemplars) > MAX_EXEMPLARS:
                    self._exemplars.sort(key=lambda p: p[0], reverse=True)
                    del self._exemplars[MAX_EXEMPLARS:]

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """Cumulative ``(le_bound, count)`` pairs, ``math.inf`` last —
        exactly what the ``_bucket{le=...}`` series render."""
        with self._lock:
            raw = list(self._bucket_counts)
        out, running = [], 0
        for bound, n in zip(self.buckets + (math.inf,), raw):
            running += n
            out.append((bound, running))
        return out

    def exemplars(self) -> List[Tuple[float, str]]:
        """Retained ``(value, trace_id)`` pairs, largest value first."""
        with self._lock:
            return sorted(self._exemplars, key=lambda p: p[0],
                          reverse=True)

    def tail_exemplar(self) -> Optional[str]:
        """The trace id of the largest observation that carried one —
        the "show me a p99 request" entry point."""
        ex = self.exemplars()
        return ex[0][1] if ex else None

    def percentile(self, q: float) -> float:
        """Exact percentile (numpy's linear interpolation) over the
        retained window; NaN before the first observation."""
        import numpy as np
        with self._lock:
            if not self._window:
                return float("nan")
            return float(np.percentile(np.asarray(self._window), q))

    @property
    def value(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0

    def stats(self) -> dict:
        with self._lock:
            if not self.count:
                return {"count": 0, "sum": 0.0}
            out = {"count": self.count, "sum": self.sum,
                   "min": self.min, "max": self.max,
                   "mean": self.sum / self.count}
            exemplars = sorted(self._exemplars, key=lambda p: p[0],
                               reverse=True)
        for q in (50, 95, 99):
            out[f"p{q}"] = self.percentile(q)
        if exemplars:
            out["exemplars"] = [[v, tid] for v, tid in exemplars]
        return out


class MetricsRegistry:
    """The process-wide metric table (module singleton ``REGISTRY``)."""

    def __init__(self):
        self._lock = make_lock("telemetry.registry")
        self._metrics: "Dict[str, _Metric]" = {}
        self._providers: "Dict[str, Callable[[], Iterable[Tuple[str, float]]]]" = {}
        self._label_variants: Dict[str, int] = {}
        self._overflow_logged: set = set()

    # ---- creation (get-or-create, keyed on name + labels) ---------------

    def _get_or_create(self, cls, name: str, labels: Optional[dict],
                       summary: bool, help: str, **kw) -> _Metric:
        key = _label_key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None and labels and (
                    self._label_variants.get(name, 0) >=
                    MAX_LABEL_VARIANTS):
                # cardinality cap: fold this NEW variant into the
                # overflow series (existing variants keep updating)
                labels = {"overflow": "true"}
                key = _label_key(name, labels)
                m = self._metrics.get(key)
                if name not in self._overflow_logged:
                    self._overflow_logged.add(name)
                    logger.warning(
                        "metric %r reached %d label variants — further "
                        "variants fold into its {overflow=\"true\"} "
                        "series", name, MAX_LABEL_VARIANTS)
            if m is None:
                m = cls(name, labels=labels, summary=summary, help=help,
                        **kw)
                self._metrics[key] = m
                if labels:
                    self._label_variants[name] = (
                        self._label_variants.get(name, 0) + 1)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {key!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            if summary:
                m.summary = True
            return m

    def counter(self, name: str, labels: Optional[dict] = None,
                summary: bool = False, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, labels, summary, help)

    def gauge(self, name: str, labels: Optional[dict] = None,
              summary: bool = False, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, labels, summary, help)

    def histogram(self, name: str, labels: Optional[dict] = None,
                  summary: bool = False, help: str = "",
                  window: int = 512) -> Histogram:
        return self._get_or_create(Histogram, name, labels, summary, help,
                                   window=window)

    # ---- providers -------------------------------------------------------

    def register_provider(
            self, name: str,
            fn: Callable[[], Iterable[Tuple[str, float]]]) -> None:
        """Register a pull-mode scalar source: ``fn()`` yields
        ``(tag, value)`` pairs when the summary loop (or a snapshot)
        asks.  Re-registering a name replaces the provider (module
        reloads in tests)."""
        with self._lock:
            self._providers[name] = fn

    def unregister_provider(self, name: str) -> None:
        with self._lock:
            self._providers.pop(name, None)

    # ---- the one flush path ---------------------------------------------

    def summary_scalars(self) -> List[Tuple[str, float]]:
        """Every chartable ``(tag, value)`` pair: summary-flagged metrics
        (labels folded into the tag) followed by every provider's pairs.
        THE single emission loop in the driver iterates exactly this."""
        with self._lock:
            metrics = list(self._metrics.items())
            providers = list(self._providers.values())
        out: List[Tuple[str, float]] = []
        for key, m in metrics:
            if m.summary:
                out.append((key, m.value))
        for fn in providers:
            out.extend(fn())
        return out

    def snapshot(self) -> dict:
        """JSON-serializable dump of the whole registry (the per-run
        ``telemetry.json`` artifact).  Round-trips through
        ``json.dumps``/``loads`` unchanged."""
        with self._lock:
            metrics = list(self._metrics.items())
            providers = list(self._providers.items())
        counters, gauges, histograms = {}, {}, {}
        for key, m in metrics:
            if isinstance(m, Histogram):
                histograms[key] = m.stats()
            elif isinstance(m, Counter):
                counters[key] = m.value
            else:
                gauges[key] = m.value
        provided = {}
        for name, fn in providers:
            provided.update({tag: float(v) for tag, v in fn()})
        return {"counters": counters, "gauges": gauges,
                "histograms": histograms, "provided": provided}

    def write_snapshot(self, path: str) -> dict:
        snap = self.snapshot()
        with open(path, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
        return snap

    def prometheus_text(self) -> str:
        """The registry in Prometheus exposition text format: names
        sanitized, label VALUES escaped (backslash / quote / newline),
        one ``# TYPE`` line per metric; histograms emit the conformant
        cumulative ``_bucket{le=...}`` series ending at ``le="+Inf"``
        plus ``_sum``/``_count``."""
        with self._lock:
            metrics = list(self._metrics.values())
            providers = list(self._providers.items())
        lines: List[str] = []
        typed: set = set()

        def fmt(name, labels, value):
            if labels:
                inner = ",".join(
                    f'{_prom_name(k)}="{_prom_escape(labels[k])}"'
                    for k in sorted(labels))
                return f"{name}{{{inner}}} {value}"
            return f"{name} {value}"

        def type_line(pname, kind, help_text):
            # one # TYPE (and at most one # HELP) per metric name even
            # when label variants share it — the format forbids repeats
            if pname in typed:
                return
            typed.add(pname)
            if help_text:
                lines.append(f"# HELP {pname} {help_text}")
            lines.append(f"# TYPE {pname} {kind}")

        for m in metrics:
            pname = _prom_name(m.name)
            type_line(pname, m.kind, m.help)
            if isinstance(m, Histogram):
                for bound, cum in m.bucket_counts():
                    labels = dict(m.labels or {})
                    labels["le"] = ("+Inf" if math.isinf(bound)
                                    else repr(bound))
                    lines.append(fmt(f"{pname}_bucket", labels, cum))
                lines.append(fmt(f"{pname}_sum", m.labels, m.sum))
                lines.append(fmt(f"{pname}_count", m.labels, m.count))
            else:
                lines.append(fmt(pname, m.labels, m.value))
        for name, fn in providers:
            for tag, v in fn():
                lines.append(fmt(_prom_name(tag), None, float(v)))
        return "\n".join(lines) + "\n"

    # ---- lifecycle -------------------------------------------------------

    def drop_prefix(self, prefix: str) -> None:
        """Remove every metric whose name starts with ``prefix`` — the
        start-of-run hook that keeps one process's second training run
        from re-emitting a previous run's ``Telemetry/*``
        gauges under stale values."""
        with self._lock:
            for key in [k for k, m in self._metrics.items()
                        if m.name.startswith(prefix)]:
                del self._metrics[key]
            for name in [n for n in self._label_variants
                         if n.startswith(prefix)]:
                del self._label_variants[name]
                self._overflow_logged.discard(name)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._providers.clear()
            self._label_variants.clear()
            self._overflow_logged.clear()


REGISTRY = MetricsRegistry()
