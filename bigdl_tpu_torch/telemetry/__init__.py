"""Runtime telemetry of the port (``bigdl_tpu/telemetry``): span tracer,
step-time account, metrics registry, request traces and the incident
recorder.

1. **Span tracer** (:mod:`~bigdl_tpu_torch.telemetry.tracer`) —
   ``with telemetry.span("driver/device_step"): ...`` writes to per-thread
   rings; :func:`export_chrome_trace` merges the trainers' loop
   (``driver``), the prefetcher's fetch and transfer threads, every
   ``StreamingIngest`` stage thread and the asynchronous checkpoint writer
   into one Perfetto-loadable timeline.
2. **Step-time account** (:mod:`~bigdl_tpu_torch.telemetry.step_stats`) —
   every training step split into data-wait / compute / host-pull /
   bookkeeping plus a signed ``unaccounted`` residual, as ``Telemetry/*``
   TrainSummary scalars with rolling p50/p95/p99; a slow-step detector;
   the step's FLOP count for ``Telemetry/mfu`` (:class:`StepFlops`).
3. **Metrics registry** (:mod:`~bigdl_tpu_torch.telemetry.metrics`) —
   counters, gauges and histograms, ONE summary flush path, the per-run
   ``telemetry.json`` snapshot and a Prometheus text dump.

Two forensic layers ride on them: per-request tracing
(:mod:`~bigdl_tpu_torch.telemetry.request_trace`) and the incident flight
recorder (:mod:`~bigdl_tpu_torch.telemetry.incident`).

The names are the JAX package's (``bigdl_tpu/telemetry/__init__.py``
:45-92), with :class:`StepFlops` and :func:`counted_as` in place of
``step_flops``, which reads XLA's cost analysis.  Every object here is this
package's own, and nothing is armed at import: configuration
(``bigdl.telemetry.*``, ``bigdl.trace.*``, ``bigdl.incident.*`` in
``utils/config.py``) or an explicit ``arm()`` arms them.
"""

from __future__ import annotations

from bigdl_tpu_torch.telemetry.tracer import (add_span, add_span_s, arm,
                                              clock_ns, disarm, events,
                                              export_chrome_trace, instant,
                                              maybe_arm_from_config,
                                              name_thread, span,
                                              tracing_enabled)
from bigdl_tpu_torch.telemetry.tracer import reset as reset_tracer
from bigdl_tpu_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                               MetricsRegistry, REGISTRY)
from bigdl_tpu_torch.telemetry.step_stats import (PARTS, SlowStepDetector,
                                                  StepAccount, StepFlops,
                                                  WindowedPercentiles,
                                                  counted_as)
from bigdl_tpu_torch.telemetry import incident, request_trace


def counter(name, labels=None, summary=False, help=""):
    """Shorthand for ``REGISTRY.counter(...)``."""
    return REGISTRY.counter(name, labels=labels, summary=summary, help=help)


def gauge(name, labels=None, summary=False, help=""):
    """Shorthand for ``REGISTRY.gauge(...)``."""
    return REGISTRY.gauge(name, labels=labels, summary=summary, help=help)


def histogram(name, labels=None, summary=False, help="", window=512):
    """Shorthand for ``REGISTRY.histogram(...)``."""
    return REGISTRY.histogram(name, labels=labels, summary=summary,
                              help=help, window=window)


def summary_scalars():
    """The one flush path: every chartable ``(tag, value)`` pair."""
    return REGISTRY.summary_scalars()


__all__ = [
    # tracer
    "span", "instant", "add_span", "add_span_s", "clock_ns", "arm",
    "disarm", "tracing_enabled", "maybe_arm_from_config", "name_thread",
    "events", "export_chrome_trace", "reset_tracer",
    # metrics
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram", "summary_scalars",
    # step stats
    "PARTS", "StepAccount", "WindowedPercentiles", "SlowStepDetector",
    "StepFlops", "counted_as",
    # per-request tracing + incident flight recorder
    "request_trace", "incident",
]
