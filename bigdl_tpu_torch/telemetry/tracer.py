"""Span tracer: thread-safe, allocation-light timeline capture
(``bigdl_tpu/telemetry/tracer.py``).

The trainers' loop, the streaming-ingest stage threads, the prefetcher's
fetch and transfer threads and the asynchronous checkpoint writer mark
their work with :func:`span` context managers.  Each thread appends
finished spans to its OWN bounded ring (the global lock is taken once per
thread, at ring registration), and :func:`export_chrome_trace` merges every
ring into one Chrome trace-event JSON (the ``chrome://tracing`` / Perfetto
format), one lane per thread.

Cost: disarmed, ``span()`` is one dict load plus a shared no-op context
manager, no clock read and no allocation.  Armed, a span costs two
``monotonic_ns`` reads and one tuple append into a ``deque(maxlen=...)``.
Spans never touch a tensor, so arming the tracer adds no host-device
synchronisation.  Nothing is armed at import: :func:`arm` or
``bigdl.telemetry.trace`` (:func:`maybe_arm_from_config`) does it.

:func:`clock_ns` is the one clock of the hot paths, so two subsystems'
timestamps lie on one timeline.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional
from bigdl_tpu_torch.analysis.lockwitness import make_lock

#: the one hot-path clock: monotonic (immune to wall-clock steps), ns
#: resolution, same epoch as ``time.monotonic()`` (fractional seconds
#: from legacy call sites convert with a multiply).
clock_ns = time.monotonic_ns

DEFAULT_RING_SIZE = 65536

#: retained per-thread rings; beyond this the oldest DEAD thread's ring
#: is evicted (a long pytest session spawns thousands of short-lived
#: ingest/prefetch threads — their rings must not accumulate forever)
MAX_RINGS = 256

_LOCK = make_lock("telemetry.tracer")
_TLS = threading.local()

# armed flag + ring size live in a plain dict: one dict load on the
# disarmed fast path, no attribute-protocol indirection
_STATE: Dict[str, Any] = {"enabled": False,
                          "ring_size": DEFAULT_RING_SIZE,
                          "epoch_ns": 0}

_RINGS: "List[_ThreadRing]" = []
_LANE_SEQ = [0]


class _ThreadRing:
    """One thread's span ring.  ``lane`` is a registration-ordered id
    (thread idents are recycled by the OS; lanes must stay distinct in
    the exported trace), ``events`` holds finished spans as
    ``(name, t0_ns, t1_ns, args)`` tuples — ``t1_ns is None`` marks an
    instant event."""

    __slots__ = ("lane", "name", "thread", "events")

    def __init__(self, lane: int, name: str, thread: threading.Thread,
                 maxlen: int):
        self.lane = lane
        self.name = name
        self.thread = thread
        self.events: deque = deque(maxlen=maxlen)


def _tls_ring() -> _ThreadRing:
    ring = getattr(_TLS, "ring", None)
    if ring is None:
        t = threading.current_thread()
        with _LOCK:
            _LANE_SEQ[0] += 1
            ring = _ThreadRing(_LANE_SEQ[0], t.name, t,
                               _STATE["ring_size"])
            _RINGS.append(ring)
            if len(_RINGS) > MAX_RINGS:
                for i, r in enumerate(_RINGS):
                    if not r.thread.is_alive():
                        del _RINGS[i]
                        break
                else:
                    _RINGS.pop(0)
        _TLS.ring = ring
    return ring


class _NullSpan:
    """Shared no-op context manager: the disarmed ``span()`` result."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "args", "t0")

    def __init__(self, name: str, args: Optional[dict]):
        self.name = name
        self.args = args

    def __enter__(self):
        self.t0 = clock_ns()
        return self

    def __exit__(self, *exc):
        _tls_ring().events.append((self.name, self.t0, clock_ns(),
                                   self.args))
        return False


def tracing_enabled() -> bool:
    return _STATE["enabled"]


def arm(ring_size: Optional[int] = None) -> None:
    """Switch span capture on.  ``ring_size`` bounds each thread's event
    ring (oldest spans fall off first); already-registered rings keep
    their size."""
    with _LOCK:
        if ring_size is not None:
            _STATE["ring_size"] = int(ring_size)
        if not _STATE["enabled"]:
            _STATE["epoch_ns"] = clock_ns()
        _STATE["enabled"] = True


def disarm() -> None:
    _STATE["enabled"] = False


def maybe_arm_from_config() -> bool:
    """Arm iff ``bigdl.telemetry.trace`` is set truthy; never disarms
    (an explicit :func:`arm` — e.g. the test suite's — wins).  Returns
    the resulting enabled state."""
    from bigdl_tpu_torch.utils import config
    if config.get_bool("bigdl.telemetry.trace", False):
        arm(ring_size=config.get_int("bigdl.telemetry.ringSize",
                                     DEFAULT_RING_SIZE))
    return _STATE["enabled"]


def reset() -> None:
    """Drop every captured span (rings stay registered, lanes keep their
    ids).  Test isolation; also the start-of-run hook so one process's
    second training run exports only its own timeline."""
    with _LOCK:
        for ring in _RINGS:
            ring.events.clear()
        _STATE["epoch_ns"] = clock_ns()


def span(name: str, **args):
    """``with telemetry.span("optim/device_step"): ...`` — record the
    enclosed wall interval on this thread's lane.  Free when disarmed."""
    if not _STATE["enabled"]:
        return _NULL_SPAN
    return _Span(name, args or None)


def add_span(name: str, t0_ns: int, t1_ns: int,
             args: Optional[dict] = None) -> None:
    """Record an already-measured interval (both endpoints from
    :func:`clock_ns`).  For call sites that time work anyway (the ingest
    stage counters): no extra clock reads."""
    if _STATE["enabled"]:
        _tls_ring().events.append((name, t0_ns, t1_ns, args))


def add_span_s(name: str, t0_s: float, t1_s: float,
               args: Optional[dict] = None) -> None:
    """:func:`add_span` for endpoints measured with ``time.monotonic()``
    (fractional seconds, same epoch as the ns clock)."""
    if _STATE["enabled"]:
        _tls_ring().events.append((name, int(t0_s * 1e9), int(t1_s * 1e9),
                                   args))


def instant(name: str, **args) -> None:
    """A zero-duration marker on this thread's lane (slow-step flags,
    epoch rollovers)."""
    if _STATE["enabled"]:
        _tls_ring().events.append((name, clock_ns(), None, args or None))


def name_thread(name: str) -> None:
    """Name the current thread's lane in the exported trace (threads
    that were not created with a telling ``Thread(name=...)``)."""
    ring = _tls_ring()
    ring.name = name


def events() -> List[dict]:
    """Every captured span as dicts (diagnostics / tests)."""
    out = []
    with _LOCK:
        rings = [(r.lane, r.name, list(r.events)) for r in _RINGS]
    for lane, lname, evs in rings:
        for name, t0, t1, args in evs:
            out.append({"lane": lane, "thread": lname, "name": name,
                        "t0_ns": t0, "t1_ns": t1, "args": args})
    return out


def export_chrome_trace(path: Optional[str] = None) -> dict:
    """Merge every thread ring into one Chrome trace-event JSON object
    (``{"traceEvents": [...], "displayTimeUnit": "ms"}``), optionally
    written to ``path``.  Loadable by Perfetto / ``chrome://tracing``:
    ``X`` (complete) events carry ``ts``/``dur`` in microseconds relative
    to the arm time, ``M`` metadata events name the process and one lane
    per thread, ``i`` events are instants."""
    epoch = _STATE["epoch_ns"]
    trace_events: List[dict] = [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "bigdl_tpu_torch"}},
    ]
    with _LOCK:
        rings = [(r.lane, r.name, list(r.events)) for r in _RINGS
                 if r.events]
    for lane, lname, evs in rings:
        trace_events.append({"ph": "M", "name": "thread_name", "pid": 0,
                             "tid": lane, "args": {"name": lname}})
        trace_events.append({"ph": "M", "name": "thread_sort_index",
                             "pid": 0, "tid": lane,
                             "args": {"sort_index": lane}})
        for name, t0, t1, args in evs:
            ev = {"ph": "X" if t1 is not None else "i",
                  "name": name, "cat": name.split("/", 1)[0],
                  "pid": 0, "tid": lane,
                  "ts": (t0 - epoch) / 1e3}
            if t1 is not None:
                ev["dur"] = max(t1 - t0, 0) / 1e3
            else:
                ev["s"] = "t"
            if args:
                ev["args"] = args
            trace_events.append(ev)
    # per-request lanes (telemetry/request_trace.py) merge into the same
    # timeline under their own "requests" process row; lazy import —
    # request_trace imports this module at its top
    from bigdl_tpu_torch.telemetry import request_trace
    trace_events.extend(request_trace.chrome_events(epoch))
    doc = {"traceEvents": trace_events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc
