"""Per-request tracing: every request explains itself
(``bigdl_tpu/telemetry/request_trace.py``).

The serving engines classify every submission into ``completed + shed +
rejected + quarantined == submitted``; this module gives each submission
an identity:

- :func:`mint` assigns a trace id at the admission door
  (``ServingEngine.submit`` and ``LMServingEngine.submit``);
- :func:`record_span` / :func:`span` accumulate a causally ordered span
  chain per request (``request/admit``, ``request/queue_wait``,
  ``request/coalesce``, ``request/dispatch``, ``request/prefill``,
  ``request/decode_step``, ``request/emit`` …) and mirror each span onto
  the tracer's per-thread rings (:mod:`~bigdl_tpu_torch.telemetry.tracer`);
- :func:`verdict` records the request's terminal outcome exactly once
  (first wins), stamps the trace id onto the structured error
  (``error.trace_id``) and counts it under ``Trace/verdicts``;
- :func:`chrome_events` merges every traced request into
  :func:`~bigdl_tpu_torch.telemetry.tracer.export_chrome_trace` as a
  ``request:<id>`` lane under a ``requests`` process row.

The ``Serving/latency_ms`` and ``LM/*`` histograms keep the trace ids of
their largest observations as exemplars, so "show me a p99 request" is
``hist.tail_exemplar()`` → :func:`get`.

Disarmed (the state at import; ``bigdl.trace.requests`` or :func:`arm`
arms it), :func:`mint` returns ``None`` and every recorder no-ops on a
``None`` id.  At most ``bigdl.trace.maxTraces`` traces are kept (oldest
evicted first) and at most ``bigdl.trace.maxSpansPerTrace`` spans per trace
(then the trace is flagged ``truncated``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional

from bigdl_tpu_torch.telemetry import tracer
from bigdl_tpu_torch.telemetry.metrics import REGISTRY
from bigdl_tpu_torch.analysis.lockwitness import make_lock

DEFAULT_MAX_TRACES = 2048
DEFAULT_MAX_SPANS = 512

#: terminal outcomes a trace may end in — the serving taxonomy's
#: ``OUTCOMES`` plus the fleet-side ``aborted`` (replica crash /
#: abandoned handle)
VERDICTS = ("completed", "shed", "rejected", "quarantined", "aborted")

_LOCK = make_lock("telemetry.request_trace")

# armed flag + bounds in a plain dict: one dict load on the disarmed
# fast path (same idiom as tracer._STATE)
_STATE: Dict[str, Any] = {"enabled": False,
                          "max_traces": DEFAULT_MAX_TRACES,
                          "max_spans": DEFAULT_MAX_SPANS}

_SEQ = [0]
_TRACES: "OrderedDict[str, _Trace]" = OrderedDict()

#: labeled-counter cache: the registry lookup (name + label variant)
#: costs ~10x the increment itself, so the admission/verdict hot paths
#: resolve each (metric, label) pair once.  Cleared by :func:`reset`
#: (which every test teardown calls), so a registry reset in a test
#: cannot leave a detached counter past the test that did it.
_COUNTERS: Dict[tuple, Any] = {}


def _counter(name: str, label_key: str, label_val: str, help: str):
    key = (name, label_val)
    c = _COUNTERS.get(key)
    if c is None:
        c = REGISTRY.counter(name, labels={label_key: label_val},
                             help=help)
        _COUNTERS[key] = c
    return c


class _Trace:
    """One request's record.  ``spans`` holds ``(name, t0_ns, t1_ns,
    args)`` tuples (``t1_ns is None`` marks an instant); appends are
    GIL-atomic so recorders on batcher/decode threads never take the
    registry lock on the hot path."""

    __slots__ = ("trace_id", "seq", "kind", "created_ns", "attrs",
                 "spans", "verdict", "error", "reason", "truncated")

    def __init__(self, trace_id: str, seq: int, kind: str,
                 created_ns: int, attrs: Optional[dict]):
        self.trace_id = trace_id
        self.seq = seq
        self.kind = kind
        self.created_ns = created_ns
        self.attrs = attrs
        self.spans: List[tuple] = []
        self.verdict: Optional[str] = None
        self.error: Optional[str] = None
        self.reason: Optional[str] = None
        self.truncated = False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _ReqSpan:
    __slots__ = ("trace_id", "name", "args", "t0")

    def __init__(self, trace_id: str, name: str, args: Optional[dict]):
        self.trace_id = trace_id
        self.name = name
        self.args = args

    def __enter__(self):
        self.t0 = tracer.clock_ns()
        return self

    def __exit__(self, *exc):
        record_span(self.trace_id, self.name, self.t0, tracer.clock_ns(),
                    **(self.args or {}))
        return False


# ---- arming ----------------------------------------------------------------

def enabled() -> bool:
    return _STATE["enabled"]


def arm(max_traces: Optional[int] = None,
        max_spans: Optional[int] = None) -> None:
    """Switch per-request trace capture on.  Bounds default to the
    ``bigdl.trace.maxTraces`` / ``bigdl.trace.maxSpansPerTrace``
    configuration when not given explicitly."""
    from bigdl_tpu_torch.utils import config
    with _LOCK:
        _STATE["max_traces"] = int(
            max_traces if max_traces is not None else
            config.get_int("bigdl.trace.maxTraces", DEFAULT_MAX_TRACES))
        _STATE["max_spans"] = int(
            max_spans if max_spans is not None else
            config.get_int("bigdl.trace.maxSpansPerTrace",
                           DEFAULT_MAX_SPANS))
        _STATE["enabled"] = True


def disarm() -> None:
    _STATE["enabled"] = False


def maybe_arm_from_config() -> bool:
    """Arm iff ``bigdl.trace.requests`` is set truthy; never disarms
    (an explicit :func:`arm` wins).  Returns the resulting state."""
    from bigdl_tpu_torch.utils import config
    if config.get_bool("bigdl.trace.requests", False):
        arm()
    return _STATE["enabled"]


def reset() -> None:
    """Drop every retained trace (test isolation / start-of-run)."""
    with _LOCK:
        _TRACES.clear()
        _COUNTERS.clear()


# ---- recording -------------------------------------------------------------

def mint(kind: str = "req", **attrs) -> Optional[str]:
    """Assign a trace id at the admission door.  Returns ``None`` when
    request tracing is disarmed — every recorder below no-ops on
    ``None``, so call sites thread the id unconditionally."""
    if not _STATE["enabled"]:
        return None
    now = tracer.clock_ns()
    with _LOCK:
        _SEQ[0] += 1
        seq = _SEQ[0]
        trace_id = f"{kind}-{seq:06d}"
        _TRACES[trace_id] = _Trace(trace_id, seq, kind, now, attrs or None)
        while len(_TRACES) > _STATE["max_traces"]:
            _TRACES.popitem(last=False)
    _counter("Trace/minted", "kind", kind,
             "request trace ids minted at admission").inc()
    return trace_id


def record_span(trace_id: Optional[str], name: str, t0_ns: int,
                t1_ns: Optional[int], **args) -> None:
    """Append one causally-ordered span to ``trace_id``'s chain and
    mirror it onto this thread's tracer ring (tagged with the id so the
    thread lanes and the ``request:`` lane cross-reference)."""
    if trace_id is None:
        return
    tr = _TRACES.get(trace_id)
    if tr is None:
        return
    if len(tr.spans) < _STATE["max_spans"]:
        tr.spans.append((name, t0_ns, t1_ns, args or None))
    else:
        tr.truncated = True
    if tracer.tracing_enabled():    # skip the args-dict build when the
        tracer.add_span(name, t0_ns, t1_ns,   # thread rings are off
                        dict(args, trace_id=trace_id))


def instant(trace_id: Optional[str], name: str, **args) -> None:
    """A zero-duration marker on the trace (admission, verdict …)."""
    record_span(trace_id, name, tracer.clock_ns(), None, **args)


def span(trace_id: Optional[str], name: str, **args):
    """``with request_trace.span(tid, "request/dispatch"): ...`` —
    free when disarmed or untraced."""
    if trace_id is None or not _STATE["enabled"]:
        return _NULL_SPAN
    return _ReqSpan(trace_id, name, args or None)


def tag_error(error: Optional[BaseException],
              trace_id: Optional[str]) -> None:
    """Stamp the trace id onto a structured error so every
    ``Overloaded``/``DeadlineExceeded``/… carries its request identity
    to whoever catches it."""
    if error is None or trace_id is None:
        return
    try:
        error.trace_id = trace_id
    except AttributeError:      # __slots__-restricted exception
        pass


def verdict(trace_id: Optional[str], outcome: str,
            error: Optional[BaseException] = None,
            reason: Optional[str] = None) -> bool:
    """Record the request's terminal verdict — exactly once (first
    wins, mirroring the engines' ``_finish`` discipline).  Returns True
    when this call was the one that terminated the trace."""
    tag_error(error, trace_id)
    if trace_id is None:
        return False
    tr = _TRACES.get(trace_id)
    if tr is None:
        return False
    with _LOCK:
        if tr.verdict is not None:
            return False
        tr.verdict = outcome
        tr.error = repr(error) if error is not None else None
        tr.reason = reason
    args = {"outcome": outcome}
    if reason:
        args["reason"] = reason
    record_span(trace_id, "request/verdict", tracer.clock_ns(), None,
                **args)
    _counter("Trace/verdicts", "outcome", outcome,
             "terminal request verdicts recorded").inc()
    return True


# ---- reading ---------------------------------------------------------------

def _as_dict(tr: _Trace) -> dict:
    spans = [{"name": name, "t0_ns": t0, "t1_ns": t1, "args": args}
             for name, t0, t1, args in
             sorted(list(tr.spans), key=lambda s: s[1])]
    return {"trace_id": tr.trace_id, "kind": tr.kind,
            "created_ns": tr.created_ns, "attrs": tr.attrs,
            "verdict": tr.verdict, "error": tr.error,
            "reason": tr.reason, "truncated": tr.truncated,
            "spans": spans}


def get(trace_id: Optional[str]) -> Optional[dict]:
    """The request's causally-ordered span chain (spans sorted by start
    time) plus its terminal verdict, as one JSON-serializable dict."""
    if trace_id is None:
        return None
    tr = _TRACES.get(trace_id)
    if tr is None:
        return None
    with _LOCK:
        return _as_dict(tr)


def traces() -> List[dict]:
    """Every retained trace (diagnostics / the incident bundle)."""
    with _LOCK:
        return [_as_dict(tr) for tr in _TRACES.values()]


def chrome_events(epoch_ns: int) -> List[dict]:
    """Every traced request as a ``request:<id>`` lane under its own
    ``requests`` process row — merged by
    :func:`~bigdl_tpu_torch.telemetry.tracer.export_chrome_trace`."""
    with _LOCK:
        recs = [(tr.seq, tr.trace_id, tr.verdict, list(tr.spans))
                for tr in _TRACES.values() if tr.spans]
    if not recs:
        return []
    out: List[dict] = [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
         "args": {"name": "requests"}},
    ]
    for seq, trace_id, final, spans in recs:
        lane_name = f"request:{trace_id}"
        if final:
            lane_name += f" [{final}]"
        out.append({"ph": "M", "name": "thread_name", "pid": 1,
                    "tid": seq, "args": {"name": lane_name}})
        for name, t0, t1, args in spans:
            ev = {"ph": "X" if t1 is not None else "i",
                  "name": name, "cat": "request", "pid": 1, "tid": seq,
                  "ts": (t0 - epoch_ns) / 1e3}
            if t1 is not None:
                ev["dur"] = max(t1 - t0, 0) / 1e3
            else:
                ev["s"] = "t"
            ev["args"] = dict(args or {}, trace_id=trace_id)
            out.append(ev)
    return out
