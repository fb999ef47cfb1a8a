"""Incident flight recorder: one artifact per terminal fault
(``bigdl_tpu/telemetry/incident.py``).

A bounded ring of structured events, fed from the subsystems' choke points
(the serving engines' drains, quarantines and aborted dispatches, the
trainers' divergence), and, on a terminal structured failure (or an
explicit :func:`dump`), ONE **incident bundle**:

- the event ring (:func:`events`),
- every span lane (:func:`tracer.events`),
- the metrics registry snapshot (``REGISTRY.snapshot()``),
- the effective non-default configuration
  (:func:`~bigdl_tpu_torch.utils.config.non_default_properties`),
- every live thread's stack (``sys._current_frames``),
- and, when applicable, the offending request's trace
  (:func:`~bigdl_tpu_torch.telemetry.request_trace.get`).

Each bundle is written through ``file_io.write_bytes`` under
``storage.guarded_export("incident", …)`` (a full disk degrades the
recorder with one warning instead of failing the run a second time), at
most ``bigdl.incident.maxDumps`` bundle files per run, the oldest evicted
first.  :func:`record` is ONE ``deque.append`` (no locks, no IO).
:func:`maybe_dump` writes at most one bundle per fault slug per run, gated
by ``bigdl.incident.autoDump``.  The ring is this package's own, empty at
import.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import traceback
from collections import deque
from typing import Dict, List, Optional

from bigdl_tpu_torch.telemetry import tracer
from bigdl_tpu_torch.telemetry.metrics import REGISTRY
from bigdl_tpu_torch.analysis.lockwitness import make_lock

SCHEMA = "bigdl.incident/1"
DEFAULT_RING_SIZE = 512
DEFAULT_MAX_DUMPS = 8

_LOCK = make_lock("telemetry.incident")
_EVENTS: deque = deque(maxlen=DEFAULT_RING_SIZE)
_DUMPS: List[str] = []          # bundle paths, oldest first
_DUMPED_SLUGS: set = set()      # one auto-dump per fault slug per run
_SEQ = [0]


# ---- the always-on ring ----------------------------------------------------

def record(kind: str, **fields) -> None:
    """Append one structured event to the flight-recorder ring.

    ASYNC-SIGNAL-SAFE by construction: one ``deque.append`` under the
    GIL — no locks, no IO, no metric-registry touches, no allocation
    beyond the event tuple.  Always on (the ring is the cheap part; the
    bundle write is the expensive part and only happens on :func:`dump`).
    """
    _EVENTS.append((tracer.clock_ns(), kind,
                    threading.current_thread().name, fields or None))


def events() -> List[dict]:
    """The event ring as dicts, oldest first."""
    return [{"t_ns": t, "kind": kind, "thread": thread, "fields": fields}
            for t, kind, thread, fields in list(_EVENTS)]


def reset() -> None:
    """Clear the ring, the dump ledger, and the once-per-slug set
    (test isolation / start-of-run); re-reads
    ``bigdl.incident.ringSize`` so tests can resize the ring."""
    global _EVENTS
    from bigdl_tpu_torch.utils import config
    size = max(1, config.get_int("bigdl.incident.ringSize",
                                 DEFAULT_RING_SIZE))
    with _LOCK:
        _EVENTS = deque(maxlen=size)
        del _DUMPS[:]
        _DUMPED_SLUGS.clear()


# ---- the bundle ------------------------------------------------------------

def _thread_stacks() -> Dict[str, List[str]]:
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        key = f"{names.get(ident, '?')}-{ident}"
        out[key] = traceback.format_stack(frame)
    return out


def bundle(reason: str, trace_id: Optional[str] = None) -> dict:
    """Assemble (but do not write) one incident bundle."""
    from bigdl_tpu_torch.telemetry import request_trace
    from bigdl_tpu_torch.utils import config
    return {
        "schema": SCHEMA,
        "reason": reason,
        "written_ns": tracer.clock_ns(),
        "events": events(),
        "spans": tracer.events(),
        "metrics": REGISTRY.snapshot(),
        "config": config.non_default_properties(),
        "threads": _thread_stacks(),
        "trace": request_trace.get(trace_id),
        "trace_id": trace_id,
    }


def dump(reason: str, trace_id: Optional[str] = None,
         path: Optional[str] = None) -> Optional[str]:
    """Write ONE incident bundle to disk and return its path.

    Bounded at ``bigdl.incident.maxDumps`` files per run (oldest bundle
    evicted first); the write rides ``guarded_export``/``write_bytes``
    so a full disk degrades the recorder instead of raising.  Returns
    ``None`` when the write was suppressed (cap ≤ 0, storage degraded,
    or the disk filled during the write).
    """
    from bigdl_tpu_torch.resources import storage
    from bigdl_tpu_torch.utils import config, file_io
    cap = config.get_int("bigdl.incident.maxDumps", DEFAULT_MAX_DUMPS)
    if cap <= 0 or storage.is_degraded("incident"):
        return None
    with _LOCK:
        _SEQ[0] += 1
        seq = _SEQ[0]
        while len(_DUMPS) >= cap:
            victim = _DUMPS.pop(0)
            try:
                if os.path.exists(victim):
                    os.unlink(victim)
            except OSError:
                pass
    if path is None:
        base = config.get_property("bigdl.incident.dir") or os.getcwd()
        path = os.path.join(base, f"incident-{seq:04d}.json")
    t0 = tracer.clock_ns()
    doc = bundle(reason, trace_id=trace_id)
    payload = json.dumps(doc, indent=1, sort_keys=True,
                         default=repr).encode("utf-8")

    def _write():
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        file_io.write_bytes(path, payload, overwrite=True)

    if not storage.guarded_export("incident", _write):
        return None
    with _LOCK:
        _DUMPS.append(path)
    dt_ms = (tracer.clock_ns() - t0) / 1e6
    REGISTRY.counter("Incident/dumps",
                     help="incident bundles written").inc()
    REGISTRY.histogram("Incident/dump_ms",
                       help="incident bundle assemble+write latency "
                            "(ms)").observe(dt_ms)
    return path


def maybe_dump(slug: str, trace_id: Optional[str] = None,
               reason: Optional[str] = None) -> Optional[str]:
    """Auto-dump hook for terminal structured failures: writes at most
    one bundle per fault ``slug`` per run, and only when
    ``bigdl.incident.autoDump`` allows (default on).  A shed batch of N
    requests is one incident, not N bundles."""
    from bigdl_tpu_torch.utils import config
    if not config.get_bool("bigdl.incident.autoDump", True):
        return None
    with _LOCK:
        if slug in _DUMPED_SLUGS:
            return None
        _DUMPED_SLUGS.add(slug)
    return dump(reason or slug, trace_id=trace_id)


def dumped() -> List[str]:
    """Paths of the bundles written this run, oldest first."""
    with _LOCK:
        return list(_DUMPS)
