"""Disk-full graceful degradation: shared state and guarded exporters
(``bigdl_tpu/resources/storage.py``).

Once ``file_io.write_bytes`` classifies an ENOSPC/EDQUOT into
:class:`~bigdl_tpu_torch.resources.errors.StorageExhaustedError`, each
consumer degrades instead of crashing and records it here: the telemetry
snapshot, Chrome-trace, timeline and incident exports disable themselves
through :func:`guarded_export`, with exactly ONE structured warning and one
``Resources/storage_degraded`` counter increment per component.

:func:`bounded_timeline_export` caps the timeline dumps of a run (the
slow-step detector's) at ``bigdl.telemetry.maxTimelineDumps``, evicting
the oldest first, so a flapping detector cannot fill the disk.

The JAX package takes its lock from ``analysis.make_lock`` (its lock-order
witness); the port has no ``analysis`` and uses a plain lock.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, List, Optional

from bigdl_tpu_torch.resources.errors import is_storage_exhausted
from bigdl_tpu_torch.analysis.lockwitness import make_lock

logger = logging.getLogger("bigdl_tpu_torch")

_lock = make_lock("storage.degraded")
_degraded: Dict[str, str] = {}          # component -> first error message
_timeline_dumps: List[str] = []         # dump paths, oldest first


def note_degraded(component: str, error: BaseException) -> bool:
    """Record a component's storage degradation.  Returns True the first
    time (callers log/flag once), False on repeats (silent)."""
    with _lock:
        first = component not in _degraded
        if first:
            _degraded[component] = repr(error)
    if first:
        from bigdl_tpu_torch import telemetry
        telemetry.counter(
            "Resources/storage_degraded", labels={"component": component},
            help="components degraded to diskless operation after "
                 "ENOSPC/EDQUOT").inc()
        logger.warning(
            "storage exhausted: %s degrades to diskless operation "
            "(training/serving continue; fix the disk to re-enable): %r",
            component, error)
    return first


def is_degraded(component: Optional[str] = None) -> bool:
    with _lock:
        if component is None:
            return bool(_degraded)
        return component in _degraded


def degraded_components() -> Dict[str, str]:
    with _lock:
        return dict(_degraded)


def guarded_export(component: str, fn: Callable[[], None]) -> bool:
    """Run a best-effort disk export unless its component already
    degraded; a disk-full failure inside degrades the component instead of
    propagating.  Returns True when the export ran and succeeded."""
    if is_degraded(component):
        return False
    try:
        fn()
        return True
    except BaseException as e:
        if is_storage_exhausted(e):
            note_degraded(component, e)
            return False
        raise


def bounded_timeline_export(path: str) -> bool:
    """Export the tracer's Chrome-trace timeline to ``path``, bounded: at
    most ``bigdl.telemetry.maxTimelineDumps`` dump files exist per run,
    the oldest evicted first.  Storage exhaustion degrades the
    ``timeline`` component instead of raising.  True when the dump
    landed."""
    from bigdl_tpu_torch.utils import config
    cap = config.get_int("bigdl.telemetry.maxTimelineDumps", 8)
    if cap <= 0 or is_degraded("timeline"):
        return False
    with _lock:
        while len(_timeline_dumps) >= cap:
            victim = _timeline_dumps.pop(0)
            try:
                if os.path.exists(victim):
                    os.unlink(victim)
            except OSError as e:
                logger.warning("timeline-dump eviction of %s failed: %r",
                               victim, e)

    def _export():
        from bigdl_tpu_torch import telemetry
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        telemetry.export_chrome_trace(path)

    ok = guarded_export("timeline", _export)
    if ok:
        with _lock:
            _timeline_dumps.append(path)
    return ok


def timeline_dump_count() -> int:
    with _lock:
        return len(_timeline_dumps)


def reset() -> None:
    """Clear the degradation flags and the dump ledger (test isolation)."""
    with _lock:
        _degraded.clear()
        del _timeline_dumps[:]
