"""Elastic training: the topology record of a snapshot, preemption and the
hung-step watchdog (``bigdl_tpu/utils/elastic.py``: ``TopologyMismatchError``
:75, ``Preempted`` :94, ``HungStepError`` :102, ``describe_topology`` :112,
``compare_topology`` :133, ``check_restore_topology`` :155, ``timed`` :213,
the preemption flag :240-281, ``grace_period`` :282, ``PreemptionHandler``
:287, the preemption markers :343-388, the stall diagnostics :390,
``_async_raise`` :408, ``HungStepWatchdog`` :423-660).

1. **Topology.**  A snapshot's manifest records the topology that wrote
   it: the world size, the ``data`` axis, which trainer's step owns the
   layout and the axis the ZeRO-1 slots shard over.  At restore the
   resuming trainer's topology is compared with it: the same one restores
   as it is; another one is resharded when
   ``bigdl.elastic.reshardOnRestore`` is on (the default), or raises
   :class:`TopologyMismatchError` naming every difference.  A snapshot
   holds full per-parameter slots, so resharding is a re-slice.

2. **Preemption.**  :class:`PreemptionHandler` routes SIGTERM/SIGINT into
   :func:`request_preemption` (``bigdl.elastic.handleSignals``; installed
   only on the main thread, the previous handlers put back on every exit
   path).  The handler only sets a flag; the trainers' loop polls
   :func:`preemption_requested` once an iteration and unwinds through a
   drain: it publishes the live state into the model and method and raises
   :class:`Preempted`.  ``optimize()`` then commits a final verified
   snapshot and a resumable marker (:func:`write_preemption_marker`)
   within ``bigdl.elastic.gracePeriod`` and re-raises: preemption means
   leave, not rewind.

3. **The hung-step watchdog.**  :class:`HungStepWatchdog` is a monitor
   thread fed one :meth:`~HungStepWatchdog.heartbeat` an iteration;
   completed intervals feed a step-time EMA seeded from the warmup's
   minimum, and when the open interval exceeds
   ``bigdl.watchdog.stallFactor`` x EMA it fires once for that stall:
   the registry's ``Elastic/watchdog_fired``,
   ``Elastic/watchdog_detect_ms`` (how far past the threshold it fired)
   and ``Elastic/watchdog_threshold_ms`` (the port's own addition), the
   timeline dump, the registered
   stall diagnostics, and :class:`HungStepError` injected into the
   training thread (:func:`_async_raise`), which the retry loop answers
   with a restore.  The injected exception is delivered only when that
   thread next runs Python bytecode: it interrupts a stall on the host (the
   chaos injector's sleep, a wedged Python thread), never a thread blocked
   inside C, such as a CUDA synchronize or an NCCL wait.  Such a thread is
   left to the process's supervisor, which the log line and the counters
   inform; the port adds no collective timeout of its own.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from bigdl_tpu_torch.utils import config
from bigdl_tpu_torch.analysis.lockwitness import make_lock

logger = logging.getLogger("bigdl_tpu_torch")

#: the manifest key the topology is stored under
TOPOLOGY_KEY = "topology"


class TopologyMismatchError(RuntimeError):
    """A snapshot's topology differs from the resuming trainer's and
    resharding is off.  ``mismatches`` names every differing field."""

    def __init__(self, saved: Dict[str, Any], current: Dict[str, Any],
                 mismatches: List[str]):
        self.saved = saved
        self.current = current
        self.mismatches = list(mismatches)
        super().__init__(
            "snapshot topology does not match the resuming trainer "
            f"({'; '.join(mismatches)}) and bigdl.elastic.reshardOnRestore "
            "is disabled: enable it to reshard the slots, or resume on the "
            f"saving topology (saved={saved}, current={current})")


class Preempted(RuntimeError):
    """The run was asked to stop (SIGTERM/SIGINT or an injected
    preemption): the loop drained, and, when a checkpoint is configured, a
    final verified snapshot and a resumable marker were committed.  Never
    retried: preemption means leave."""


class HungStepError(RuntimeError):
    """Injected into the training thread by the hung-step watchdog: a step
    exceeded ``bigdl.watchdog.stallFactor`` x the step-time EMA.  The retry
    loop restores the newest valid snapshot and resumes."""


def describe_topology(world_size: int = 1, step: str = "local",
                      slot_axis: Optional[str] = None,
                      axes: Optional[Dict[str, int]] = None
                      ) -> Dict[str, Any]:
    """The JSON-serializable topology of a trainer: ``world_size`` ranks
    on a ``data`` axis, or on the named ``axes`` of a mesh (none for one
    local process), the step (``local``, ``distri`` or
    ``tensor_parallel``) and the slots' shard axis (None: unsharded)."""
    if step == "local":
        return {"device_count": 1, "axes": {}, "step": step,
                "slot_axis": slot_axis}
    axes = {"data": int(world_size)} if axes is None else \
        {str(a): int(n) for a, n in axes.items()}
    return {"device_count": int(world_size), "axes": axes, "step": step,
            "slot_axis": slot_axis}


def compare_topology(saved: Optional[Dict[str, Any]],
                     current: Optional[Dict[str, Any]]) -> List[str]:
    """The differences between two topologies; empty when they match.  A
    snapshot without a topology record compares equal to anything."""
    if not saved or not current:
        return []
    out: List[str] = []
    if saved.get("device_count") != current.get("device_count"):
        out.append(f"device_count {saved.get('device_count')} -> "
                   f"{current.get('device_count')}")
    s_axes = saved.get("axes") or {}
    c_axes = current.get("axes") or {}
    for name in sorted(set(s_axes) | set(c_axes)):
        if s_axes.get(name) != c_axes.get(name):
            out.append(f"axis '{name}' {s_axes.get(name)} -> "
                       f"{c_axes.get(name)}")
    if saved.get("step") != current.get("step"):
        out.append(f"step {saved.get('step')!r} -> {current.get('step')!r}")
    return out


def check_restore_topology(saved: Optional[Dict[str, Any]],
                           current: Optional[Dict[str, Any]]) -> str:
    """``"same"``, or ``"reshard"`` when the topology changed and
    ``bigdl.elastic.reshardOnRestore`` allows it; raises
    :class:`TopologyMismatchError` otherwise."""
    mismatches = compare_topology(saved, current)
    if not mismatches:
        return "same"
    if config.get_bool("bigdl.elastic.reshardOnRestore", True):
        logger.info("elastic restore: snapshot topology differs from the "
                    "resuming trainer (%s): resharding the slots",
                    "; ".join(mismatches))
        return "reshard"
    raise TopologyMismatchError(saved or {}, current or {}, mismatches)


class _TimedHandle:
    __slots__ = ("record",)

    def __init__(self, record: bool):
        self.record = record

    def cancel(self) -> None:
        self.record = False


@contextmanager
def timed(metric: str, enabled: bool = True):
    """Time a phase into the ``Elastic/<metric>_ms`` gauge (last value
    wins).  ``enabled=False`` is a no-op; the handle's ``cancel()`` drops
    the recording (a restore scan that found nothing)."""
    handle = _TimedHandle(enabled)
    if not enabled:
        yield handle
        return
    from bigdl_tpu_torch import telemetry
    t0 = time.perf_counter()
    try:
        yield handle
    finally:
        if handle.record:
            telemetry.gauge(f"Elastic/{metric}_ms").set(
                (time.perf_counter() - t0) * 1e3)


# ---- preemption ----------------------------------------------------------

_PREEMPT: Dict[str, Any] = {"requested": False, "reason": None, "at": None}


def request_preemption(reason: str = "signal") -> None:
    """Flag the run for a graceful stop.  Async-signal-safe: it sets state
    and appends one event to the incident ring (a deque append), and
    touches no lock of the metrics registry; the loop bumps
    ``Elastic/preemptions`` when it sees the flag.  The grace period's
    clock starts here."""
    _PREEMPT["requested"] = True
    _PREEMPT["reason"] = reason
    _PREEMPT["at"] = time.monotonic()
    mod = sys.modules.get("bigdl_tpu_torch.telemetry.incident")
    if mod is not None:
        mod.record("preemption/requested", reason=reason)


def preemption_requested() -> bool:
    return _PREEMPT["requested"]


def preemption_reason() -> Optional[str]:
    return _PREEMPT["reason"]


def preemption_requested_at() -> Optional[float]:
    """``time.monotonic()`` of the request, or None."""
    return _PREEMPT["at"]


def clear_preemption() -> None:
    """Reset the flag (a resumed run in the same process starts clean)."""
    _PREEMPT["requested"] = False
    _PREEMPT["reason"] = None
    _PREEMPT["at"] = None


def grace_period() -> float:
    return config.get_float("bigdl.elastic.gracePeriod", 30.0)


class PreemptionHandler:
    """Context manager routing SIGTERM/SIGINT into
    :func:`request_preemption` for a training run.

    Installed only when ``bigdl.elastic.handleSignals`` is on and the
    caller is the main thread (CPython lets only it set handlers); the
    previous handlers are put back on exit, whatever the exit."""

    SIGNALS = ("SIGTERM", "SIGINT")

    def __init__(self, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = config.get_bool("bigdl.elastic.handleSignals", False)
        self.enabled = bool(enabled)
        self._previous: Dict[int, Any] = {}

    def __enter__(self) -> "PreemptionHandler":
        if not self.enabled:
            return self
        import signal
        if threading.current_thread() is not threading.main_thread():
            logger.warning(
                "bigdl.elastic.handleSignals is on but optimize() runs "
                "off the main thread - signal handlers not installed")
            self.enabled = False
            return self

        def handler(signum, frame):   # noqa: ARG001 - signal signature
            request_preemption(reason=f"signal {signum}")

        try:
            for name in self.SIGNALS:
                signum = getattr(signal, name)
                self._previous[signum] = signal.signal(signum, handler)
        except BaseException:
            self.__exit__(None, None, None)
            raise
        return self

    def __exit__(self, *exc) -> None:
        if not self._previous:
            return
        import signal
        for signum, prev in self._previous.items():
            try:
                signal.signal(signum, prev)
            except (ValueError, TypeError):  # pragma: no cover - teardown
                pass
        self._previous.clear()


#: the resumable marker's file name, beside the grace-period snapshot
PREEMPT_MARKER = "preempted"


def write_preemption_marker(ckpt_path: str, neval: int) -> None:
    """Write the resumable marker into the checkpoint directory: a small
    JSON naming the snapshot the drain committed (``neval``, ``reason``,
    ``unix_time``), so a supervisor can tell an orderly preemption from a
    crash."""
    import json
    from bigdl_tpu_torch.utils import file_io
    payload = json.dumps({
        "neval": int(neval),
        "reason": preemption_reason() or "preempted",
        "unix_time": time.time(),
    }, sort_keys=True).encode("utf-8")
    try:
        file_io.write_bytes(file_io.join(ckpt_path, PREEMPT_MARKER),
                            payload, overwrite=True)
    except Exception as e:  # the marker is advisory, the snapshot is not
        logger.warning("could not write preemption marker: %r", e)


def read_preemption_marker(ckpt_path: str) -> Optional[Dict[str, Any]]:
    import json
    from bigdl_tpu_torch.utils import file_io
    try:
        data = file_io.read_bytes(file_io.join(ckpt_path, PREEMPT_MARKER))
    except Exception:
        return None
    return json.loads(data.decode("utf-8"))


def clear_preemption_marker(ckpt_path: str) -> None:
    from bigdl_tpu_torch.utils import file_io
    try:
        file_io.remove(file_io.join(ckpt_path, PREEMPT_MARKER))
    except Exception:
        pass


# ---- hung-step watchdog --------------------------------------------------

#: name -> () -> dict: subsystem snapshots logged when the watchdog fires
#: (cheap, lock-light, no device values: they run on the monitor thread
#: while the training thread is presumed hung)
_STALL_DIAGNOSTICS: Dict[str, Any] = {}


def register_stall_diagnostic(name: str, provider) -> None:
    """Report ``provider() -> dict`` on every watchdog fire (by name: a
    second registration replaces the first)."""
    _STALL_DIAGNOSTICS[name] = provider


def stall_diagnostics() -> Dict[str, Any]:
    """Every registered provider's snapshot (a failing one reports its
    error)."""
    out: Dict[str, Any] = {}
    for name, provider in list(_STALL_DIAGNOSTICS.items()):
        try:
            out[name] = provider()
        except Exception as e:  # diagnostics must not mask the abort
            out[name] = {"error": repr(e)}
    return out


def _async_raise(thread_id: int, exc_type) -> bool:
    """Inject ``exc_type`` into the thread ``thread_id``
    (``PyThreadState_SetAsyncExc``); it surfaces when that thread next runs
    bytecode."""
    import ctypes
    set_exc = ctypes.pythonapi.PyThreadState_SetAsyncExc
    set_exc.argtypes = (ctypes.c_ulong, ctypes.py_object)
    set_exc.restype = ctypes.c_int
    res = set_exc(ctypes.c_ulong(thread_id), ctypes.py_object(exc_type))
    if res > 1:  # pragma: no cover - interpreter-level inconsistency
        set_exc(ctypes.c_ulong(thread_id), None)
        return False
    return res == 1


class HungStepWatchdog:
    """A monitor thread that detects a training iteration that never ends.

    The loop calls :meth:`heartbeat` once an iteration; the interval
    between two heartbeats is a completed step and feeds a
    :class:`~bigdl_tpu_torch.telemetry.SlowStepDetector` (EMA seeded from
    the warmup's minimum: detection is off until the warmup is done).  The
    monitor wakes every ``poll_interval`` seconds and compares the open
    interval with ``factor`` x EMA.  A stall fires once, however long it
    lasts; after it ends, ``cooldown`` completed heartbeats must pass
    before the next fire.  A fire logs and counts, dumps the telemetry
    timeline (``bigdl.watchdog.timelineDir``, when tracing is armed),
    calls ``on_fire``, and with ``abort`` injects :attr:`EXC` into the
    training thread.  :meth:`paused` takes long phases (publish,
    validation, checkpoint) out of both the open interval and the EMA."""

    #: the exception injected into the supervised thread
    EXC = HungStepError
    #: the registry namespace of the fired/detect_ms metrics
    METRIC_PREFIX = "Elastic"
    #: the tracer's instant event on a fire
    INSTANT_NAME = "watchdog/hung_step"

    def __init__(self, factor: float, warmup: int = 5, cooldown: int = 50,
                 poll_interval: float = 0.25, abort: bool = True,
                 timeline_dir: Optional[str] = None, on_fire=None):
        from bigdl_tpu_torch.telemetry import SlowStepDetector
        self.factor = float(factor)
        self.detector = SlowStepDetector(self.factor, warmup=warmup,
                                         cooldown=0)
        self.cooldown = max(0, int(cooldown))
        self.poll_interval = max(0.01, float(poll_interval))
        self.abort = abort
        self.timeline_dir = timeline_dir
        self.on_fire = on_fire
        self.fired = 0
        self._lock = make_lock("elastic.watchdog")
        self._last_beat_ns: Optional[int] = None
        self._beats = 0
        self._fired_this_stall = False       # guarded-by: _lock
        self._cool_left = 0
        self._paused = 0
        #: start() to the first heartbeat is set-up, not a step
        self._skip_next_observe = True
        #: step time spent before a pause, added back at the next beat
        self._carry_ns = 0
        self._driver_tid: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def from_config(cls, timeline_dir: Optional[str] = None,
                    on_fire=None) -> Optional["HungStepWatchdog"]:
        """A watchdog per the ``bigdl.watchdog.*`` keys, or None when
        ``stallFactor`` is 0 (the default: no monitor thread at all)."""
        factor = config.get_float("bigdl.watchdog.stallFactor", 0.0)
        if factor <= 0:
            return None
        return cls(
            factor,
            warmup=config.get_int("bigdl.watchdog.warmupSteps", 5),
            cooldown=config.get_int("bigdl.watchdog.cooldownSteps", 50),
            poll_interval=config.get_float("bigdl.watchdog.pollInterval",
                                           0.25),
            timeline_dir=(timeline_dir if timeline_dir is not None else
                          config.get_property("bigdl.watchdog.timelineDir")),
            on_fire=on_fire)

    @property
    def enabled(self) -> bool:
        return self.factor > 0

    # -- the training thread's side ---------------------------------------

    def start(self) -> "HungStepWatchdog":
        """Start monitoring; call from the training thread (the abort's
        target)."""
        from bigdl_tpu_torch import telemetry
        self._driver_tid = threading.get_ident()
        self._last_beat_ns = telemetry.clock_ns()
        self._stop.clear()
        self._thread = threading.Thread(target=self._monitor, daemon=True,
                                        name="bigdl-watchdog")
        self._thread.start()
        return self

    def heartbeat(self) -> None:
        """One iteration completed."""
        from bigdl_tpu_torch import telemetry
        now = telemetry.clock_ns()
        with self._lock:
            last = self._last_beat_ns
            self._last_beat_ns = now
            self._beats += 1
            skip = self._skip_next_observe
            self._skip_next_observe = False
            carry, self._carry_ns = self._carry_ns, 0
            if self._fired_this_stall:
                self._fired_this_stall = False
                self._cool_left = self.cooldown
            elif self._cool_left > 0:
                self._cool_left -= 1
        if last is not None and not skip:
            # the detector is only touched from the training thread
            self.detector.observe(float(carry + now - last))

    def reset_interval(self) -> None:
        """Restart the open interval without feeding the EMA."""
        from bigdl_tpu_torch import telemetry
        with self._lock:
            self._last_beat_ns = telemetry.clock_ns()
            self._carry_ns = 0

    @contextmanager
    def paused(self):
        """Suspend detection over a legitimately long phase: the step time
        already spent is banked and the clock restarts on resume, so the
        next heartbeat observes the step's work without the pause."""
        from bigdl_tpu_torch import telemetry
        with self._lock:
            if self._paused == 0 and self._last_beat_ns is not None:
                self._carry_ns += telemetry.clock_ns() - self._last_beat_ns
            self._paused += 1
        try:
            yield
        finally:
            with self._lock:
                self._paused -= 1
                if self._paused == 0:
                    self._last_beat_ns = telemetry.clock_ns()

    def stop(self) -> None:
        """Stop and join the monitor.  Set under the lock: a fire re-checks
        it under the same lock before injecting, so a monitor racing the
        end of the run cannot abort a finished one."""
        with self._lock:
            self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    # -- the monitor's side -----------------------------------------------

    def threshold_ns(self) -> float:
        """The stall threshold; inf during the warmup."""
        return self.detector.threshold()

    def _monitor(self) -> None:
        from bigdl_tpu_torch import telemetry
        while not self._stop.wait(self.poll_interval):
            threshold = self.threshold_ns()
            if threshold == float("inf"):
                continue
            with self._lock:
                last = self._last_beat_ns
                carry = self._carry_ns
                blocked = (not self._paused and
                           not self._fired_this_stall and
                           self._cool_left == 0)
            if last is None or not blocked:
                continue
            open_ns = carry + telemetry.clock_ns() - last
            if open_ns <= threshold:
                continue
            with self._lock:
                # a beat or a pause between the snapshot and here: the
                # thread moved on, firing would abort a healthy step
                if (self._fired_this_stall or self._paused or
                        self._last_beat_ns != last):
                    continue
                self._fired_this_stall = True
            self.fired += 1
            self._fire(open_ns, threshold, last)

    def _fire(self, open_ns: float, threshold_ns: float,
              beat_snapshot) -> None:
        from bigdl_tpu_torch import telemetry
        detect_ms = (open_ns - threshold_ns) / 1e6
        logger.error(
            "Hung step detected: current step open for %.1f ms (> %.1f ms "
            "= %.1f x EMA); aborting with %s (watchdog fire %d this run)",
            open_ns / 1e6, threshold_ns / 1e6, self.factor,
            self.EXC.__name__, self.fired)
        telemetry.counter(f"{self.METRIC_PREFIX}/watchdog_fired",
                          help="hung-step watchdog aborts").inc()
        telemetry.gauge(f"{self.METRIC_PREFIX}/watchdog_detect_ms").set(
            detect_ms)
        telemetry.gauge(f"{self.METRIC_PREFIX}/watchdog_threshold_ms").set(
            threshold_ns / 1e6)
        telemetry.instant(self.INSTANT_NAME,
                          open_ms=round(open_ns / 1e6, 3),
                          threshold_ms=round(threshold_ns / 1e6, 3))
        diagnostics = stall_diagnostics()
        if diagnostics:
            logger.error("hung-step diagnostics: %s", diagnostics)
        if self.timeline_dir and telemetry.tracing_enabled():
            try:
                from bigdl_tpu_torch.resources import storage as _rstorage
                _rstorage.bounded_timeline_export(os.path.join(
                    str(self.timeline_dir),
                    f"watchdog_{self.fired}_timeline.json"))
            except Exception as e:  # diagnostics must not mask the abort
                logger.warning("watchdog timeline dump failed: %r", e)
        if self.on_fire is not None:
            try:
                self.on_fire(open_ns, threshold_ns)
            except Exception as e:  # pragma: no cover - probe bug
                logger.warning("watchdog on_fire callback failed: %r", e)
        if self.abort and self._driver_tid is not None:
            with self._lock:
                if self._stop.is_set():
                    logger.info("hung-step abort suppressed: the run "
                                "already completed")
                    return
                if self._paused or self._last_beat_ns != beat_snapshot:
                    logger.info("hung-step abort suppressed: the step "
                                "completed during fire diagnostics")
                    return
                injected = _async_raise(self._driver_tid, self.EXC)
            if not injected:
                logger.error(
                    "watchdog could not inject %s into the training thread "
                    "(already exited?)", self.EXC.__name__)
