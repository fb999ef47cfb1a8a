"""Chaos harness: configuration-driven fault injection for the training
loop and the checkpoint write path (``bigdl_tpu/utils/chaos.py``, its
training and checkpoint subset: ``install``/``uninstall``/``active``
:1074-1104, ``on_step`` :1105, ``take_bitflip`` :1227, ``desync_replica``
:1236, ``take_oom_dispatch`` :1256, ``host_mem_pressure`` :1272, the storage
hooks ``on_write`` :1098 and ``take_disk_full`` :1264, and
``corrupt_state_before_save`` :1247).

The trainers' loop consults the harness once an iteration, the trainers'
step before each dispatch, ``utils.file_io.write_bytes`` on every payload
write and the checkpoint manager on every capture.  The keys, each read at
:func:`install`:

==================================  =========================================
``bigdl.chaos.failWriteAt``         k: the k-th payload write raises
                                    :class:`ChaosError` after writing half
                                    its bytes to the temporary file (a torn
                                    write; the rename never happens).
``bigdl.chaos.truncateWriteAt``     k: the k-th payload write silently drops
                                    the second half of its bytes and
                                    commits them (only a checksum sees it).
``bigdl.chaos.transientWrites``     n: the first n payload writes raise a
                                    transient :class:`ChaosError` and then
                                    recover (a caller that retries,
                                    ``file_io.retrying``, absorbs them; a
                                    local snapshot write does not retry,
                                    as in the JAX package).
``bigdl.chaos.diskFullAt``          "k" or "k:substr", comma-separated: the
                                    k-th write whose path contains
                                    ``substr`` raises ``OSError(ENOSPC)``.
``bigdl.chaos.corruptStateBeforeSaveAt``  k: the k-th checkpoint capture is
                                    corrupted after its semantic
                                    fingerprint was taken (its checksums
                                    verify; the restore's fingerprint
                                    refuses it).
``bigdl.chaos.failStepAt``          k: iteration k raises once.
``bigdl.chaos.topologyChangeAt``    k: iteration k raises once (named for a
                                    resume on another world size).
``bigdl.chaos.nanLossAt``           "k" or "k:m": the k-th..m-th iterations
                                    the harness observes (counted across
                                    retries) report a NaN loss.
``bigdl.chaos.preemptAt``           k: iteration k requests preemption once
                                    (the flag a SIGTERM handler sets).
``bigdl.chaos.stallStepAt``         "k" or "k:seconds": iteration k sleeps
                                    ``seconds`` (default 5) on the training
                                    thread, once.
``bigdl.chaos.oomStepAt``           k: the k-th step dispatch raises a
                                    ``RESOURCE_EXHAUSTED`` allocation
                                    failure before the step runs, once.
``bigdl.chaos.hostMemPressureAt``   k: the governor's k-th poll reports no
                                    free bytes, once.
``bigdl.chaos.bitflipParamAt``      "k" or "k:leaf": at iteration k one
                                    mid-mantissa bit of the first element of
                                    float parameter ``leaf`` (default 0)
                                    flips, once (a data-parallel trainer
                                    flips replica ``leaf``'s copy).
``bigdl.chaos.desyncReplicaAt``     "k" or "k:replica": in step k replica
                                    ``replica`` (default 1) adds 1.0 to its
                                    own copy of the updated parameters.
==================================  =========================================

Every other ``bigdl.chaos.*`` key of the JAX package (the ingest, serving,
LM, fleet, compile, lock and audit injectors) belongs to a part the port
does not have yet: :func:`install` raises :class:`NotImplementedError` when
one is set (:data:`UNPORTED_KEYS`), as do the trainers
(:func:`refuse_unported_keys`).

Counters are process-local and count from :func:`install`; disarmed (the
default) every hook is a no-op behind one attribute check.
"""

from __future__ import annotations

import errno
import io
import sys as _sys
import threading
from typing import Optional, Tuple

from bigdl_tpu_torch.utils import config

#: the JAX package's injectors that the port does not have
UNPORTED_KEYS = (
    "bigdl.chaos.corruptRecordAt", "bigdl.chaos.corruptRecordEvery",
    "bigdl.chaos.failDecodeAt", "bigdl.chaos.transientReads",
    "bigdl.chaos.killStageThread", "bigdl.chaos.starveStageAt",
    "bigdl.chaos.corruptCompileCacheAt", "bigdl.chaos.hangCompileAt",
    "bigdl.chaos.slowRequestAt", "bigdl.chaos.poisonRequestAt",
    "bigdl.chaos.hangDispatchAt", "bigdl.chaos.burstArrivals",
    "bigdl.chaos.poisonPromptAt", "bigdl.chaos.hangDecodeAt",
    "bigdl.chaos.evictBlockAt", "bigdl.chaos.killReplicaAt",
    "bigdl.chaos.corruptCandidateAt", "bigdl.chaos.sigtermFleetAt",
    "bigdl.chaos.lockDelayAt", "bigdl.chaos.extraAllGather",
    "bigdl.chaos.f32Upcast", "bigdl.chaos.dropBucketCollective")


def _is_set(value) -> bool:
    return value not in (None, "", False, 0, "0", "false", "False")


def refuse_unported_keys() -> None:
    """Raise :class:`NotImplementedError` naming every set key of
    :data:`UNPORTED_KEYS`."""
    asked = [k for k in UNPORTED_KEYS if _is_set(config.get_property(k))]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: these fault injectors belong to parts of "
            "the JAX package that are not ported yet")


class ChaosError(IOError):
    """An injected storage or step fault.  An ``IOError``, so the code
    under test cannot tell it from a real infrastructure failure."""


def _incident_note(kind: str, **fields) -> None:
    """Record the injection in the incident ring, so that a bundle names
    the fault a run was put through (looked up, never imported)."""
    mod = _sys.modules.get("bigdl_tpu_torch.telemetry.incident")
    if mod is not None:
        mod.record(f"chaos/{kind}", **fields)


class _TornWrite(ChaosError):
    """The k-th write failing mid-way: carries the prefix written, so the
    storage layer leaves the torn temporary behind."""

    #: a writer that died is not a blip: the storage retry must not absorb it
    fatal = True

    def __init__(self, path: str, partial: bytes):
        super().__init__(f"chaos: writer died mid-write on {path}")
        self.partial = partial


def _parse_span(value) -> Tuple[int, int]:
    """``"k"`` -> (k, k); ``"k:m"`` -> (k, m); falsy -> (0, -1)."""
    if not value:
        return (0, -1)
    s = str(value)
    if ":" in s:
        lo, hi = s.split(":", 1)
        return (int(lo), int(hi))
    k = int(s)
    return (k, k)


def _parse_stall(value) -> Tuple[int, float]:
    """``"k"`` -> (k, 5.0); ``"k:seconds"`` -> (k, seconds); falsy ->
    (0, 0.0)."""
    if not value:
        return (0, 0.0)
    s = str(value)
    if ":" in s:
        k, secs = s.split(":", 1)
        return (int(k), float(secs))
    return (int(s), 5.0)


def _parse_indexed(value, default_index: int) -> Tuple[int, int]:
    """``"k"`` -> (k, default); ``"k:i"`` -> (k, i); falsy -> (0, 0)."""
    if not value:
        return (0, 0)
    s = str(value)
    if ":" in s:
        k, i = s.split(":", 1)
        return (int(k), int(i))
    return (int(s), default_index)


def _parse_disk_full(value):
    """``"k"`` / ``"k:substr"``, comma-separated: one armed entry each, with
    its own match counter and once-per-plan latch.  Falsy -> []."""
    if not value:
        return []
    entries = []
    for part in str(value).split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            k, substr = part.split(":", 1)
            entries.append({"k": int(k), "substr": substr.strip(),
                            "count": 0, "fired": False})
        else:
            entries.append({"k": int(part), "substr": "", "count": 0,
                            "fired": False})
    return entries


def _corrupt_payload(obj):
    """A copy of a checkpoint payload (a dict of tensors, or nested dicts
    and lists of them) with the first float tensor's first element raised
    by 1.0 (no fingerprint rounding hides it); ``obj`` stays clean.  None
    when nothing float-like is found."""
    import torch
    buf = io.BytesIO()
    torch.save(obj, buf)
    buf.seek(0)
    copy = torch.load(buf, weights_only=True)

    def walk(x) -> bool:
        if isinstance(x, torch.Tensor):
            if x.is_floating_point() and x.numel():
                x.view(-1)[0] += 1.0
                return True
            return False
        if isinstance(x, dict):
            return any(walk(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return any(walk(v) for v in x)
        return False

    return copy if walk(copy) else None


class _ChaosState:
    """One armed injection plan: the parsed keys and their counters."""

    def __init__(self):
        self.fail_write_at = config.get_int("bigdl.chaos.failWriteAt", 0)
        self.truncate_write_at = config.get_int(
            "bigdl.chaos.truncateWriteAt", 0)
        self.transient_writes = config.get_int(
            "bigdl.chaos.transientWrites", 0)
        self.fail_step_at = config.get_int("bigdl.chaos.failStepAt", 0)
        self.nan_loss_at = _parse_span(
            config.get_property("bigdl.chaos.nanLossAt"))
        self.preempt_at = config.get_int("bigdl.chaos.preemptAt", 0)
        self.stall_step_at, self.stall_seconds = _parse_stall(
            config.get_property("bigdl.chaos.stallStepAt"))
        self.topology_change_at = config.get_int(
            "bigdl.chaos.topologyChangeAt", 0)
        self.bitflip_at, self.bitflip_leaf = _parse_indexed(
            config.get_property("bigdl.chaos.bitflipParamAt"), 0)
        self.desync_at, self.desync_replica = _parse_indexed(
            config.get_property("bigdl.chaos.desyncReplicaAt"), 1)
        self.corrupt_save_at = config.get_int(
            "bigdl.chaos.corruptStateBeforeSaveAt", 0)
        self.oom_step_at = config.get_int("bigdl.chaos.oomStepAt", 0)
        self.disk_full_plan = _parse_disk_full(
            config.get_property("bigdl.chaos.diskFullAt"))
        self.host_pressure_at = config.get_int(
            "bigdl.chaos.hostMemPressureAt", 0)
        self.writes = 0
        self.steps_failed = 0
        self.steps_seen = 0
        self.transient_raised = 0
        self.preempts = 0
        self.stalls = 0
        self.topology_changes = 0
        self.bitflip_due: Optional[int] = None   # leaf index, taken once
        self.bitflips = 0
        self.state_corruptions = 0
        self.captures = 0
        self.step_dispatches = 0
        self.oom_fired = 0
        self.disk_full_fired = 0
        self.pressure_fired = 0
        self._lock = threading.Lock()

    # ---- the storage layer ---------------------------------------------

    def on_write(self, path: str, data: bytes) -> bytes:
        """The bytes to write for ``path`` (possibly torn), or raises."""
        with self._lock:
            # transient faults count attempts: the retrying caller sees n
            # failures, then a clean write
            if self.transient_raised < self.transient_writes:
                self.transient_raised += 1
                raise ChaosError(
                    f"chaos: transient write failure "
                    f"{self.transient_raised}/{self.transient_writes} on "
                    f"{path}")
            self.writes += 1
            k = self.writes
        if k == self.truncate_write_at:
            return data[:max(1, len(data) // 2)]
        if k == self.fail_write_at:
            raise _TornWrite(path, data[:max(1, len(data) // 2)])
        return data

    def take_disk_full(self, path: str) -> None:
        """Raise a raw ``OSError(ENOSPC)`` at an armed entry's k-th
        matching write, once per entry."""
        if not self.disk_full_plan:
            return
        fire = False
        with self._lock:
            for entry in self.disk_full_plan:
                if entry["fired"] or (entry["substr"] and
                                      entry["substr"] not in path):
                    continue
                entry["count"] += 1
                if entry["count"] >= entry["k"]:
                    entry["fired"] = True
                    self.disk_full_fired += 1
                    fire = True
                    break
        if fire:
            _incident_note("disk_full", path=path)
            raise OSError(errno.ENOSPC,
                          f"No space left on device (chaos: injected "
                          f"disk-full writing {path})")

    def corrupt_state_before_save(self, obj):
        """The ``corruptStateBeforeSaveAt``-th capture comes back as a
        corrupted copy (the live state stays clean), once."""
        if not self.corrupt_save_at:
            return obj
        with self._lock:
            self.captures += 1
            fire = (self.captures == self.corrupt_save_at and
                    self.state_corruptions == 0)
            if fire:
                self.state_corruptions = 1
        if not fire:
            return obj
        corrupt = _corrupt_payload(obj)
        return obj if corrupt is None else corrupt

    # ---- the training loop ---------------------------------------------

    def on_step(self, neval: int) -> bool:
        """At the top of iteration ``neval``: raises for a simulated step
        failure; True when this iteration's loss should read NaN."""
        with self._lock:
            self.steps_seen += 1
            seen = self.steps_seen
        if self.fail_step_at and neval == self.fail_step_at:
            with self._lock:
                if self.steps_failed == 0:   # once, not every retry
                    self.steps_failed += 1
                    raise ChaosError(
                        f"chaos: simulated step failure at iteration "
                        f"{neval}")
        if self.topology_change_at and neval == self.topology_change_at:
            with self._lock:
                if self.topology_changes == 0:
                    self.topology_changes += 1
                    raise ChaosError(
                        f"chaos: mesh lost at iteration {neval} - resume "
                        "on a different topology")
        if self.preempt_at and neval == self.preempt_at:
            with self._lock:
                fire = self.preempts == 0
                self.preempts += 1 if fire else 0
            if fire:
                from bigdl_tpu_torch.utils import elastic
                elastic.request_preemption(
                    reason=f"chaos preemption at iteration {neval}")
        if self.stall_step_at and neval == self.stall_step_at:
            with self._lock:
                fire = self.stalls == 0
                self.stalls += 1 if fire else 0
            if fire:
                # a sleep in Python: the watchdog's injected HungStepError
                # lands as it returns
                import time
                time.sleep(self.stall_seconds)
        if self.bitflip_at and neval == self.bitflip_at:
            with self._lock:
                if self.bitflips == 0:   # once: a healed replay runs clean
                    self.bitflips = 1
                    self.bitflip_due = self.bitflip_leaf
        lo, hi = self.nan_loss_at
        return bool(lo) and lo <= seen <= hi

    def take_bitflip(self) -> Optional[int]:
        """The pending flip's leaf (or replica) index, consumed once."""
        with self._lock:
            due, self.bitflip_due = self.bitflip_due, None
        return due

    def take_oom_dispatch(self, label: str) -> None:
        """The ``oomStepAt``-th dispatch raises an allocation failure with
        the message XLA's runtime carries, before the step runs."""
        if not self.oom_step_at:
            return
        with self._lock:
            self.step_dispatches += 1
            fire = (self.step_dispatches == self.oom_step_at and
                    self.oom_fired == 0)
            if fire:
                self.oom_fired = 1
        if fire:
            _incident_note("oom_step", label=label,
                           dispatch=self.step_dispatches)
            raise RuntimeError(
                "RESOURCE_EXHAUSTED: Out of memory while trying to "
                f"allocate 17179869184 bytes (chaos: injected device OOM "
                f"on step {label!r} dispatch {self.step_dispatches})")

    def host_mem_pressure(self, poll_index: int) -> bool:
        """True at the governor's ``hostMemPressureAt``-th poll, once."""
        if not self.host_pressure_at:
            return False
        with self._lock:
            fire = (poll_index >= self.host_pressure_at and
                    self.pressure_fired == 0)
            if fire:
                self.pressure_fired = 1
        if fire:
            _incident_note("host_mem_pressure", poll=poll_index)
        return fire


_state: Optional[_ChaosState] = None


def install() -> None:
    """Arm the harness from the current ``bigdl.chaos.*`` keys; a new
    install starts a fresh plan.  Raises :class:`NotImplementedError` when
    a key outside the port's subset is set."""
    global _state
    refuse_unported_keys()
    _state = _ChaosState()


def uninstall() -> None:
    global _state
    _state = None


def active() -> bool:
    return _state is not None


def on_write(path: str, data: bytes) -> bytes:
    """``file_io`` payload-write hook (identity when disarmed)."""
    if _state is None:
        return data
    return _state.on_write(path, data)


def take_disk_full(path: str) -> None:
    """``file_io`` payload-write hook (no-op when disarmed)."""
    if _state is not None:
        _state.take_disk_full(path)


def corrupt_state_before_save(obj):
    """Checkpoint-capture hook (identity when disarmed)."""
    if _state is None:
        return obj
    return _state.corrupt_state_before_save(obj)


def on_step(neval: int) -> bool:
    """Training-loop hook; True means "report this iteration's loss as
    NaN"."""
    if _state is None:
        return False
    return _state.on_step(neval)


def take_bitflip() -> Optional[int]:
    """The float-leaf (or replica) index to flip now, or None."""
    if _state is None:
        return None
    return _state.take_bitflip()


def desync_replica() -> Tuple[int, int]:
    """``(iteration, replica)`` of the in-step desync, or ``(0, 0)``."""
    if _state is None:
        return (0, 0)
    return (_state.desync_at, _state.desync_replica)


def take_oom_dispatch(label: str) -> None:
    """Step-dispatch hook (no-op when disarmed)."""
    if _state is not None:
        _state.take_oom_dispatch(label)


def host_mem_pressure(poll_index: int) -> bool:
    """Governor-poll hook (False when disarmed)."""
    if _state is None:
        return False
    return _state.host_mem_pressure(poll_index)

