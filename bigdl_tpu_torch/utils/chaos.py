"""Chaos harness: configuration-driven fault injection for the training
loop, the checkpoint write path and the serving engines
(``bigdl_tpu/utils/chaos.py``, its training, checkpoint, serving and fleet
subset:
``install``/``uninstall``/``active`` :1074-1104, ``on_step`` :1105,
``take_bitflip`` :1227, ``desync_replica`` :1236, ``take_oom_dispatch``
:1256, ``host_mem_pressure`` :1272, the storage hooks ``on_write`` :1098 and
``take_disk_full`` :1264, ``corrupt_state_before_save`` :1247, the ingest
hooks :1198-1225 over :659-720, and the serving hooks :1144-1196, the fleet hooks ``kill_replica`` :1280,
``corrupt_candidate`` :1288 and ``sigterm_fleet`` :1297 over
``_ChaosState`` :533-657, :805-861).

The trainers' loop consults the harness once an iteration, the trainers'
step before each dispatch, ``utils.file_io.write_bytes`` on every payload
write and the checkpoint manager on every capture; ``ServingEngine``'s
batcher on every request it handles and before every dispatch,
``LMServingEngine``'s scheduler on every prompt it validates and before
every decode iteration, the open-loop load generators at every arrival, the
fleet at every submission and its rollout on every candidate it prepares.
The ingest stages (``dataset/ingest.py``) consult the record-read, decode,
stage-death and stage-throttle hooks on every record.  The keys, each read
at :func:`install`:

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
``bigdl.chaos.slowRequestAt``       "k" or "k:seconds": the k-th serving
                                    request the batcher handles stalls it
                                    for ``seconds`` (default 5), once; the
                                    requests queued behind it age past
                                    their deadlines.
``bigdl.chaos.poisonRequestAt``     "k" or "k:m": serving requests at
                                    admission positions k..m (0-based) read
                                    as poison (``ServingDataError``), once
                                    per position.
``bigdl.chaos.hangDispatchAt``      "k" or "k:seconds": the k-th serving
                                    batch dispatch (1-based) wedges for
                                    ``seconds`` (default 5), sleeping in
                                    20 ms slices on the batcher thread so
                                    the hung-dispatch watchdog's injected
                                    error lands within one slice, once.
``bigdl.chaos.burstArrivals``       "k" or "k:n": the open-loop load
                                    generators fire n extra back-to-back
                                    arrivals (default 8) at arrival
                                    position k (0-based), once.
``bigdl.chaos.poisonPromptAt``      "k" or "k:m": LM prompts at admission
                                    positions k..m (0-based) read as
                                    poison, once per position.
``bigdl.chaos.hangDecodeAt``        "k" or "k:seconds": the LM scheduler's
                                    k-th decode iteration (1-based) wedges
                                    for ``seconds`` (default 5) in 20 ms
                                    slices, once.
``bigdl.chaos.evictBlockAt``        k: at LM decode iteration k (1-based)
                                    one active sequence's KV blocks
                                    "evict": the engine sheds that stream
                                    retriably and frees its blocks, once.
``bigdl.chaos.killReplicaAt``       "k" or "k:replica": at the fleet's k-th
                                    submitted request, replica ``replica``
                                    (default 0) of the submitting service
                                    has its batcher thread killed with an
                                    asynchronously raised
                                    ``BaseException``, once; the fleet's
                                    supervisor sweeps its stranded requests
                                    into ``shed`` and restarts the slot.
``bigdl.chaos.corruptCandidateAt``  k: the k-th rollout candidate prepared
                                    gets one float of its parameters raised
                                    by 1.0 IN PLACE after the rollout took
                                    its expected fingerprint, once; the
                                    pre-cutover verification must roll it
                                    back.
``bigdl.chaos.sigtermFleetAt``      k: at the fleet's k-th submitted request
                                    the harness calls
                                    ``elastic.request_preemption`` once (a
                                    fleet-wide SIGTERM).
``bigdl.chaos.corruptRecordAt``     "k" or "k:m": ingest records k..m
                                    (0-based stream position) read as
                                    corrupt (:class:`CorruptRecord`, a data
                                    fault), once per position.
``bigdl.chaos.corruptRecordEvery``  n: every n-th ingest record (positions
                                    n, 2n, ...) reads corrupt, every pass.
``bigdl.chaos.failDecodeAt``        "k" or "k:m": records k..m decode to
                                    :class:`UndecodableImage`, once per
                                    position.
``bigdl.chaos.transientReads``      n: the first n ingest record reads raise
                                    a transient :class:`ChaosError`, then
                                    recover (the reader's capped-backoff
                                    retry absorbs them).
``bigdl.chaos.killStageThread``     "stage" or "stage:k" (``reader``,
                                    ``assembler`` or ``decode``): the stage
                                    dies silently at its k-th item (default
                                    1), once; the stage supervisor must
                                    restart it.
``bigdl.chaos.starveStageAt``       "stage:k" or "stage:k:seconds"
                                    (``read``, ``decode`` or ``assemble``):
                                    from its k-th item the stage pauses
                                    about 50 ms an item for ``seconds``
                                    (default 1.0), once; its downstream
                                    starves.
==================================  =========================================

``bigdl.chaos.lockDelayAt``         "<lockname>:k[:seconds]": the k-th
                                    acquisition of the named lock-witness
                                    lock (``analysis.make_lock`` names)
                                    stalls for ``seconds`` (default 0.05)
                                    just after the acquisition-order
                                    check, while the witness is armed;
                                    once per position per plan.

Every other ``bigdl.chaos.*`` key of the JAX package (the compile and audit
injectors) belongs to a part the port does not have yet:
:func:`install` raises :class:`NotImplementedError` when one is set
(:data:`UNPORTED_KEYS`), as do the trainers, both serving engines and
``StreamingIngest`` (:func:`refuse_unported_keys`), which also refuse the
JAX package's compile-cache, audit and device-budget keys when they ask for
what the port lacks (:data:`UNHONOURED_KEYS`).

Counters are process-local and count from :func:`install`; disarmed (the
default) every hook is a no-op behind one attribute check.
"""

from __future__ import annotations

import errno
import io
import sys as _sys
from typing import Optional, Tuple

from bigdl_tpu_torch.utils import config
from bigdl_tpu_torch.analysis.lockwitness import make_lock

#: the JAX package's injectors that the port does not have
UNPORTED_KEYS = (
    "bigdl.chaos.corruptCompileCacheAt", "bigdl.chaos.hangCompileAt",
    "bigdl.chaos.extraAllGather",
    "bigdl.chaos.f32Upcast", "bigdl.chaos.dropBucketCollective")


def _is_set(value) -> bool:
    return value not in (None, "", False, 0, "0", "false", "False")


def _positive(value) -> bool:
    return value not in (None, "") and float(value) > 0


def _strict(value) -> bool:
    return str(value).lower() == "strict"


def _true(value) -> bool:
    return str(value).lower() in ("1", "true", "yes", "on")


#: the JAX package's other keys of parts the port does not have, each with
#: the test of a value that asks for the missing behaviour: a directory, a
#: timeout, a budget or ``strict``.  The values that ask for nothing (unset,
#: 0, ``off``; ``warn``, whose JAX pass only logs) pass.
UNHONOURED_KEYS = {
    # the executable cache and compile watchdog (utils/compile_cache.py)
    "bigdl.compile.cacheDir": _is_set,
    "bigdl.compile.timeoutSec": _positive,
    "bigdl.compile.keepLast": _positive,
    "bigdl.compile.lockTimeoutSec": _positive,
    "bigdl.compile.lockStaleSec": _positive,
    # the static audit passes (analysis/program_contracts.py, hlo_audit.py)
    "bigdl.audit.collectives": _strict,
    "bigdl.audit.precision": _strict,
    "bigdl.audit.memory": _strict,
    # the fused step's device-memory preflight (resources/device.py)
    "bigdl.resources.deviceMemBudgetMB": _positive,
}


def refuse_unported_keys() -> None:
    """Raise :class:`NotImplementedError` naming every set key of
    :data:`UNPORTED_KEYS` and every key of :data:`UNHONOURED_KEYS` whose
    value asks for what the port lacks.  Called where the trainers, both
    serving engines and ``StreamingIngest`` start, and by
    :func:`install`."""
    asked = [k for k in UNPORTED_KEYS if _is_set(config.get_property(k))]
    asked += [f"{k}={config.get_property(k)!r}"
              for k, asks in UNHONOURED_KEYS.items()
              if asks(config.get_property(k))]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: these keys ask for parts of the JAX "
            "package that are not ported yet")


class ChaosError(IOError):
    """An injected storage or step fault.  An ``IOError``, so the code
    under test cannot tell it from a real infrastructure failure."""


def _incident_note(kind: str, **fields) -> None:
    """Record the injection in the incident ring, so that a bundle names
    the fault a run was put through (looked up, never imported)."""
    mod = _sys.modules.get("bigdl_tpu_torch.telemetry.incident")
    if mod is not None:
        mod.record(f"chaos/{kind}", **fields)


class CorruptRecord(ChaosError):
    """An injected corrupt ingest record: a data fault, quarantined and
    never retried (corrupt bytes read again are still corrupt)."""

    fatal = True

    def __init__(self, index: int):
        super().__init__(f"chaos: corrupt record at stream position "
                         f"{index}")
        self.index = index


class UndecodableImage(ChaosError):
    """An injected decode failure: a record whose bytes are not an
    image."""

    fatal = True

    def __init__(self, index: int):
        super().__init__(
            f"chaos: undecodable image at stream position {index}")
        self.index = index


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


def _parse_burst(value) -> Tuple[int, int]:
    """``"k"`` -> (k, 8); ``"k:n"`` -> (k, n); unset -> (-1, 0): the
    position sentinel is -1, so arrival position 0 stays armable."""
    if value is None or value == "":
        return (-1, 0)
    s = str(value)
    if ":" in s:
        k, n = s.split(":", 1)
        return (int(k), int(n))
    return (int(s), 8)


def _wedge(seconds: float) -> None:
    """Sleep ``seconds`` in 20 ms slices: the interruptible stand-in for a
    wedged device call (an asynchronous exception lands within a slice)."""
    import time
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        time.sleep(0.02)


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


def _nudge_first_float(obj) -> bool:
    """Raise the first element of the first float tensor reachable from
    ``obj`` (a module's parameters and buffers in their order, or dicts,
    lists and tuples of tensors) by 1.0 in place.  True when something
    changed."""
    import torch
    if isinstance(obj, torch.nn.Module):
        obj = list(obj.state_dict(keep_vars=True).values())
    if isinstance(obj, torch.Tensor):
        if obj.is_floating_point() and obj.numel():
            with torch.no_grad():
                obj.view(-1)[0] += 1.0
            return True
        return False
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_nudge_first_float(v) for v in obj)
    return False


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
        self.corrupt_record_at = _parse_span(
            config.get_property("bigdl.chaos.corruptRecordAt"))
        self.corrupt_record_every = config.get_int(
            "bigdl.chaos.corruptRecordEvery", 0)
        self.fail_decode_at = _parse_span(
            config.get_property("bigdl.chaos.failDecodeAt"))
        self.transient_reads = config.get_int(
            "bigdl.chaos.transientReads", 0)
        self.kill_stage, self.kill_stage_after = _parse_kill(
            config.get_property("bigdl.chaos.killStageThread"))
        (self.starve_stage_name, self.starve_stage_after,
         self.starve_stage_seconds) = _parse_starve(
            config.get_property("bigdl.chaos.starveStageAt"))
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
        self.slow_request_at, self.slow_request_seconds = _parse_stall(
            config.get_property("bigdl.chaos.slowRequestAt"))
        self.poison_request_at = _parse_span(
            config.get_property("bigdl.chaos.poisonRequestAt"))
        self.hang_dispatch_at, self.hang_dispatch_seconds = _parse_stall(
            config.get_property("bigdl.chaos.hangDispatchAt"))
        self.burst_arrivals_at, self.burst_arrivals_n = _parse_burst(
            config.get_property("bigdl.chaos.burstArrivals"))
        self.poison_prompt_at = _parse_span(
            config.get_property("bigdl.chaos.poisonPromptAt"))
        self.hang_decode_at, self.hang_decode_seconds = _parse_stall(
            config.get_property("bigdl.chaos.hangDecodeAt"))
        self.evict_block_at = config.get_int("bigdl.chaos.evictBlockAt", 0)
        self.kill_replica_at, self.kill_replica_index = _parse_indexed(
            config.get_property("bigdl.chaos.killReplicaAt"), 0)
        self.corrupt_candidate_at = config.get_int(
            "bigdl.chaos.corruptCandidateAt", 0)
        self.sigterm_fleet_at = config.get_int(
            "bigdl.chaos.sigtermFleetAt", 0)
        (self.lock_delay_name, self.lock_delay_at,
         self.lock_delay_seconds) = _parse_lock_delay(
            config.get_property("bigdl.chaos.lockDelayAt"))
        self.writes = 0
        self.steps_failed = 0
        self.steps_seen = 0
        self.transient_raised = 0
        self.transient_reads_raised = 0
        self.record_faults_fired: set = set()   # positions fired once
        self.decode_faults_fired: set = set()
        self.stage_kills = 0
        self.stage_starve_started: Optional[float] = None
        self.stage_starve_done = False
        self.stage_starve_throttles = 0
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
        self.serving_requests = 0
        self.request_stalls = 0
        self.poison_fired: set = set()
        self.dispatches = 0
        self.dispatch_hangs = 0
        self.bursts_fired: set = set()
        self.prompt_poison_fired: set = set()
        self.decode_hangs = 0
        self.block_evictions = 0
        self.replica_kills = 0
        self.candidates_prepared = 0
        self.candidate_corruptions = 0
        self.fleet_sigterms = 0
        self.lock_delays_fired: set = set()
        self.lock_delays = 0
        self._lock = make_lock("chaos.plan")

    # ---- the lock witness ----------------------------------------------

    def lock_delay(self, name: str, n: int) -> float:
        """Seconds the ``n``-th acquisition of witness lock ``name`` should
        stall (0.0 almost always); once per position per plan."""
        if not self.lock_delay_name or name != self.lock_delay_name:
            return 0.0
        if n != self.lock_delay_at:
            return 0.0
        with self._lock:
            if n in self.lock_delays_fired:
                return 0.0
            self.lock_delays_fired.add(n)
            self.lock_delays += 1
        return self.lock_delay_seconds

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


    # ---- the ingest stages ---------------------------------------------

    def on_record_read(self, index: int) -> None:
        """The reader stage, with each record's 0-based stream position
        before it hands the record on: a transient :class:`ChaosError` for
        the first ``transientReads`` reads, a :class:`CorruptRecord` in the
        ``corruptRecordAt`` span (once per position) or on the
        ``corruptRecordEvery`` grid."""
        with self._lock:
            if self.transient_reads_raised < self.transient_reads:
                self.transient_reads_raised += 1
                raise ChaosError(
                    f"chaos: transient read failure "
                    f"{self.transient_reads_raised}/{self.transient_reads} "
                    f"on record {index}")
        lo, hi = self.corrupt_record_at
        if hi >= 0 and lo <= index <= hi:
            with self._lock:
                fire = index not in self.record_faults_fired
                self.record_faults_fired.add(index)
            if fire:     # a fresh epoch's pass is not dirtied again
                raise CorruptRecord(index)
        if (self.corrupt_record_every and
                index and index % self.corrupt_record_every == 0):
            raise CorruptRecord(index)

    def on_decode(self, index: int) -> None:
        """Before a record's decode: :class:`UndecodableImage` inside the
        ``failDecodeAt`` span, once per position."""
        lo, hi = self.fail_decode_at
        if hi >= 0 and lo <= index <= hi:
            with self._lock:
                fire = index not in self.decode_faults_fired
                self.decode_faults_fired.add(index)
            if fire:
                raise UndecodableImage(index)

    def kill_stage_thread(self, stage: str, items: int) -> bool:
        """True once, when the named stage has handled its
        ``killStageThread`` item count: the stage then ends silently (no
        error, no done flag), a crashed thread for the supervisor."""
        if self.kill_stage != stage or items < self.kill_stage_after:
            return False
        with self._lock:
            if self.stage_kills:
                return False        # one death per plan, not per restart
            self.stage_kills = 1
        return True

    def starve_stage(self, stage: str, items: int) -> None:
        """Each stage calls this with its running item count: from the
        named stage's ``starveStageAt``-th item every call pauses up to
        50 ms until ``seconds`` after the first pause; once per plan."""
        import time
        if (self.starve_stage_name != stage or self.stage_starve_done or
                items < self.starve_stage_after):
            return
        with self._lock:
            if self.stage_starve_started is None:
                self.stage_starve_started = time.monotonic()
            remaining = (self.stage_starve_started +
                         self.starve_stage_seconds - time.monotonic())
            if remaining <= 0:
                self.stage_starve_done = True
                return
            self.stage_starve_throttles += 1
        time.sleep(min(0.05, remaining))

    # ---- the serving engines -------------------------------------------

    def on_serving_request(self, index: int) -> None:
        """The serving batcher begins handling a dequeued request (``index``
        is its admission position): the ``slowRequestAt``-th one handled
        stalls the batcher, once."""
        if not self.slow_request_at:
            return
        with self._lock:
            self.serving_requests += 1
            fire = (self.serving_requests == self.slow_request_at and
                    self.request_stalls == 0)
            if fire:
                self.request_stalls = 1
        if fire:
            import time
            time.sleep(self.slow_request_seconds)

    @staticmethod
    def _poison(span: Tuple[int, int], fired: set, lock, index: int,
                kind: str) -> bool:
        lo, hi = span
        if not (hi >= 0 and lo <= index <= hi):
            return False
        with lock:
            fire = index not in fired
            fired.add(index)
        if fire:
            _incident_note(kind, index=index)
        return fire

    def poison_request(self, index: int) -> bool:
        """True when the serving request at admission position ``index``
        (0-based) reads as poison, once per position (a retried request is
        not poisoned again)."""
        return self._poison(self.poison_request_at, self.poison_fired,
                            self._lock, index, "poison_request")

    def on_dispatch(self, label: str = "") -> None:
        """Before each serving batch dispatch: the ``hangDispatchAt``-th
        wedges interruptibly, once."""
        if not self.hang_dispatch_at:
            return
        with self._lock:
            self.dispatches += 1
            fire = (self.dispatches == self.hang_dispatch_at and
                    self.dispatch_hangs == 0)
            if fire:
                self.dispatch_hangs = 1
        if fire:
            _incident_note("hang_dispatch", dispatch=self.dispatches,
                           seconds=self.hang_dispatch_seconds)
            _wedge(self.hang_dispatch_seconds)

    def poison_prompt(self, index: int) -> bool:
        """True when the LM prompt at admission position ``index`` (0-based)
        reads as poison, once per position."""
        return self._poison(self.poison_prompt_at, self.prompt_poison_fired,
                            self._lock, index, "poison_prompt")

    def on_decode_step(self, step: int) -> None:
        """Before each LM decode iteration (``step`` 1-based): the
        ``hangDecodeAt``-th wedges interruptibly, once."""
        if not self.hang_decode_at:
            return
        with self._lock:
            fire = step >= self.hang_decode_at and self.decode_hangs == 0
            if fire:
                self.decode_hangs = 1
        if fire:
            _incident_note("hang_decode", step=step,
                           seconds=self.hang_decode_seconds)
            _wedge(self.hang_decode_seconds)

    def evict_block(self, step: int) -> bool:
        """True when one active sequence's KV blocks evict at LM decode
        iteration ``step`` (1-based), once."""
        if not self.evict_block_at:
            return False
        with self._lock:
            fire = step >= self.evict_block_at and self.block_evictions == 0
            if fire:
                self.block_evictions = 1
        if fire:
            _incident_note("evict_block", step=step)
        return fire

    def burst_arrivals(self, index: int) -> int:
        """Extra back-to-back arrivals to fire at arrival position
        ``index`` (0-based): n at the configured position, else 0; once per
        position."""
        if self.burst_arrivals_at < 0 or index != self.burst_arrivals_at:
            return 0
        with self._lock:
            fire = index not in self.bursts_fired
            self.bursts_fired.add(index)
        return self.burst_arrivals_n if fire else 0

    # ---- the fleet -----------------------------------------------------

    def kill_replica(self, submits: int) -> Optional[int]:
        """The replica index whose batcher to kill now, or None: fires once
        when the fleet's submitted-request count reaches
        ``killReplicaAt``."""
        if not self.kill_replica_at:
            return None
        with self._lock:
            fire = (submits >= self.kill_replica_at and
                    self.replica_kills == 0)
            if fire:
                self.replica_kills = 1
        if fire:
            _incident_note("kill_replica", submits=submits,
                           replica=self.kill_replica_index)
        return self.kill_replica_index if fire else None

    def corrupt_candidate(self, model) -> bool:
        """Called by the rollout with each candidate AFTER its expected
        fingerprint was taken: the ``corruptCandidateAt``-th candidate gets
        one float raised by 1.0 in place (no protective copy: the
        candidate is what would serve).  True when it changed; once."""
        if not self.corrupt_candidate_at:
            return False
        with self._lock:
            self.candidates_prepared += 1
            fire = (self.candidates_prepared == self.corrupt_candidate_at
                    and self.candidate_corruptions == 0)
            if fire:
                self.candidate_corruptions = 1
        if not fire:
            return False
        _incident_note("corrupt_candidate",
                       candidate=self.candidates_prepared)
        return _nudge_first_float(model)

    def sigterm_fleet(self, submits: int) -> bool:
        """Requests preemption once when the fleet's submitted-request count
        reaches ``sigtermFleetAt``: the flag a SIGTERM handler sets."""
        if not self.sigterm_fleet_at:
            return False
        with self._lock:
            fire = (submits >= self.sigterm_fleet_at and
                    self.fleet_sigterms == 0)
            if fire:
                self.fleet_sigterms = 1
        if fire:
            from bigdl_tpu_torch.utils import elastic
            _incident_note("sigterm_fleet", submits=submits)
            elastic.request_preemption("chaos: injected fleet-wide SIGTERM")
        return fire


def _parse_kill(value) -> Tuple[Optional[str], int]:
    """``"stage"`` -> (stage, 1); ``"stage:k"`` -> (stage, k); falsy ->
    (None, 0)."""
    if not value:
        return (None, 0)
    s = str(value)
    if ":" in s:
        stage, k = s.split(":", 1)
        return (stage.strip(), int(k))
    return (s.strip(), 1)


def _parse_starve(value) -> Tuple[Optional[str], int, float]:
    """``"stage:k"`` -> (stage, k, 1.0); ``"stage:k:seconds"`` ->
    (stage, k, seconds); falsy -> (None, 0, 0.0)."""
    if not value:
        return (None, 0, 0.0)
    parts = str(value).split(":")
    stage = parts[0].strip()
    k = int(parts[1]) if len(parts) > 1 else 1
    secs = float(parts[2]) if len(parts) > 2 else 1.0
    return (stage, k, secs)


def _parse_lock_delay(value) -> Tuple[Optional[str], int, float]:
    """``"lockname:k"`` -> (lockname, k, 0.05); ``"lockname:k:seconds"``
    -> (lockname, k, seconds); falsy -> (None, 0, 0.0)."""
    if not value:
        return (None, 0, 0.0)
    parts = str(value).split(":")
    name = parts[0].strip()
    k = int(parts[1]) if len(parts) > 1 else 1
    secs = float(parts[2]) if len(parts) > 2 else 0.05
    return (name, k, secs)


_state: Optional[_ChaosState] = None


def install() -> None:
    """Arm the harness from the current ``bigdl.chaos.*`` keys; a new
    install starts a fresh plan.  Raises :class:`NotImplementedError` when
    a key outside the port's subset is set.  The ``lockDelayAt`` target is
    pushed into the lock witness, whose armed acquire path then pays one
    attribute compare instead of a probe here per acquisition."""
    global _state
    refuse_unported_keys()
    _state = _ChaosState()
    from bigdl_tpu_torch.analysis import lockwitness
    lockwitness.set_chaos_delay_target(_state.lock_delay_name or None)


def uninstall() -> None:
    global _state
    _state = None
    from bigdl_tpu_torch.analysis import lockwitness
    lockwitness.set_chaos_delay_target(None)


def lock_delay(name: str, n: int) -> float:
    """The lock witness's acquire hook: seconds the ``n``-th acquisition of
    the named witness lock should stall (0.0 when disarmed)."""
    if _state is None:
        return 0.0
    return _state.lock_delay(name, n)


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



def on_serving_request(index: int) -> None:
    """Serving batcher per-request hook (no-op when disarmed)."""
    if _state is not None:
        _state.on_serving_request(index)


def poison_request(index: int) -> bool:
    """True when this serving admission position reads as poison now
    (False when disarmed)."""
    if _state is None:
        return False
    return _state.poison_request(index)


def on_dispatch(label: str = "") -> None:
    """Serving batch-dispatch hook (no-op when disarmed)."""
    if _state is not None:
        _state.on_dispatch(label)


def poison_prompt(index: int) -> bool:
    """True when this LM admission position's prompt reads as poison now
    (False when disarmed)."""
    if _state is None:
        return False
    return _state.poison_prompt(index)


def on_decode_step(step: int) -> None:
    """LM decode-iteration hook (no-op when disarmed)."""
    if _state is not None:
        _state.on_decode_step(step)


def evict_block(step: int) -> bool:
    """True when one active sequence's KV blocks evict now (False when
    disarmed)."""
    if _state is None:
        return False
    return _state.evict_block(step)


def burst_arrivals(index: int) -> int:
    """Extra arrivals for the load generators at this position (0 when
    disarmed)."""
    if _state is None:
        return 0
    return _state.burst_arrivals(index)


def kill_replica(submits: int) -> Optional[int]:
    """Fleet submit hook (None when disarmed): the replica index whose
    batcher thread to kill now."""
    if _state is None:
        return None
    return _state.kill_replica(submits)


def corrupt_candidate(model) -> bool:
    """Rollout candidate hook (False when disarmed): True when the
    candidate's weights were changed in place."""
    if _state is None:
        return False
    return _state.corrupt_candidate(model)


def sigterm_fleet(submits: int) -> bool:
    """Fleet submit hook (False when disarmed): requests preemption at the
    ``sigtermFleetAt``-th submitted request."""
    if _state is None:
        return False
    return _state.sigterm_fleet(submits)


def on_record_read(index: int) -> None:
    """Ingest reader-stage hook (no-op when disarmed): transient read blips
    and corrupt records by stream position."""
    if _state is not None:
        _state.on_record_read(index)


def on_decode(index: int) -> None:
    """Ingest decode-stage hook (no-op when disarmed)."""
    if _state is not None:
        _state.on_decode(index)


def kill_stage_thread(stage: str, items: int) -> bool:
    """Ingest stage-death hook: True means "end silently now" (once per
    plan; False when disarmed)."""
    if _state is None:
        return False
    return _state.kill_stage_thread(stage, items)


def starve_stage(stage: str, items: int) -> None:
    """Ingest stage-throttle hook (no-op when disarmed)."""
    if _state is not None:
        _state.starve_stage(stage, items)
