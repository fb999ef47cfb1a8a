"""The stage-pipelined ingest engine of the real-data path
(``bigdl_tpu/dataset/ingest.py``; reference
``dataset/image/MTLabeledBGRImgToBatch.scala:46``).

    sharded seqfile readers -> record ring -> decode pool -> ordered decode
    window -> assembler (native pack, GIL released) -> batch ring ->
    consumer (-> engine.BatchPrefetcher, which copies batches to the card
    ahead of the step)

Every stage is decoupled by a bounded ring and counted (:class:`StageStats`:
items, busy seconds, *starve* seconds waiting for the stage upstream,
*backpressure* seconds blocked on a full ring downstream, mean ring
occupancy); :meth:`StreamingIngest.stats` snapshots them per stage.

Determinism (the JAX package's contract, its module docstring :24-38): crop
offsets and flips are drawn from a *clone* of the caller's
:class:`~bigdl_tpu_torch.utils.random_generator.RandomGenerator` in strict
record order, and each batch carries the clone's state after its draws,
which is committed to the caller's generator only when the batch is
consumed.  Read-ahead that is thrown away (an epoch rollover replacing the
chain) never moves the caller's stream, so the engine gives the batches of
the synchronous :class:`~bigdl_tpu_torch.dataset.mt_batch.
MTLabeledBGRImgToBatch`, bit for bit, at every ring depth and worker count.
With several engines forked from one stream (a multi-shard
``ShardedDataSet``) only the first commits; the others draw from
deterministically reseeded forks.

Self-healing (JAX :40-60).  Data faults (a corrupt record, an undecodable
image, an undersized frame) raise :class:`IngestDataError`: with
``bigdl.ingest.maxBadRecords`` > 0 the one record is skipped into a bounded
:class:`RecordQuarantine`, else the error raises at the consumer.
Infrastructure faults are retried or restarted: each record read runs
behind ``utils.file_io.retrying``'s capped-backoff transient retry (a blip
that outlasts it raises :class:`IngestInfraError`, where the JAX package
raises the blip itself); a
:class:`_StageSupervisor` restarts a reader or assembler thread that died
silently and the assembler resubmits a dead decode worker's record, up to
``bigdl.ingest.maxStageRestarts`` each (default 2), then the engine is
declared dead (:class:`IngestInfraError`); with
``bigdl.ingest.stallTimeoutSec`` > 0 a run whose rings and stages make no
progress while the consumer waits is declared dead with
:class:`IngestStallError`, every stage's stats in its ``diagnosis``.  With
``bigdl.ingest.fallbackOnFailure`` a dead engine finishes the epoch on the
synchronous path, with the same drawer and quarantine, so the batches go on
bit-identically.  The chaos keys ``corruptRecordAt``,
``corruptRecordEvery``, ``failDecodeAt``, ``transientReads``,
``killStageThread`` and ``starveStageAt`` (``utils/chaos.py``) drive each
fault.

The same supervisor runs the decode-pool autoscaler
(``bigdl.ingest.autoscale.*``, on by default as in the JAX package): every
``intervalSec`` the assemble stage's starve and backpressure fractions go
to the deterministic :class:`AutoscalePolicy`, which adds or retires a
decode worker (and a native assemble thread).  It changes timing, never the
batches.  With ``bigdl.ingest.epochCache`` the decode stage asks a
:class:`~bigdl_tpu_torch.dataset.epoch_cache.DecodedEpochCache` first, for
the engine's lifetime.  With ``device_jitter`` each record also draws an
int32 ColorJitter seed from the same clone-and-commit stream, after its
crop and flip, packed as a fourth input for ``nn.DeviceAugment``.

Host memory: the record ring, the batch ring and the decode window keep
the governor's ``ingest_record_ring``, ``ingest_batch_ring`` and
``ingest_decode_window`` accounts current; under pressure the decode window
drops to 1 and a run-scoped shrinker halves the rings and the window; a
batch larger than the whole budget raises ``HostMemoryError``.

Closing.  A close (the run's generator closed, or exhausted) stops the
supervisor, sets ``stop``, which every blocking wait of a stage thread
polls, and joins the supervisor, every stage thread and every decode
thread within :data:`JOIN_TIMEOUT_S`: a thread still held then by work in
hand (an upstream read, a decode) makes the close raise
:class:`IngestInfraError` naming it, never return with it alive.

Telemetry (JAX :209-213, :1268-1377, :1803-1864): the ``Ingest/quarantined``,
``Ingest/stage_errors``, ``Ingest/engine_failures``,
``Ingest/stage_restarts``, ``Ingest/fallbacks`` and
``Ingest/autoscale_{up,down}`` counters, the spans ``ingest/read``,
``ingest/decode``, ``ingest/assemble`` and ``ingest/seqfile_read`` on the
stage threads' lanes (``ingest-reader``, ``ingest-decode-<i>``,
``ingest-assembler``, ``ingest-seqread<i>``), :func:`summary_scalars`, the
registry's ``ingest`` provider, and :func:`_stall_diagnostics`, the
watchdog's ``ingest`` stall diagnostic (both registered when a run starts).
What stays optional: a fused crop/flip/transpose gather on the card
(``DeviceAugment`` is a PyTorch index gather).
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
import weakref
from collections import deque
from concurrent import futures
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch import telemetry
from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.resources.governor import GOVERNOR as _governor
from bigdl_tpu_torch.resources.governor import item_nbytes as _item_nbytes
from bigdl_tpu_torch.utils import chaos, config
from bigdl_tpu_torch.analysis.lockwitness import make_lock

logger = logging.getLogger("bigdl_tpu_torch")

#: live engines, for the summary layer and the trainers' end-of-run log
#: (weak: an abandoned engine is not pinned by what observes it)
_LIVE: "weakref.WeakSet" = weakref.WeakSet()

_END = object()          # upstream exhausted
_NO_ITEM = object()      # a get that gave up

_NAME_LOCK = make_lock("ingest.name")

#: seconds a close waits for each stage thread to end once ``stop`` is set;
#: a thread still alive then makes the close raise :class:`IngestInfraError`
JOIN_TIMEOUT_S = 30.0
_NAME_SEQ = [0]          # per-process engine names: ingest0, ingest1, ...


# ---------------------------------------------------------------------------
# error taxonomy + quarantine
# ---------------------------------------------------------------------------

class IngestDataError(Exception):
    """A fault in the data (corrupt record, undecodable image, undersized
    frame): skipping the record is right, retrying it is not."""

    fatal = True


class IngestInfraError(RuntimeError):
    """The ingest machinery failed beyond its restart budget, or a close
    could not join a thread; ``diagnosis`` holds the engine's per-stage
    ``stats()`` at the time."""

    def __init__(self, message: str, diagnosis: Optional[dict] = None):
        super().__init__(message)
        self.diagnosis = diagnosis or {}


class IngestStallError(IngestInfraError):
    """No ring and no stage made progress for
    ``bigdl.ingest.stallTimeoutSec`` while the consumer waited: a wedged
    hand-off, detected instead of hung."""


class QuarantineExceededError(IngestInfraError):
    """More data errors than ``bigdl.ingest.maxBadRecords``; the message
    names a sample of the offenders."""


def _is_data_error(e: BaseException) -> bool:
    from bigdl_tpu_torch.dataset.seqfile import CorruptRecordError
    return isinstance(e, (IngestDataError, CorruptRecordError,
                          chaos.CorruptRecord, chaos.UndecodableImage))


class _StageKilledError(RuntimeError):
    """A decode worker's silent death (chaos): an infrastructure fault the
    assembler answers by resubmitting the decode (bounded), never by
    quarantining the record (its bytes are fine)."""


class RecordQuarantine:
    """Bounded sink for records with data errors.  ``admit`` counts and
    samples the fault while the budget lasts, raises the original error when
    the budget is 0 (fail fast), and :class:`QuarantineExceededError` once a
    nonzero budget is spent.  The samples are accounted to the governor's
    ``ingest_quarantine`` account.  Thread-safe."""

    SAMPLE_MAX = 8

    def __init__(self, budget: Optional[int] = None):
        if budget is None:
            budget = config.get_int("bigdl.ingest.maxBadRecords", 0)
        self.budget = int(budget)
        self.count = 0                       # guarded-by: _lock
        self.by_stage: dict = {}             # guarded-by: _lock
        self.samples: List[dict] = []        # guarded-by: _lock
        self._lock = make_lock("ingest.quarantine")

    def admit(self, stage: str, index: Optional[int], name: Optional[str],
              error: BaseException) -> None:
        if self.budget <= 0:
            raise error
        with self._lock:
            self.count += 1
            self.by_stage[stage] = self.by_stage.get(stage, 0) + 1
            if len(self.samples) < self.SAMPLE_MAX:
                sample = {"stage": stage, "index": index, "name": name,
                          "error": repr(error)}
                self.samples.append(sample)
                _governor.account("ingest_quarantine").add(
                    _item_nbytes(sample))
            over = self.count > self.budget
        telemetry.counter(
            "Ingest/quarantined", summary=True,
            help="data-error records skipped by the ingest quarantine"
        ).inc()
        telemetry.counter("Ingest/stage_errors", labels={"stage": stage},
                          help="data errors observed per ingest stage").inc()
        if over:
            raise QuarantineExceededError(
                f"ingest quarantine budget exhausted: {self.count} bad "
                f"records > bigdl.ingest.maxBadRecords={self.budget}; "
                f"offender sample: {self.samples}",
                diagnosis={"quarantine": self.summary()}) from error
        logger.warning("ingest quarantined record %s (%s) at stage %s: %r "
                       "[%d/%d budget]", index, name, stage, error,
                       self.count, self.budget)

    def summary(self) -> dict:
        with self._lock:
            return {"count": self.count, "budget": self.budget,
                    "by_stage": dict(self.by_stage),
                    "samples": list(self.samples)}


# ---------------------------------------------------------------------------
# stage counters, rings, the decode pool
# ---------------------------------------------------------------------------

class StageStats:
    """Counters of one pipeline stage: ``items`` and ``busy_s`` of its own
    work, ``starve_s`` blocked on its upstream ring, ``backpressure_s``
    blocked on a full downstream ring.  The bottleneck stage has the least
    stall and the highest busy share."""

    def __init__(self, name: str):
        self.name = name
        self._lock = make_lock("ingest.stage_stats")
        self.items = 0
        self.busy_s = 0.0
        self.starve_s = 0.0
        self.backpressure_s = 0.0
        self._occ_sum = 0
        self._occ_n = 0
        self._t0 = time.monotonic()

    def add(self, items: int = 0, busy_s: float = 0.0,
            starve_s: float = 0.0, backpressure_s: float = 0.0) -> None:
        with self._lock:
            self.items += items
            self.busy_s += busy_s
            self.starve_s += starve_s
            self.backpressure_s += backpressure_s

    def sample_occupancy(self, depth: int) -> None:
        with self._lock:
            self._occ_sum += depth
            self._occ_n += 1

    def stall_seconds(self) -> Tuple[float, float]:
        """(starve_s, backpressure_s): the autoscaler's raw signals."""
        with self._lock:
            return self.starve_s, self.backpressure_s

    def snapshot(self) -> dict:
        with self._lock:
            wall = max(time.monotonic() - self._t0, 1e-9)
            return {
                "items": self.items,
                "throughput_per_sec": round(self.items / wall, 1),
                "busy_s": round(self.busy_s, 3),
                "starve_s": round(self.starve_s, 3),
                "backpressure_s": round(self.backpressure_s, 3),
                "stall_frac": round(
                    (self.starve_s + self.backpressure_s) / wall, 3),
                "mean_queue_depth": round(self._occ_sum / self._occ_n, 2)
                if self._occ_n else 0.0,
            }


class _Ring:
    """Bounded queue between two stages: ``put`` charges its blocked time
    to the producing stage's backpressure, ``get`` to the consuming stage's
    starve.  Both poll ``stop`` so that teardown never deadlocks.

    ``limit`` is the dynamic depth: it starts at ``depth`` and the
    governor's shrinker may halve it (:meth:`shrink`); a ring at its limit
    behaves as a full one.  ``account``/``sizer`` keep a governor byte
    ledger current as items enter and leave.  ``last_progress`` is the
    monotonic time of the last put or get: the supervisor's stall signal
    and the watchdog's ring age."""

    POLL_S = 0.05

    def __init__(self, depth: int, producer: Optional[StageStats] = None,
                 consumer: Optional[StageStats] = None,
                 account=None, sizer=None):
        depth = max(1, int(depth))
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.limit = depth
        self._producer = producer
        self._consumer = consumer
        self._account = account
        self._sizer = sizer
        self._hb_lock = make_lock("ingest.ring")
        self.last_progress = time.monotonic()    # guarded-by: _hb_lock

    def shrink(self) -> int:
        """Halve the dynamic depth (floor 1); returns the new limit."""
        self.limit = max(1, self.limit // 2)
        return self.limit

    def _beat(self) -> None:
        with self._hb_lock:
            self.last_progress = time.monotonic()

    def _charge(self, item, sign: int) -> None:
        if self._account is None:
            return
        try:
            n = self._sizer(item) if self._sizer is not None else 0
        except Exception:       # accounting must never break the stage
            n = 0
        if n:
            (self._account.add if sign > 0 else self._account.sub)(n)

    def put(self, item, stop: Optional[threading.Event]) -> bool:
        t0 = None
        while stop is None or not stop.is_set():
            if self.q.qsize() >= self.limit:
                # at (or shrunk below) the dynamic depth: a full ring
                if t0 is None:
                    t0 = time.monotonic()
                if stop is None:
                    time.sleep(self.POLL_S)
                else:
                    stop.wait(self.POLL_S)
                continue
            try:
                self.q.put(item, timeout=self.POLL_S)
            except queue.Full:
                if t0 is None:
                    t0 = time.monotonic()
                continue
            self._beat()
            self._charge(item, +1)
            if self._producer is not None:
                if t0 is not None:
                    self._producer.add(backpressure_s=time.monotonic() - t0)
                self._producer.sample_occupancy(self.q.qsize())
            return True
        if t0 is not None and self._producer is not None:
            self._producer.add(backpressure_s=time.monotonic() - t0)
        return False

    def get(self, stop: Optional[threading.Event]):
        t0 = None
        try:
            while stop is None or not stop.is_set():
                try:
                    item = self.q.get(timeout=self.POLL_S)
                except queue.Empty:
                    if t0 is None:
                        t0 = time.monotonic()
                    continue
                self._beat()
                self._charge(item, -1)
                return item
            return _NO_ITEM
        finally:
            if t0 is not None and self._consumer is not None:
                self._consumer.add(starve_s=time.monotonic() - t0)

    def try_get(self):
        try:
            item = self.q.get_nowait()
        except queue.Empty:
            return _NO_ITEM
        self._charge(item, -1)
        return item

    def drain(self) -> None:
        while self.try_get() is not _NO_ITEM:
            pass


def join_threads(threads: Sequence[threading.Thread], what: str) -> None:
    """Join ``threads`` within :data:`JOIN_TIMEOUT_S` seconds in all; raise
    :class:`IngestInfraError` naming every thread still alive then, rather
    than return with it running."""
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    alive = sorted(t.name for t in threads if t.is_alive())
    if alive:
        raise IngestInfraError(
            f"{what}: threads {alive} still alive after the close waited "
            f"{JOIN_TIMEOUT_S:g} s for them")


class _DecodePool:
    """Resizable decode worker pool, the autoscaler's actuator (JAX
    :579-672).  Workers take ``(future, fn, args)`` tickets and resolve real
    :class:`concurrent.futures.Future` objects, so the assembler reads a
    decode's result or its exception from the future.  :meth:`set_workers`
    grows the pool at once and shrinks it cooperatively: a surplus worker
    ends between tickets, never in a decode.  The tickets in flight are
    bounded by the assembler's decode window, the only submitter.
    :attr:`threads` holds every worker ever started, for the owner's
    join."""

    def __init__(self, workers: int, thread_name_prefix: str = "decode"):
        self._tickets: "queue.Queue" = queue.Queue()
        self._prefix = thread_name_prefix
        self._lock = make_lock("ingest.decode_pool")
        self._target = max(1, int(workers))     # guarded-by: _lock
        self._alive = 0                         # guarded-by: _lock
        self._seq = 0                           # guarded-by: _lock
        self._shutdown = False                  # guarded-by: _lock
        self.threads: List[threading.Thread] = []
        for _ in range(self._target):
            self._spawn()

    def _spawn(self) -> None:
        with self._lock:
            self._alive += 1
            self._seq += 1
            name = f"{self._prefix}-{self._seq}"
        t = threading.Thread(target=self._worker, daemon=True, name=name)
        self.threads.append(t)
        t.start()

    def _worker(self) -> None:
        while True:
            with self._lock:
                if self._shutdown or self._alive > self._target:
                    self._alive -= 1
                    return
            try:
                fut, fn, args = self._tickets.get(timeout=0.1)
            except queue.Empty:
                continue
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args))
            except BaseException as e:  # noqa: BLE001 surfaces at result()
                fut.set_exception(e)

    @property
    def workers(self) -> int:
        return self._target

    def set_workers(self, n: int) -> int:
        """Resize towards ``n`` (floor 1); returns the new target."""
        n = max(1, int(n))
        with self._lock:
            if self._shutdown:
                return self._target
            grow = n - self._target
            self._target = n
        for _ in range(grow):
            self._spawn()
        return n

    def submit(self, fn, *args) -> "futures.Future":
        fut: "futures.Future" = futures.Future()
        self._tickets.put((fut, fn, args))
        return fut

    def shutdown(self, cancel_futures: bool = False) -> None:
        """Stop the workers (each ends after its ticket in hand) and cancel
        the queued tickets if asked; the owner joins :attr:`threads`
        (:func:`join_threads`)."""
        with self._lock:
            self._shutdown = True
        if cancel_futures:
            try:
                while True:
                    fut, _fn, _args = self._tickets.get_nowait()
                    fut.cancel()
            except queue.Empty:
                pass


class AutoscalePolicy:
    """Deterministic hysteresis policy of the decode-pool autoscaler (JAX
    :675-740, the same state machine).  No clocks, no randomness: one
    sequence of signals always gives one sequence of actions.

    Each :meth:`decide` (one per ``bigdl.ingest.autoscale.intervalSec``)
    reads the assemble stage's starve and backpressure FRACTIONS of the
    interval just ended: starve (the assembler waited on decode) asks for a
    worker more, backpressure (the batch ring was full: the consumer is the
    bottleneck) for one less.  ``patience`` signals in a row are needed to
    act; after an action the policy holds ``cooldown`` intervals.  Under
    host-memory pressure it never scales up and steps towards the
    floor."""

    def __init__(self, min_workers: int, max_workers: int,
                 up_starve_frac: float, down_starve_frac: float,
                 patience: int, cooldown: int):
        self.min_workers = max(1, int(min_workers))
        self.max_workers = max(self.min_workers, int(max_workers))
        self.up_starve_frac = float(up_starve_frac)
        self.down_starve_frac = float(down_starve_frac)
        self.patience = max(1, int(patience))
        self.cooldown = max(0, int(cooldown))
        self._up_streak = 0
        self._down_streak = 0
        self._hold = 0

    def decide(self, starve_frac: float, backpressure_frac: float,
               workers: int, under_pressure: bool = False) -> int:
        """One interval's decision: +1 add a worker, -1 retire one, 0
        hold."""
        if self._hold > 0:
            self._hold -= 1
            return 0
        down = (workers > self.min_workers and
                (under_pressure or
                 starve_frac <= self.down_starve_frac or
                 backpressure_frac >= self.up_starve_frac))
        up = (not down and not under_pressure and
              workers < self.max_workers and
              starve_frac >= self.up_starve_frac)
        if up:
            self._up_streak += 1
            self._down_streak = 0
        elif down:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._down_streak = 0
        if self._up_streak >= self.patience:
            self._up_streak = 0
            self._hold = self.cooldown
            return 1
        if self._down_streak >= self.patience:
            self._down_streak = 0
            self._hold = self.cooldown
            return -1
        return 0


class _StageSupervisor:
    """Monitor of a run's stage threads and ring heartbeats (JAX :234-407).

    Each restartable stage registers a thread factory and a done flag; the
    monitor polls every :attr:`POLL_S`: a thread dead with its done flag
    unset (a silent crash) is restarted from the stage's shared state, up to
    ``max_restarts`` times, then the engine is declared dead (``failure``
    set, ``failed`` signalled, so that the waiting consumer wakes at once).
    With ``stall_timeout`` > 0 it also declares the engine dead
    (:class:`IngestStallError`) when the consumer has waited that long, no
    ring has made progress for that long and this run's stages have
    completed no item for that long.  It runs the autoscale tick every
    ``autoscale_interval`` seconds; a failing tick disables itself."""

    POLL_S = 0.02

    def __init__(self, max_restarts: int, stall_timeout: float,
                 diagnose, rings: Sequence[_Ring],
                 run_stats: Optional[dict] = None,
                 autoscale=None, autoscale_interval: float = 0.25):
        self.max_restarts = max(0, int(max_restarts))
        self.stall_timeout = float(stall_timeout)
        self._autoscale = autoscale
        self._autoscale_interval = max(0.01, float(autoscale_interval))
        self._autoscale_due = time.monotonic() + self._autoscale_interval
        self._diagnose = diagnose          # () -> stats dict, for errors
        #: this run's StageStats (a sibling shard run's progress must not
        #: mask this run's wedge)
        self._run_stats = run_stats or {}
        self._rings = list(rings)
        self._stages: dict = {}
        self.failure: Optional[BaseException] = None   # guarded-by: _lock
        self.failed = threading.Event()
        self.consumer_waiting_since: Optional[float] = None
        self._last_items = -1
        self._last_items_at: Optional[float] = None
        self.restarts = 0                              # guarded-by: _lock
        self._lock = make_lock("ingest.supervisor")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(self, name: str, factory, done_flag: List[bool]) -> None:
        """Track a stage: ``factory()`` builds and starts a thread that
        resumes from the stage's shared state; ``done_flag[0]`` is set by
        the stage on an orderly exit (completion or an error handed
        downstream)."""
        self._stages[name] = {"factory": factory, "thread": factory(),
                              "done": done_flag, "restarts": 0}

    def thread(self, name: str) -> threading.Thread:
        return self._stages[name]["thread"]

    def threads(self) -> List[threading.Thread]:
        """The monitor (once started) and each stage's current thread."""
        out = [st["thread"] for st in self._stages.values()]
        return out + ([self._thread] if self._thread is not None else [])

    def declare_failed(self, error: BaseException) -> None:
        with self._lock:
            if self.failure is None:
                self.failure = error
        self.failed.set()

    def count_restart(self, stage: str) -> None:
        with self._lock:
            self.restarts += 1
        telemetry.counter(
            "Ingest/stage_restarts", labels={"stage": stage},
            help="dead ingest stage workers restarted by the "
                 "supervisor").inc()

    def start(self) -> "_StageSupervisor":
        self._thread = threading.Thread(target=self._monitor, daemon=True,
                                        name="ingest-supervisor")
        self._thread.start()
        return self

    def stop(self) -> None:
        """End the monitor and wait for it (within :data:`JOIN_TIMEOUT_S`;
        the owner's join of :meth:`threads` names it if it is still
        alive): no restart and no autoscale action happen after."""
        self._stop.set()
        if (self._thread is not None and
                self._thread is not threading.current_thread()):
            self._thread.join(timeout=JOIN_TIMEOUT_S)

    def _monitor(self) -> None:
        while not self._stop.wait(self.POLL_S):
            if self.failure is not None:
                return
            try:
                self._poll_once()
            except BaseException as e:  # noqa: BLE001 never die silently
                # with the monitor gone the consumer would wait forever:
                # a failing restart or diagnosis is an engine failure
                self.declare_failed(IngestInfraError(
                    f"ingest supervisor failed: {e!r}"))
                return
            if self.failure is not None:
                return

    def _poll_once(self) -> None:
        for name, st in self._stages.items():
            if st["done"][0] or st["thread"].is_alive():
                continue
            if self._stop.is_set():
                return                  # a close is under way: no restart
            # dead without an orderly exit: a silent crash
            if st["restarts"] >= self.max_restarts:
                self.declare_failed(IngestInfraError(
                    f"ingest stage '{name}' died "
                    f"{st['restarts'] + 1} time(s) (restart budget "
                    f"bigdl.ingest.maxStageRestarts="
                    f"{self.max_restarts} exhausted)",
                    diagnosis=self._diagnose()))
                return
            st["restarts"] += 1
            self.count_restart(name)
            logger.warning(
                "ingest stage '%s' thread died silently - restarting from "
                "the stage's shared state (%d/%d)", name, st["restarts"],
                self.max_restarts)
            st["thread"] = st["factory"]()
        if self.stall_timeout > 0:
            self._check_stall()
        if self._autoscale is not None:
            now = time.monotonic()
            if now >= self._autoscale_due:
                self._autoscale_due = now + self._autoscale_interval
                try:
                    self._autoscale()
                except Exception as e:
                    # scaling is an optimisation, never a failure mode
                    logger.warning(
                        "ingest autoscaler disabled after error: %r", e)
                    self._autoscale = None

    def _check_stall(self) -> None:
        waiting = self.consumer_waiting_since
        if waiting is None:
            return
        now = time.monotonic()
        if now - waiting < self.stall_timeout:
            return
        newest = max((r.last_progress for r in self._rings), default=0.0)
        if now - newest < self.stall_timeout:
            return
        # ring silence alone is no wedge: a slow stage on a big item still
        # completes items, so this run's item counters must stand still too
        items = sum(s.items for s in self._run_stats.values())
        if items != self._last_items or self._last_items_at is None:
            self._last_items = items
            self._last_items_at = now
            return
        if now - self._last_items_at < self.stall_timeout:
            return
        self.declare_failed(IngestStallError(
            f"ingest wedged: no ring progressed for "
            f"{now - newest:.1f}s and no stage completed an item for "
            f"{now - self._last_items_at:.1f}s while the consumer was "
            f"blocked (bigdl.ingest.stallTimeoutSec={self.stall_timeout});"
            " per-stage stats in .diagnosis name the stuck handoff",
            diagnosis=self._diagnose()))


# ---------------------------------------------------------------------------
# the sharded SequenceFile reader
# ---------------------------------------------------------------------------

class ShardedSeqFileReader:
    """Parallel SequenceFile record source that keeps the global order:
    ``shards`` reader threads (``bigdl.ingest.shards``) own the ``*.seq``
    files round-robin and stream records into per-shard rings, and the
    merge drains one file at a time in sorted-walk order, so the records
    come out exactly as a sequential sweep gives them.  Clean files read
    through the native reader; a file with a corrupt record is read again
    through the resilient Python reader when the quarantine has a budget
    (``bigdl.ingest.maxBadRecords``), which skips the damage; a transient
    read failure re-opens the file and resumes after the records already
    given, with ``utils.file_io``'s capped-backoff retry budget."""

    def __init__(self, path: str, shards: Optional[int] = None,
                 ring_depth: Optional[int] = None,
                 quarantine: Optional[RecordQuarantine] = None):
        if os.path.isdir(path):
            self.files: List[str] = []
            for root, _, files in sorted(os.walk(path)):
                for fname in sorted(files):
                    if fname.endswith(".seq"):
                        self.files.append(os.path.join(root, fname))
        else:
            self.files = [path]
        self.shards = max(1, shards if shards is not None
                          else config.get_int("bigdl.ingest.shards", 2))
        self.ring_depth = (ring_depth if ring_depth is not None else
                           config.get_int("bigdl.ingest.recordRingDepth",
                                          256))
        self.stats = StageStats("seqfile_read")
        self.quarantine = quarantine

    @staticmethod
    def _file_records(path: str, quarantine: RecordQuarantine) -> Iterator:
        """One file's ``(name, label, data)`` records (JAX :774-844): a
        corrupt record switches the file to the resilient reader (budget
        permitting), a transient failure replays the file and skips the
        records already given.  The retry budget is per blip: a pass that
        made progress before failing starts it again."""
        from bigdl_tpu_torch.dataset.seqfile import (
            CorruptRecordError, read_image_seqfile,
            read_image_seqfile_resilient)
        from bigdl_tpu_torch.utils import file_io
        attempts = max(1, config.get_int("bigdl.io.retryTimes", 3))
        base = config.get_float("bigdl.io.retryInterval", 0.1)
        yielded = 0
        attempt = 1
        resilient = False    # the native reader until the first corruption
        # a replay meets the skips it already admitted: admit only new ones
        admitted = [0]
        while True:
            seen = 0
            pass_start = yielded
            pass_skips = [0]
            try:
                if resilient:
                    def on_skip(err, _resume):
                        pass_skips[0] += 1
                        if pass_skips[0] > admitted[0]:
                            quarantine.admit("seqfile_read", None, path, err)
                            admitted[0] = pass_skips[0]
                    src = read_image_seqfile_resilient(path, on_skip=on_skip)
                else:
                    src = read_image_seqfile(path)
                for rec in src:
                    seen += 1
                    if seen <= yielded:
                        continue     # the prefix given before a retry
                    yield rec
                    yielded += 1
                return
            except CorruptRecordError:
                if resilient or quarantine.budget <= 0:
                    raise            # fail fast (budget 0)
                resilient = True
            except Exception as e:
                if yielded > pass_start:
                    attempt = 1
                if attempt >= attempts or not file_io._is_transient(e):
                    raise
                delay = base * (2.0 ** (attempt - 1))
                logger.warning(
                    "transient seqfile read failure on %s (attempt %d/%d, "
                    "resuming after record %d in %.2fs): %r", path, attempt,
                    attempts, yielded, delay, e)
                time.sleep(delay)
                attempt += 1

    def __iter__(self) -> Iterator:
        from bigdl_tpu_torch.dataset.image import LabeledImageBytes

        if not self.files:
            return
        quarantine = (self.quarantine if self.quarantine is not None
                      else RecordQuarantine())
        self.last_quarantine = quarantine
        n = min(self.shards, len(self.files))
        stop = threading.Event()
        rings = [_Ring(max(1, self.ring_depth // n), producer=self.stats)
                 for _ in range(n)]
        file_end = object()

        def reader(si: int) -> None:
            try:
                for fi in range(si, len(self.files), n):
                    t0 = time.monotonic()
                    for name, label, data in self._file_records(
                            self.files[fi], quarantine):
                        t1 = time.monotonic()
                        self.stats.add(items=1, busy_s=t1 - t0)
                        telemetry.add_span_s("ingest/seqfile_read", t0, t1)
                        if not rings[si].put(
                                LabeledImageBytes(name, label, data), stop):
                            return
                        t0 = time.monotonic()
                    if not rings[si].put(file_end, stop):
                        return
            except BaseException as e:  # noqa: BLE001 raised by the merge
                rings[si].put(e, stop)

        threads = [threading.Thread(target=reader, args=(si,), daemon=True,
                                    name=f"ingest-seqread{si}")
                   for si in range(n)]
        for t in threads:
            t.start()
        try:
            for fi in range(len(self.files)):
                ring = rings[fi % n]
                while True:
                    item = ring.get(None)
                    if item is file_end:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    yield item
        finally:
            stop.set()
            for ring in rings:
                ring.drain()
            try:
                join_threads(threads, "ShardedSeqFileReader")
            finally:
                for ring in rings:
                    ring.drain()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class StreamingIngest(Transformer):
    """Compressed byte records (:class:`~bigdl_tpu_torch.dataset.image.
    LabeledImageBytes`) -> MiniBatches, stage-pipelined: the constructor
    and the output of :class:`~bigdl_tpu_torch.dataset.mt_batch.
    MTLabeledBGRImgToBatch`, without its per-batch barriers.

    - a *reader* thread pulls upstream records into a bounded record ring;
    - a *decode pool* (``decode_workers`` threads, resized by the
      autoscaler; cv2 and PIL release the GIL while they decode) keeps a
      window of decodes in flight across batch boundaries;
    - an *assembler* thread takes the decoded images in record order,
      draws crops and flips from the cloned generator and packs each batch
      (the native assembler releases the GIL);
    - batches wait in a bounded *batch ring* for the consumer, each with
      the generator state to commit when it is taken;
    - a *supervisor* thread restarts dead stages, detects stalls and runs
      the autoscaler (module docstring).

    Outputs per batch: float32 NCHW normalised (default); uint8 NCHW
    (``device_normalize``, for ``nn.ChannelNormalize``); or, with
    ``device_augment`` (default ``bigdl.ingest.deviceAugment``), the input
    list ``[frames, offsets, flips]``: the full decoded uint8 NHWC frames,
    (N, 2) int32 crop origins and (N,) uint8 flip flags, for
    ``nn.DeviceAugment`` to crop, flip and transpose on the device, and
    with ``device_jitter`` also (N,) int32 ColorJitter seeds.  Ring depths,
    pool widths and the self-healing budgets default from
    ``bigdl.ingest.*``.
    """

    def __init__(self, batch_size: int, crop: Tuple[int, int] = (224, 224),
                 mean: Sequence[float] = (104.0, 117.0, 123.0),
                 std: Sequence[float] = (1.0, 1.0, 1.0),
                 random_crop: bool = True, hflip: bool = True,
                 device_normalize: bool = False,
                 device_augment: Optional[bool] = None,
                 device_jitter: bool = False,
                 decode_workers: Optional[int] = None,
                 record_ring_depth: Optional[int] = None,
                 decoded_ring_depth: Optional[int] = None,
                 batch_ring_depth: Optional[int] = None,
                 assemble_threads: Optional[int] = None,
                 name: Optional[str] = None,
                 max_bad_records: Optional[int] = None,
                 max_stage_restarts: Optional[int] = None,
                 fallback_on_failure: Optional[bool] = None,
                 stall_timeout: Optional[float] = None,
                 autoscale: Optional[bool] = None,
                 epoch_cache: Optional[bool] = None):
        chaos.refuse_unported_keys()
        if name is None:
            with _NAME_LOCK:
                name = f"ingest{_NAME_SEQ[0]}"
                _NAME_SEQ[0] += 1
        self.name = name
        self.batch_size = batch_size
        self.crop = crop
        self.mean, self.std = mean, std
        self.random_crop, self.hflip = random_crop, hflip
        self.device_normalize = device_normalize
        self.device_augment = (
            device_augment if device_augment is not None
            else config.get_bool("bigdl.ingest.deviceAugment", False))
        self.device_jitter = bool(device_jitter)
        cores = max(1, os.cpu_count() or 1)
        self.decode_workers = (
            decode_workers if decode_workers is not None
            else config.get_int("bigdl.ingest.decodeWorkers", cores))
        self.record_ring_depth = (
            record_ring_depth if record_ring_depth is not None
            else config.get_int("bigdl.ingest.recordRingDepth", 256))
        self.decoded_ring_depth = (
            decoded_ring_depth if decoded_ring_depth is not None
            else config.get_int("bigdl.ingest.decodedRingDepth",
                                2 * batch_size))
        self.batch_ring_depth = (
            batch_ring_depth if batch_ring_depth is not None
            else config.get_int("bigdl.ingest.batchRingDepth", 2))
        self.assemble_threads = assemble_threads or cores
        self.max_bad_records = (
            max_bad_records if max_bad_records is not None
            else config.get_int("bigdl.ingest.maxBadRecords", 0))
        self.max_stage_restarts = (
            max_stage_restarts if max_stage_restarts is not None
            else config.get_int("bigdl.ingest.maxStageRestarts", 2))
        self.fallback_on_failure = (
            fallback_on_failure if fallback_on_failure is not None
            else config.get_bool("bigdl.ingest.fallbackOnFailure", False))
        self.stall_timeout = (
            stall_timeout if stall_timeout is not None
            else config.get_float("bigdl.ingest.stallTimeoutSec", 0.0))
        self.autoscale = (
            autoscale if autoscale is not None
            else config.get_bool("bigdl.ingest.autoscale.enabled", True))
        #: live worker counts per stage (the ``<stage>/workers`` gauges) and
        #: the autoscaler's actions, moved by the supervisor's tick
        self.stage_workers = {"decode": self.decode_workers,
                              "assemble": self.assemble_threads}
        self.autoscale_events = {"up": 0, "down": 0}
        #: the decoded-epoch cache lives as long as the engine: epoch 2 is
        #: a second run of the same transformer
        use_cache = (epoch_cache if epoch_cache is not None
                     else config.get_bool("bigdl.ingest.epochCache", False))
        self.epoch_cache = None
        if use_cache:
            from bigdl_tpu_torch.dataset.epoch_cache import DecodedEpochCache
            self.epoch_cache = DecodedEpochCache(
                name=self.name,
                cache_dir=config.get_property("bigdl.ingest.epochCacheDir"),
                budget_mb=config.get_int("bigdl.ingest.epochCacheBudgetMB",
                                         0),
                segment_records=config.get_int(
                    "bigdl.ingest.epochCacheSegmentRecords", 256))
        # per-run stage stats: a ShardedDataSet applies one transformer
        # to every shard, so several runs can be live at once
        self._active_stats: List[dict] = []
        self._last_stats: Optional[dict] = None
        #: the latest run's quarantine and supervisor; _active_faults
        #: mirrors _active_stats; run_history keeps a small summary per
        #: finished run
        self.quarantine: Optional[RecordQuarantine] = None
        self.supervisor: Optional[_StageSupervisor] = None
        self._active_faults: List[tuple] = []
        self._last_faults: Optional[tuple] = None
        self.run_history: List[dict] = []
        self.fallbacks = 0

    # ---- diagnostics ----------------------------------------------------

    def has_active_run(self) -> bool:
        return bool(self._active_stats)

    def _fault_pairs(self) -> List[tuple]:
        """(quarantine, supervisor) of every active run, else the last
        finished one."""
        pairs = list(self._active_faults)
        if not pairs and self._last_faults is not None:
            pairs = [self._last_faults]
        return pairs

    def quarantined_count(self) -> int:
        """Data-error records skipped, summed over every active run, else
        the last run's."""
        return sum(q.count for q, _ in self._fault_pairs())

    def stage_restart_count(self) -> int:
        return sum(s.restarts for _, s in self._fault_pairs())

    def ring_ages(self) -> dict:
        """Seconds since each ring last made progress, the freshest over
        the active runs; empty before the first run."""
        now = time.monotonic()
        out: dict = {}
        for _, sup in self._fault_pairs():
            for name, ring in zip(("record_ring", "batch_ring"),
                                  sup._rings):
                age = round(now - ring.last_progress, 3)
                out[name] = min(out.get(name, age), age)
        return out

    def fault_stats(self) -> dict:
        """The self-healing counters over the active runs: quarantine
        summary, stage restarts, fallbacks and ring ages."""
        pairs = self._fault_pairs()
        quarantine = {"count": sum(q.count for q, _ in pairs),
                      "samples": [s for q, _ in pairs for s in q.samples]}
        if len(pairs) == 1:
            quarantine = pairs[0][0].summary()
        return {
            "quarantine": quarantine if pairs else {},
            "stage_restarts": sum(s.restarts for _, s in pairs),
            "fallbacks": self.fallbacks,
            "ring_ages_s": self.ring_ages(),
        }

    def stats(self) -> dict:
        """Per-stage snapshots (``read``, ``decode``, ``assemble``,
        ``consume``): every active run's counters summed, else the last
        finished run's."""
        runs = list(self._active_stats)
        if not runs and self._last_stats is not None:
            runs = [self._last_stats]
        if not runs:
            return {}
        if len(runs) == 1:
            return {name: s.snapshot() for name, s in runs[0].items()}
        out = {}
        for name in ("read", "decode", "assemble", "consume"):
            snaps = [r[name].snapshot() for r in runs if name in r]
            n = len(snaps)
            out[name] = {
                "items": sum(s["items"] for s in snaps),
                "throughput_per_sec": round(
                    sum(s["throughput_per_sec"] for s in snaps), 1),
                "busy_s": round(sum(s["busy_s"] for s in snaps), 3),
                "starve_s": round(sum(s["starve_s"] for s in snaps), 3),
                "backpressure_s": round(
                    sum(s["backpressure_s"] for s in snaps), 3),
                "stall_frac": round(
                    sum(s["stall_frac"] for s in snaps) / n, 3),
                "mean_queue_depth": round(
                    sum(s["mean_queue_depth"] for s in snaps) / n, 2),
            }
        return out

    # ---- the pipeline ---------------------------------------------------

    def __call__(self, it: Iterator) -> Iterator:
        from bigdl_tpu_torch.dataset.mt_batch import (MTLabeledBGRImgToBatch,
                                                      _check_crop_fits,
                                                      assemble_batch,
                                                      assemble_batch_u8,
                                                      crop_flip_host)
        from bigdl_tpu_torch.dataset.sample import MiniBatch
        from bigdl_tpu_torch.utils import elastic, file_io
        from bigdl_tpu_torch.utils.random_generator import RandomGenerator

        stats = {name: StageStats(name)
                 for name in ("read", "decode", "assemble", "consume")}
        self._active_stats.append(stats)
        _LIVE.add(self)
        # the per-stage scalars flow through the registry's one flush path
        # and the watchdog reports the engines at each fire (registered at
        # a run's start: nothing is registered at import)
        telemetry.REGISTRY.register_provider("ingest", summary_scalars)
        elastic.register_stall_diagnostic("ingest", _stall_diagnostics)
        quarantine = RecordQuarantine(self.max_bad_records)
        self.quarantine = quarantine

        # clone-and-commit (module docstring): the assembler draws from a
        # clone; a batch's post-draw state is committed when it is taken.
        # Only the first active fork of a stream commits; later ones draw
        # from a fork reseeded from the fork point and their rank, so a
        # re-run derives the same per-shard seeds
        shared_rng = RandomGenerator.RNG()
        active_forks = shared_rng.__dict__.setdefault("_ingest_forks", set())
        fork_rank = len(active_forks)
        fork_token = object()
        primary = fork_rank == 0
        active_forks.add(fork_token)
        drawer = RandomGenerator(0)
        drawer.np.set_state(shared_rng.np.get_state())
        if not primary:
            mix = int(np.asarray(shared_rng.np.get_state()[1],
                                 np.uint64).sum())
            drawer.set_seed((mix ^ (0x9E3779B1 * fork_rank)) % (2 ** 31))

        stop = threading.Event()

        # the governor's byte ledgers of this run's bounded buffers
        rec_acct = _governor.account("ingest_record_ring")
        bat_acct = _governor.account("ingest_batch_ring")
        dec_acct = _governor.account("ingest_decode_window")
        dec_outstanding = [0]    # this run's share, settled at teardown

        def _rec_nbytes(item):
            if isinstance(item, tuple) and len(item) == 2:
                return _item_nbytes(getattr(item[1], "bytes", None))
            return 0

        def _bat_nbytes(item):
            if isinstance(item, tuple) and len(item) == 2:
                return _item_nbytes(item[0])
            return 0

        def _dec_charge(rec, sign: int) -> None:
            n = _item_nbytes(getattr(rec, "bytes", None))
            if n:
                dec_outstanding[0] += sign * n
                (dec_acct.add if sign > 0 else dec_acct.sub)(n)

        record_ring = _Ring(self.record_ring_depth, producer=stats["read"],
                            consumer=stats["assemble"],
                            account=rec_acct, sizer=_rec_nbytes)
        batch_ring = _Ring(self.batch_ring_depth, producer=stats["assemble"],
                           consumer=stats["consume"],
                           account=bat_acct, sizer=_bat_nbytes)
        pool = _DecodePool(self.decode_workers,
                           thread_name_prefix="ingest-decode")
        epoch_cache = self.epoch_cache
        ch, cw = self.crop

        # the stages' shared state: all a restarted stage thread needs to
        # go on where its dead predecessor stopped (the chaos kill comes at
        # the loop top, a consistent point) lives here
        rd = {"index": 0, "exhausted": False, "inhand": None}
        rd_done = [False]        # orderly exit (completion or handed error)
        asm = {"pending": deque(),   # (index, record, decode future), in order
               "done": False,        # upstream exhausted, or its error queued
               "aborted": False,     # teardown seen mid-wait
               "imgs": [], "recs": [], "offsets": [], "flips": [],
               "seeds": [],          # ride-along ColorJitter seeds
               "items": 0,           # records handled (the chaos kill key)
               "decode_restarts": 0}
        asm_done = [False]

        def reader() -> None:
            """Upstream records into the record ring.  The upstream draws no
            host randomness (crops and flips are the assembler's,
            reshuffles the trainer's producer's)."""
            try:
                while True:
                    if chaos.kill_stage_thread("reader", rd["index"]):
                        return          # a silent death: the supervisor's
                    chaos.starve_stage("read", rd["index"])
                    t0 = time.monotonic()
                    try:
                        rec = next(it)
                    except StopIteration:
                        rd["exhausted"] = True
                        break
                    idx, rd["index"] = rd["index"], rd["index"] + 1
                    try:
                        # blips retry with the file_io backoff; data faults
                        # (fatal) pass straight through
                        file_io.retrying(chaos.on_record_read, idx,
                                         op="ingest record read")
                    except BaseException as e:
                        if _is_data_error(e):
                            quarantine.admit("read", idx,
                                             getattr(rec, "name", None), e)
                            continue
                        raise _read_failure(idx, e)
                    t1 = time.monotonic()
                    stats["read"].add(items=1, busy_s=t1 - t0)
                    telemetry.add_span_s("ingest/read", t0, t1)
                    if not record_ring.put((idx, rec), stop):
                        # teardown aborted the hand-off: keep the record in
                        # hand so that a fallback loses nothing
                        rd["inhand"] = (idx, rec)
                        rd_done[0] = True
                        return
                record_ring.put(_END, stop)
                rd_done[0] = True
            except BaseException as e:  # noqa: BLE001 raised downstream
                record_ring.put(e, stop)
                rd_done[0] = True

        def _read_failure(idx: int, e: BaseException) -> BaseException:
            """A read error past the data-fault path: a transient one has
            outlasted ``file_io.retrying``'s budget, which the machinery
            reports as :class:`IngestInfraError` (the blip its cause)."""
            if not file_io._is_transient(e):
                return e
            err = IngestInfraError(
                f"ingest record read at stream position {idx} still failing "
                f"after bigdl.io.retryTimes="
                f"{max(1, config.get_int('bigdl.io.retryTimes', 3))} "
                f"attempts: {e!r}", diagnosis=self.stats())
            err.__cause__ = e
            return err

        def timed_decode(idx: int, rec) -> np.ndarray:
            if chaos.kill_stage_thread("decode", idx):
                raise _StageKilledError(
                    f"decode worker died at record {idx}")
            chaos.starve_stage("decode", idx)
            t0 = time.monotonic()
            chaos.on_decode(idx)
            key = getattr(rec, "name", None)
            img = epoch_cache.get(key) if epoch_cache is not None else None
            if img is None:
                try:
                    img = MTLabeledBGRImgToBatch._decode(rec.bytes)
                except ImportError:
                    raise       # no decoder installed: not a data fault
                except Exception as e:
                    raise IngestDataError(
                        f"undecodable image at stream position {idx}: "
                        f"{e!r}") from e
                if epoch_cache is not None:
                    epoch_cache.put(key, img)
            t1 = time.monotonic()
            stats["decode"].add(items=1, busy_s=t1 - t0)
            telemetry.add_span_s("ingest/decode", t0, t1)
            return img

        def fill(block: bool) -> None:
            """Top up the window of decodes in flight; wait for a record
            only when the window is empty.  Under host-memory pressure the
            window is 1 (progress, never a deadlock)."""
            pending = asm["pending"]
            window = (1 if _governor.under_pressure()
                      else self.decoded_ring_depth)
            while not asm["done"] and len(pending) < window:
                item = (record_ring.get(stop) if block and not pending
                        else record_ring.try_get())
                if item is _NO_ITEM:
                    if block and not pending:
                        asm["aborted"] = True     # teardown mid-wait
                    return
                if item is _END:
                    asm["done"] = True
                    return
                if isinstance(item, BaseException):
                    asm["done"] = True
                    pending.append((None, None, item))
                    return
                idx, rec = item
                _dec_charge(rec, +1)
                pending.append((idx, rec, pool.submit(timed_decode, idx,
                                                      rec)))

        def pack_batch():
            """The one packing path, of the pipelined emit and of the
            fallback's: the batch, its record count and the pack seconds
            (the caller counts them once the batch is handed on)."""
            imgs, recs = asm["imgs"], asm["recs"]
            t0 = time.monotonic()
            offs = np.asarray(asm["offsets"], np.int32).reshape(len(imgs), 2)
            fl = np.asarray(asm["flips"], np.uint8)
            if self.device_augment:
                # full frames and the draws; a batch of mixed frame sizes
                # is pre-cropped on the host and ships identity draws
                if len({im.shape for im in imgs}) == 1:
                    frames = np.stack(imgs)
                else:
                    frames = crop_flip_host(imgs, self.crop, offs, fl)
                    offs = np.zeros_like(offs)
                    fl = np.zeros_like(fl)
                x = [frames, offs, fl]
                if self.device_jitter:
                    x.append(np.asarray(asm["seeds"], np.int32))
            elif self.device_normalize:
                x = assemble_batch_u8(imgs, self.crop, offs, fl,
                                      n_threads=self.assemble_threads)
            else:
                x = assemble_batch(imgs, self.crop, offs, fl, self.mean,
                                   self.std, n_threads=self.assemble_threads)
            y = np.asarray([r.label for r in recs], np.float32)
            t1 = time.monotonic()
            telemetry.add_span_s("ingest/assemble", t0, t1,
                                 {"batch": len(imgs)})
            return MiniBatch(x, y), len(imgs), t1 - t0

        def clear_batch() -> None:
            for key in ("imgs", "recs", "offsets", "flips", "seeds"):
                asm[key].clear()

        def admit_and_append(idx: int, rec, img) -> bool:
            """Crop-fit check, then the crop and flip draws in record order
            (the draws of MTLabeledBGRImgToBatch) and, with jitter, the
            record's seed after them.  False when the record was
            quarantined, before any draw.  The assembler's and the
            fallback's."""
            try:
                _check_crop_fits(
                    [img], self.crop,
                    describe=lambda _i: (
                        f"StreamingIngest: record {len(asm['imgs'])} of "
                        f"the current batch (label {rec.label})"))
            except ValueError as e:
                quarantine.admit("assemble", idx, rec.name, e)
                return False
            h, w = img.shape[:2]
            if self.random_crop:
                oy = drawer.random_int(0, h - ch + 1)
                ox = drawer.random_int(0, w - cw + 1)
            else:
                oy, ox = (h - ch) // 2, (w - cw) // 2
            fl = int(drawer.uniform() < 0.5) if self.hflip else 0
            asm["imgs"].append(img if img.ndim == 3 else img[:, :, None])
            asm["recs"].append(rec)
            asm["offsets"].append((oy, ox))
            asm["flips"].append(fl)
            if self.device_jitter:
                asm["seeds"].append(drawer.random_int(0, 2 ** 31 - 1))
            return True

        def emit() -> bool:
            batch, n, pack_s = pack_batch()
            # one batch larger than the whole host budget cannot be
            # backpressured away
            _governor.check_item("ingest_batch_ring", _item_nbytes(batch))
            if not batch_ring.put((batch, drawer.np.get_state()), stop):
                # the drawn batch stays in the shared lists: a fallback
                # emits it with the draws it has
                return False
            stats["assemble"].add(items=n, busy_s=pack_s)
            clear_batch()
            return True

        def await_decode(fut):
            """A decode's image, polling ``stop`` while it runs (waiting on
            decode is the assembler's starve); _NO_ITEM at a teardown."""
            if fut.done():
                return fut.result()
            t0 = time.monotonic()
            try:
                while not stop.is_set():
                    try:
                        return fut.result(timeout=_Ring.POLL_S)
                    except futures.TimeoutError:
                        continue
                return _NO_ITEM
            finally:
                stats["assemble"].add(starve_s=time.monotonic() - t0)

        def assembler() -> None:
            pending, imgs = asm["pending"], asm["imgs"]
            try:
                while True:
                    if chaos.kill_stage_thread("assembler", asm["items"]):
                        return          # a silent death: the supervisor's
                    chaos.starve_stage("assemble", asm["items"])
                    fill(block=True)
                    if asm["aborted"]:
                        asm_done[0] = True
                        return
                    if not pending:
                        break
                    idx, rec, fut = pending.popleft()
                    if rec is None:      # upstream error, in order
                        raise fut
                    _dec_charge(rec, -1)
                    try:
                        img = await_decode(fut)
                    except _StageKilledError as e:
                        # a dead decode worker is infrastructure: decode
                        # the record again, bounded like a stage restart
                        if asm["decode_restarts"] >= self.max_stage_restarts:
                            raise IngestInfraError(
                                "ingest decode worker died and the restart "
                                "budget (bigdl.ingest.maxStageRestarts="
                                f"{self.max_stage_restarts}) is exhausted",
                                diagnosis=self.stats()) from e
                        asm["decode_restarts"] += 1
                        sup.count_restart("decode")
                        logger.warning(
                            "ingest decode worker died on record %d - "
                            "resubmitting (%d/%d)", idx,
                            asm["decode_restarts"], self.max_stage_restarts)
                        _dec_charge(rec, +1)
                        pending.appendleft(
                            (idx, rec, pool.submit(timed_decode, idx, rec)))
                        continue
                    except BaseException as e:
                        if _is_data_error(e):
                            # skipped before any draw: the survivors draw
                            # as the synchronous path does over them
                            quarantine.admit("decode", idx, rec.name, e)
                            asm["items"] += 1
                            continue
                        raise
                    if img is _NO_ITEM:
                        # teardown mid-wait: the record goes back in front
                        # of the window, for a fallback to take
                        _dec_charge(rec, +1)
                        pending.appendleft((idx, rec, fut))
                        asm["aborted"] = True
                        asm_done[0] = True
                        return
                    fill(block=False)    # the next batch's decodes go on
                    appended = admit_and_append(idx, rec, img)
                    asm["items"] += 1
                    if appended and len(imgs) == self.batch_size and \
                            not emit():
                        asm_done[0] = True
                        return
                if imgs and not emit():
                    asm_done[0] = True
                    return
                batch_ring.put(_END, stop)
                asm_done[0] = True
            except BaseException as e:  # noqa: BLE001 raised at the consumer
                batch_ring.put(e, stop)
                asm_done[0] = True

        def _thread_factory(fn, tname):
            def factory():
                t = threading.Thread(target=fn, daemon=True, name=tname)
                t.start()
                return t
            return factory

        autoscale_tick = None
        if self.autoscale:
            cores = max(1, os.cpu_count() or 1)
            policy = AutoscalePolicy(
                min_workers=config.get_int("bigdl.ingest.autoscale.min", 1),
                max_workers=(config.get_int("bigdl.ingest.autoscale.max", 0)
                             or cores),
                up_starve_frac=config.get_float(
                    "bigdl.ingest.autoscale.upStarveFrac", 0.2),
                down_starve_frac=config.get_float(
                    "bigdl.ingest.autoscale.downStarveFrac", 0.02),
                patience=config.get_int("bigdl.ingest.autoscale.patience",
                                        2),
                cooldown=config.get_int("bigdl.ingest.autoscale.cooldown",
                                        3))
            prev = {"starve": 0.0, "backpressure": 0.0,
                    "t": time.monotonic()}

            def autoscale_tick() -> None:
                """One decision (JAX :1531-1560): the interval's deltas of
                the assemble stage's stall counters as fractions of it go
                to the policy; the pool and the native assembler's thread
                count act."""
                starve, bp = stats["assemble"].stall_seconds()
                now = time.monotonic()
                dt = max(now - prev["t"], 1e-9)
                starve_frac = (starve - prev["starve"]) / dt
                bp_frac = (bp - prev["backpressure"]) / dt
                prev.update(starve=starve, backpressure=bp, t=now)
                delta = policy.decide(starve_frac, bp_frac, pool.workers,
                                      _governor.under_pressure())
                if not delta:
                    return
                n = pool.set_workers(pool.workers + delta)
                self.assemble_threads = n
                self.stage_workers["decode"] = n
                self.stage_workers["assemble"] = n
                direction = "up" if delta > 0 else "down"
                self.autoscale_events[direction] += 1
                telemetry.counter(
                    f"Ingest/autoscale_{direction}",
                    labels={"stage": "decode"}, summary=True,
                    help="ingest worker-scaling actions taken by the "
                         "stage autoscaler").inc()
                logger.info(
                    "ingest '%s' autoscale %s: decode/assemble workers -> %d "
                    "(starve %.2f, backpressure %.2f of interval)",
                    self.name, direction, n, starve_frac, bp_frac)

        sup = _StageSupervisor(
            self.max_stage_restarts, self.stall_timeout,
            diagnose=self.stats, rings=[record_ring, batch_ring],
            run_stats=stats, autoscale=autoscale_tick,
            autoscale_interval=config.get_float(
                "bigdl.ingest.autoscale.intervalSec", 0.25))
        self.supervisor = sup
        sup.register("reader", _thread_factory(reader, "ingest-reader"),
                     rd_done)
        sup.register("assembler",
                     _thread_factory(assembler, "ingest-assembler"),
                     asm_done)
        sup.start()
        fault_pair = (quarantine, sup)
        self._active_faults.append(fault_pair)

        # run-scoped shrinker: under host-memory pressure the rings and the
        # decode window halve; the decode window's shrink persists for the
        # engine's lifetime (self.decoded_ring_depth)
        shrink_key = f"ingest:{self.name}:{id(stop)}"

        def _shrink() -> None:
            rl = record_ring.shrink()
            bl = batch_ring.shrink()
            self.decoded_ring_depth = max(
                1, int(self.decoded_ring_depth) // 2)
            logger.warning(
                "host-memory pressure: ingest '%s' ring depths shrink to "
                "record=%d batch=%d decode-window=%d", self.name, rl, bl,
                self.decoded_ring_depth)

        _governor.register_shrinker(shrink_key, _shrink)

        def _sync_record_source() -> Iterator:
            """The fallback's records, in stream order: the assembler's
            decode window, then the record ring, then the record the reader
            held, then the rest of the upstream iterator (read on this
            thread, through the same chaos hooks and retry)."""
            upstream_done = asm["done"] or rd["exhausted"]
            upstream_err = None
            for idx, rec, fut in asm["pending"]:
                if rec is None:
                    upstream_err = fut
                    upstream_done = True
                    break
                _dec_charge(rec, -1)
                yield idx, rec
            asm["pending"].clear()
            while upstream_err is None:
                item = record_ring.try_get()
                if item is _NO_ITEM:
                    break
                if item is _END:
                    upstream_done = True
                    break
                if isinstance(item, BaseException):
                    upstream_err = item
                    break
                yield item
            if upstream_err is None and rd["inhand"] is not None:
                yield rd["inhand"]
                rd["inhand"] = None
            while upstream_err is None and not upstream_done:
                try:
                    rec = next(it)
                except StopIteration:
                    break
                idx, rd["index"] = rd["index"], rd["index"] + 1
                try:
                    file_io.retrying(chaos.on_record_read, idx,
                                     op="ingest record read")
                except BaseException as e:
                    if _is_data_error(e):
                        quarantine.admit("read", idx,
                                         getattr(rec, "name", None), e)
                        continue
                    raise _read_failure(idx, e)
                stats["read"].add(items=1)
                yield idx, rec
            if upstream_err is not None:
                raise upstream_err

        def _fallback_tail(err: BaseException) -> Iterator:
            """Finish the epoch on the synchronous path (JAX :1649-1720):
            same drawer, same quarantine, no stage threads, so the batches
            go on as an undisturbed run gives them (quarantined records
            aside).  Only once the reader and the assembler are joined (a
            live reader owns the upstream iterator): else the failure
            raises."""
            self.fallbacks += 1
            telemetry.counter(
                "Ingest/fallbacks", summary=True,
                help="mid-epoch switches to the synchronous ingest path"
            ).inc()
            logger.warning(
                "ingest engine '%s' declared dead (%s) - falling back to the "
                "synchronous path mid-epoch; per-stage stats: %s",
                self.name, err, self.stats())
            sup.stop()
            stop.set()
            try:
                join_threads(sup.threads(),
                             f"StreamingIngest '{self.name}' fallback")
            except IngestInfraError as e:
                logger.error("ingest fallback impossible: %s", e)
                raise err
            # completed batches in the ring are valid drawn work: deliver
            # them (committing their draws) before the first unpacked record
            while True:
                item = batch_ring.try_get()
                if item is _NO_ITEM or item is _END:
                    break
                if isinstance(item, BaseException):
                    raise item
                batch, rng_state = item
                if primary:
                    shared_rng.np.set_state(rng_state)
                stats["consume"].add(items=1)
                yield batch

            def emit_sync():
                # the pipelined emit's pack; taking the batch is the yield
                # itself, so its draws commit here
                batch, n, pack_s = pack_batch()
                stats["assemble"].add(items=n, busy_s=pack_s)
                clear_batch()
                if primary:
                    shared_rng.np.set_state(drawer.np.get_state())
                stats["consume"].add(items=1)
                return batch

            if len(asm["imgs"]) >= self.batch_size:
                # a drawn batch whose ring put the teardown aborted
                yield emit_sync()
            for idx, rec in _sync_record_source():
                try:
                    img = timed_decode(idx, rec)
                except BaseException as e:
                    if _is_data_error(e):
                        quarantine.admit("decode", idx, rec.name, e)
                        continue
                    raise
                if not admit_and_append(idx, rec, img):
                    continue
                if len(asm["imgs"]) == self.batch_size:
                    yield emit_sync()
            if asm["imgs"]:
                yield emit_sync()

        try:
            while True:
                # a governor tick from the consumer's side too: a process
                # with no training loop has nobody else to poll it
                _governor.poll()
                # the supervisor's failure event is the wait's stop, so an
                # escalation wakes the consumer at once
                sup.consumer_waiting_since = time.monotonic()
                item = batch_ring.get(sup.failed)
                sup.consumer_waiting_since = None
                if item is _NO_ITEM:
                    err = sup.failure or IngestInfraError(
                        "ingest engine failed", diagnosis=self.stats())
                    telemetry.counter(
                        "Ingest/engine_failures", summary=True,
                        help="ingest engines declared dead").inc()
                    if self.fallback_on_failure:
                        yield from _fallback_tail(err)
                        return
                    logger.error(
                        "ingest engine '%s' declared dead: %s; per-stage "
                        "stats: %s", self.name, err, self.stats())
                    raise err
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, rng_state = item
                if primary:
                    # commit: the caller's stream advances as far as the
                    # batches it has taken
                    shared_rng.np.set_state(rng_state)
                stats["consume"].add(items=1)
                yield batch
        finally:
            _governor.unregister_shrinker(shrink_key)
            active_forks.discard(fork_token)
            for i, run in enumerate(self._active_stats):
                if run is stats:
                    del self._active_stats[i]
                    break
            self._last_stats = stats
            self._active_faults = [p for p in self._active_faults
                                   if p is not fault_pair]
            self._last_faults = fault_pair
            self.run_history.append({"quarantine": quarantine.summary(),
                                     "stage_restarts": sup.restarts})
            sup.stop()          # no restart while tearing down
            stop.set()
            pool.shutdown(cancel_futures=True)
            for ring in (record_ring, batch_ring):
                ring.drain()
            try:
                # every wait of a stage thread polls ``stop``; what can
                # still hold one is work in hand (an upstream read, a
                # decode), and a close never returns with it running
                join_threads(sup.threads() + pool.threads,
                             f"StreamingIngest '{self.name}'")
            finally:
                # a last put may land between the first drain and the joins
                for ring in (record_ring, batch_ring):
                    ring.drain()
                # settle this run's share of the process-wide decode-window
                # account
                if dec_outstanding[0] > 0:
                    dec_acct.sub(dec_outstanding[0])
                elif dec_outstanding[0] < 0:
                    dec_acct.add(-dec_outstanding[0])
                dec_outstanding[0] = 0


def summary_scalars():
    """``(tag, value)`` pairs for the training summary (JAX :1803): each
    stage's throughput, stall fraction and ring occupancy, the worker
    gauges and autoscale actions, the epoch cache's hits and misses of
    every engine with an ACTIVE run, tagged with the engine's name
    (``Ingest/<name>/...``); the quarantine and stage-restart counts once
    they are nonzero.  Registered as the registry's ``ingest`` provider
    when a run starts."""
    out = []
    for eng in sorted((e for e in _LIVE if e.has_active_run()),
                      key=lambda e: e.name):
        prefix = f"Ingest/{eng.name}"
        for stage, snap in eng.stats().items():
            out.append((f"{prefix}/{stage}/throughput",
                        snap["throughput_per_sec"]))
            out.append((f"{prefix}/{stage}/stall_frac", snap["stall_frac"]))
            if snap["mean_queue_depth"]:
                out.append((f"{prefix}/{stage}/queue_depth",
                            snap["mean_queue_depth"]))
        for stage, n in eng.stage_workers.items():
            out.append((f"{prefix}/{stage}/workers", n))
        for direction, n in eng.autoscale_events.items():
            if n:
                out.append((f"{prefix}/autoscale_{direction}", n))
        if eng.epoch_cache is not None:
            cache = eng.epoch_cache.stats()
            out.append((f"{prefix}/epoch_cache_hits", cache["hits"]))
            out.append((f"{prefix}/epoch_cache_misses", cache["misses"]))
        quarantined = eng.quarantined_count()
        if quarantined:
            out.append((f"{prefix}/quarantined", quarantined))
        restarts = eng.stage_restart_count()
        if restarts:
            out.append((f"{prefix}/stage_restarts", restarts))
    return out


def _stall_diagnostics() -> dict:
    """Per-engine stats and fault counters (with the ring ages) for the
    hung-step watchdog (JAX :1846): a stall rooted in a wedged data
    pipeline is reported with the stage that stopped."""
    return {eng.name: {"stats": eng.stats(), "faults": eng.fault_stats()}
            for eng in sorted(_LIVE, key=lambda e: e.name)
            if eng.has_active_run()}
