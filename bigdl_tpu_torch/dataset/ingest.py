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
MTLabeledBGRImgToBatch`, bit for bit, at every ring depth.  With several
engines forked from one stream (a multi-shard ``ShardedDataSet``) only the
first commits; the others draw from deterministically reseeded forks.

Data faults (a corrupt record, an undecodable image, an undersized frame)
raise :class:`IngestDataError`: with ``bigdl.ingest.maxBadRecords`` > 0 the
one record is skipped into a bounded :class:`RecordQuarantine`, else the
error raises at the consumer.  A stage thread that dies without surfacing
an error raises :class:`IngestInfraError` at the consumer.  A close (the
run's generator closed, or exhausted) sets ``stop``, which every blocking
wait of a stage thread polls, and joins every stage and decode thread
within :data:`JOIN_TIMEOUT_S`: a thread still held then by work in hand (an
upstream read, a decode) makes the close raise :class:`IngestInfraError`
naming it, never return with it alive.  Record reads go
straight to the file (the JAX package's transient retry comes with the
port of ``utils/file_io.py``).

Not ported yet, each raising :class:`NotImplementedError` when asked: the
stage supervisor (restarts, ``bigdl.ingest.maxStageRestarts`` > 0; stall
detection, ``bigdl.ingest.stallTimeoutSec`` > 0), the decode-pool
autoscaler (``autoscale=True`` or ``bigdl.ingest.autoscale.enabled``), the
synchronous fallback (``bigdl.ingest.fallbackOnFailure``), the decoded-epoch
cache (``bigdl.ingest.epochCache``), ``device_jitter`` (its ColorJitter
draws from JAX's threefry), and the ingest chaos keys and
``bigdl.ingest.zeroCopyUpload`` (``utils/chaos.py``
``refuse_unported_keys``).

Telemetry (JAX :209-213, :1268-1377, :1803-1858): the ``Ingest/quarantined``,
``Ingest/stage_errors`` and ``Ingest/engine_failures`` counters, the spans
``ingest/read``, ``ingest/decode``, ``ingest/assemble`` and
``ingest/seqfile_read`` on the stage threads' lanes (``ingest-reader``,
``ingest-decode-<i>``, ``ingest-assembler``, ``ingest-seqread<i>``), and
:func:`summary_scalars`, the registry's ``ingest`` provider.  The
restart, autoscale and fallback counters belong to paths not ported.
The JAX package turns the autoscaler on by default; the port runs fixed
pools unless asked, which changes timing and never the batches.
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
from bigdl_tpu_torch.utils import chaos, config
from bigdl_tpu_torch.analysis.lockwitness import make_lock

logger = logging.getLogger("bigdl_tpu_torch")

#: live engines, for the trainers' end-of-run log
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
    """The ingest machinery failed (a stage thread died); ``diagnosis``
    holds the engine's per-stage ``stats()`` at the time."""

    def __init__(self, message: str, diagnosis: Optional[dict] = None):
        super().__init__(message)
        self.diagnosis = diagnosis or {}


class QuarantineExceededError(IngestInfraError):
    """More data errors than ``bigdl.ingest.maxBadRecords``; the message
    names a sample of the offenders."""


def _is_data_error(e: BaseException) -> bool:
    from bigdl_tpu_torch.dataset.seqfile import CorruptRecordError
    return isinstance(e, (IngestDataError, CorruptRecordError))


class RecordQuarantine:
    """Bounded sink for records with data errors.  ``admit`` counts and
    samples the fault while the budget lasts, raises the original error when
    the budget is 0 (fail fast), and :class:`QuarantineExceededError` once a
    nonzero budget is spent.  Thread-safe."""

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
                self.samples.append({"stage": stage, "index": index,
                                     "name": name, "error": repr(error)})
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
# stage counters and rings
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
    starve.  Both poll ``stop`` so that teardown never deadlocks; ``get``
    also calls ``check`` at each poll (it raises to abandon the wait)."""

    POLL_S = 0.05

    def __init__(self, depth: int, producer: Optional[StageStats] = None,
                 consumer: Optional[StageStats] = None):
        self.q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self._producer = producer
        self._consumer = consumer

    def put(self, item, stop: Optional[threading.Event]) -> bool:
        t0 = None
        while stop is None or not stop.is_set():
            try:
                self.q.put(item, timeout=self.POLL_S)
            except queue.Full:
                if t0 is None:
                    t0 = time.monotonic()
                continue
            if self._producer is not None:
                if t0 is not None:
                    self._producer.add(backpressure_s=time.monotonic() - t0)
                self._producer.sample_occupancy(self.q.qsize())
            return True
        if t0 is not None and self._producer is not None:
            self._producer.add(backpressure_s=time.monotonic() - t0)
        return False

    def get(self, stop: Optional[threading.Event], check=None):
        t0 = None
        try:
            while stop is None or not stop.is_set():
                try:
                    return self.q.get(timeout=self.POLL_S)
                except queue.Empty:
                    if t0 is None:
                        t0 = time.monotonic()
                    if check is not None:
                        check()
            return _NO_ITEM
        finally:
            if t0 is not None and self._consumer is not None:
                self._consumer.add(starve_s=time.monotonic() - t0)

    def try_get(self):
        try:
            return self.q.get_nowait()
        except queue.Empty:
            return _NO_ITEM

    def drain(self) -> None:
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
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
    """Decode worker threads (the JAX package's pool, which its autoscaler
    resizes; the port's stays at its size).  Workers take ``(future, fn,
    args)`` tickets and resolve real :class:`concurrent.futures.Future`
    objects, so the assembler reads a decode's result or its exception
    from the future.  The tickets in flight are bounded by the assembler's
    decode window, the only submitter."""

    def __init__(self, workers: int, thread_name_prefix: str = "decode"):
        self._tickets: "queue.Queue" = queue.Queue()
        self._shutdown = threading.Event()
        self.threads = [threading.Thread(target=self._worker, daemon=True,
                                         name=f"{thread_name_prefix}-{i}")
                        for i in range(1, max(1, int(workers)) + 1)]
        for t in self.threads:
            t.start()

    def _worker(self) -> None:
        while not self._shutdown.is_set():
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

    def submit(self, fn, *args) -> "futures.Future":
        fut: "futures.Future" = futures.Future()
        self._tickets.put((fut, fn, args))
        return fut

    def shutdown(self, cancel_futures: bool = False) -> None:
        """Stop the workers (each ends after its ticket in hand) and cancel
        the queued tickets if asked; the owner joins :attr:`threads`
        (:func:`join_threads`)."""
        self._shutdown.set()
        if cancel_futures:
            try:
                while True:
                    fut, _fn, _args = self._tickets.get_nowait()
                    fut.cancel()
            except queue.Empty:
                pass


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
    (``bigdl.ingest.maxBadRecords``), which skips the damage."""

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
        from bigdl_tpu_torch.dataset.seqfile import (
            CorruptRecordError, read_image_seqfile,
            read_image_seqfile_resilient)
        yielded = 0
        try:
            for rec in read_image_seqfile(path):
                yield rec
                yielded += 1
            return
        except CorruptRecordError:
            if quarantine.budget <= 0:
                raise            # fail fast (budget 0)
        # a dirty file: read it again, skipping the damage into the
        # quarantine, and go on after the records already given
        seen = 0
        for rec in read_image_seqfile_resilient(
                path, on_skip=lambda err, _resume: quarantine.admit(
                    "seqfile_read", None, path, err)):
            seen += 1
            if seen > yielded:
                yield rec

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
    - a *decode pool* (``decode_workers`` threads; cv2 and PIL release the
      GIL while they decode) keeps a window of decodes in flight across
      batch boundaries;
    - an *assembler* thread takes the decoded images in record order,
      draws crops and flips from the cloned generator and packs each batch
      (the native assembler releases the GIL);
    - batches wait in a bounded *batch ring* for the consumer, each with
      the generator state to commit when it is taken.

    Outputs per batch: float32 NCHW normalised (default); uint8 NCHW
    (``device_normalize``, for ``nn.ChannelNormalize``); or, with
    ``device_augment`` (default ``bigdl.ingest.deviceAugment``), the input
    list ``[frames, offsets, flips]``: the full decoded uint8 NHWC frames,
    (N, 2) int32 crop origins and (N,) uint8 flip flags, for
    ``nn.DeviceAugment`` to crop, flip and transpose on the device.
    Ring depths and pool widths default from ``bigdl.ingest.*``.
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
        asked = []
        if device_jitter:
            asked.append("device_jitter (ColorJitter keyed by JAX's "
                         "threefry)")
        if (max_stage_restarts if max_stage_restarts is not None else
                config.get_int("bigdl.ingest.maxStageRestarts", 0)) > 0:
            asked.append("stage restarts (bigdl.ingest.maxStageRestarts)")
        if (stall_timeout if stall_timeout is not None else
                config.get_float("bigdl.ingest.stallTimeoutSec", 0.0)) > 0:
            asked.append("stall detection (bigdl.ingest.stallTimeoutSec)")
        if (autoscale if autoscale is not None else
                config.get_bool("bigdl.ingest.autoscale.enabled", False)):
            asked.append("the decode-pool autoscaler "
                         "(bigdl.ingest.autoscale.enabled)")
        if (fallback_on_failure if fallback_on_failure is not None else
                config.get_bool("bigdl.ingest.fallbackOnFailure", False)):
            asked.append("the synchronous fallback "
                         "(bigdl.ingest.fallbackOnFailure)")
        if (epoch_cache if epoch_cache is not None else
                config.get_bool("bigdl.ingest.epochCache", False)):
            asked.append("the decoded-epoch cache (bigdl.ingest.epochCache)")
        if asked:
            raise NotImplementedError(
                f"StreamingIngest: {'; '.join(asked)}: not ported yet")
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
        self.stage_workers = {"decode": self.decode_workers,
                              "assemble": self.assemble_threads}
        # per-run stage stats: a ShardedDataSet applies one transformer
        # to every shard, so several runs can be live at once
        self._active_stats: List[dict] = []
        self._last_stats: Optional[dict] = None
        self.quarantine: Optional[RecordQuarantine] = None
        self._active_quarantines: List[RecordQuarantine] = []
        self.run_history: List[dict] = []

    # ---- diagnostics ----------------------------------------------------

    def has_active_run(self) -> bool:
        return bool(self._active_stats)

    def quarantined_count(self) -> int:
        """Data-error records skipped, summed over every active run, else
        the last run's."""
        runs = self._active_quarantines or (
            [self.quarantine] if self.quarantine is not None else [])
        return sum(q.count for q in runs)

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
        from bigdl_tpu_torch.utils.random_generator import RandomGenerator

        stats = {name: StageStats(name)
                 for name in ("read", "decode", "assemble", "consume")}
        self._active_stats.append(stats)
        _LIVE.add(self)
        # the per-stage scalars flow through the registry's one flush path
        # (registered at a run's start: the port's registry is empty at
        # import)
        telemetry.REGISTRY.register_provider("ingest", summary_scalars)
        quarantine = RecordQuarantine(self.max_bad_records)
        self.quarantine = quarantine
        self._active_quarantines.append(quarantine)

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
        record_ring = _Ring(self.record_ring_depth, producer=stats["read"],
                            consumer=stats["assemble"])
        batch_ring = _Ring(self.batch_ring_depth, producer=stats["assemble"],
                           consumer=stats["consume"])
        pool = _DecodePool(self.decode_workers,
                           thread_name_prefix="ingest-decode")
        ch, cw = self.crop
        done = {"reader": [False], "assembler": [False]}
        asm = {"pending": deque(),   # (index, record, decode future), in order
               "done": False,        # upstream exhausted, or its error queued
               "aborted": False,     # teardown seen mid-wait
               "imgs": [], "recs": [], "offsets": [], "flips": []}

        def reader() -> None:
            """Upstream records into the record ring.  The upstream draws no
            host randomness (crops and flips are the assembler's,
            reshuffles the trainer's producer's)."""
            index = 0
            try:
                while True:
                    t0 = time.monotonic()
                    try:
                        rec = next(it)
                    except StopIteration:
                        break
                    t1 = time.monotonic()
                    stats["read"].add(items=1, busy_s=t1 - t0)
                    telemetry.add_span_s("ingest/read", t0, t1)
                    if not record_ring.put((index, rec), stop):
                        done["reader"][0] = True
                        return
                    index += 1
                record_ring.put(_END, stop)
            except BaseException as e:  # noqa: BLE001 raised downstream
                record_ring.put(e, stop)
            done["reader"][0] = True

        def timed_decode(idx: int, rec) -> np.ndarray:
            t0 = time.monotonic()
            try:
                img = MTLabeledBGRImgToBatch._decode(rec.bytes)
            except ImportError:
                raise       # no decoder installed: not a data fault
            except Exception as e:
                raise IngestDataError(
                    f"undecodable image at stream position {idx}: "
                    f"{e!r}") from e
            t1 = time.monotonic()
            stats["decode"].add(items=1, busy_s=t1 - t0)
            telemetry.add_span_s("ingest/decode", t0, t1)
            return img

        def fill(block: bool) -> None:
            """Top up the window of decodes in flight; wait for a record
            only when the window is empty."""
            pending = asm["pending"]
            while not asm["done"] and len(pending) < self.decoded_ring_depth:
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
                pending.append((idx, rec, pool.submit(timed_decode, idx,
                                                      rec)))

        def pack_batch():
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

        def admit_and_append(idx: int, rec, img) -> bool:
            """Crop-fit check, then the crop and flip draws in record order
            (the draws of MTLabeledBGRImgToBatch).  False when the record
            was quarantined, before any draw."""
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
            return True

        def emit() -> bool:
            batch, n, pack_s = pack_batch()
            if not batch_ring.put((batch, drawer.np.get_state()), stop):
                return False
            stats["assemble"].add(items=n, busy_s=pack_s)
            for key in ("imgs", "recs", "offsets", "flips"):
                asm[key].clear()
            return True

        def assembler() -> None:
            pending, imgs = asm["pending"], asm["imgs"]
            try:
                while True:
                    fill(block=True)
                    if asm["aborted"]:
                        done["assembler"][0] = True
                        return
                    if not pending:
                        break
                    idx, rec, fut = pending.popleft()
                    if rec is None:      # upstream error, in order
                        raise fut
                    try:
                        if not fut.done():   # waiting on decode: starve
                            t0 = time.monotonic()
                            while not stop.is_set():
                                try:
                                    fut.result(timeout=_Ring.POLL_S)
                                    break
                                except futures.TimeoutError:
                                    continue
                            stats["assemble"].add(
                                starve_s=time.monotonic() - t0)
                            if stop.is_set():    # teardown mid-wait
                                done["assembler"][0] = True
                                return
                        img = fut.result()
                    except BaseException as e:
                        if _is_data_error(e):
                            quarantine.admit("decode", idx, rec.name, e)
                            continue
                        raise
                    fill(block=False)    # the next batch's decodes go on
                    if not admit_and_append(idx, rec, img):
                        continue
                    if len(imgs) == self.batch_size and not emit():
                        done["assembler"][0] = True
                        return
                if imgs and not emit():
                    done["assembler"][0] = True
                    return
                batch_ring.put(_END, stop)
            except BaseException as e:  # noqa: BLE001 raised at the consumer
                batch_ring.put(e, stop)
            done["assembler"][0] = True

        threads = {}
        for tname, fn in (("reader", reader), ("assembler", assembler)):
            threads[tname] = threading.Thread(target=fn, daemon=True,
                                              name=f"ingest-{tname}")
            threads[tname].start()

        def check_stages() -> None:
            """A stage thread gone without an orderly exit (a silent death)
            would leave the consumer waiting forever: raise instead."""
            for tname, t in threads.items():
                if not t.is_alive() and not done[tname][0]:
                    telemetry.counter(
                        "Ingest/engine_failures", summary=True,
                        help="ingest engines declared dead").inc()
                    raise IngestInfraError(
                        f"ingest stage '{tname}' of '{self.name}' died "
                        "without surfacing an error (stage restarts are not "
                        "ported)", diagnosis=self.stats())

        try:
            while True:
                item = batch_ring.get(stop, check_stages)
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
            active_forks.discard(fork_token)
            for i, run in enumerate(self._active_stats):
                if run is stats:
                    del self._active_stats[i]
                    break
            self._active_quarantines = [
                q for q in self._active_quarantines if q is not quarantine]
            self._last_stats = stats
            self.run_history.append({"quarantine": quarantine.summary()})
            stop.set()
            pool.shutdown(cancel_futures=True)
            for ring in (record_ring, batch_ring):
                ring.drain()
            try:
                # every wait of a stage thread polls ``stop``; what can
                # still hold one is work in hand (an upstream read, a
                # decode), and a close never returns with it running
                join_threads(list(threads.values()) + pool.threads,
                             f"StreamingIngest '{self.name}'")
            finally:
                # a last put may land between the first drain and the joins
                for ring in (record_ring, batch_ring):
                    ring.drain()


def summary_scalars():
    """``(tag, value)`` pairs for the training summary (JAX :1803): each
    stage's throughput, stall fraction and ring occupancy and the
    workers of every engine with an ACTIVE run, tagged with the engine's
    name (``Ingest/<name>/<stage>/...``); the quarantine count once it is
    nonzero.  Registered as the registry's ``ingest`` provider when a run
    starts."""
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
        quarantined = eng.quarantined_count()
        if quarantined:
            out.append((f"{prefix}/quarantined", quarantined))
    return out
