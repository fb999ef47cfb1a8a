"""The serving engine of the port: bounded admission, micro-batching,
graceful drain (``bigdl_tpu/serving/engine.py``).

Request lifecycle (every submitted request ends with EXACTLY one outcome,
so ``completed + shed + rejected + quarantined == submitted``)::

    submit ──► rejected   (Overloaded at the door: queue full, projected
       │                   wait past the deadline budget, or draining /
       │                   closed — always fast, always structured)
       ▼
    admission queue (bounded: bigdl.serving.maxQueueDepth)
       │
       ▼  batcher thread coalesces up to bigdl.serving.maxBatch
    ── shed        (deadline expired at dequeue time, before the request
       │            takes a device slot; also requests left queued when
       │            the drain grace period lapses, and the in-flight
       │            victims of a failed dispatch)
    ── quarantined (poison payload: undecodable / ill-shaped — a
       │            ServingDataError fails the ONE offending request and
       │            the batch stays alive)
       ▼
    dispatch (pad to the bucket plan → forward on the device → one host
       │      pull) ──► completed (per-row numpy results)

The dispatcher pads every batch to ``bigdl.compile.buckets`` (falling back to
a single ``maxBatch`` bucket), as the JAX package does.  ``stop()`` closes
admission, drains queued work within ``bigdl.serving.gracePeriod`` seconds,
sheds what is left retriably and joins the batcher thread.

Not in this slice (ROADMAP lists them): the telemetry histograms and
counters, per-request tracing, incident bundles, the host-memory governor,
the chaos hooks, the hung-dispatch watchdog with its cooldown, SIGTERM
preemption, the batcher's linger (``bigdl.serving.lingerMs``) and the fleet
supervisor's ``abandon``.
"""

from __future__ import annotations

import logging
import math
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.engine import DeviceLike, default_device, to_device
from bigdl_tpu_torch.optim.evaluator import _eval_forward
from bigdl_tpu_torch.optim.predictor import Predictor
from bigdl_tpu_torch.utils import compile_cache, config

logger = logging.getLogger("bigdl_tpu_torch")


class ServingError(RuntimeError):
    """Base class of the serving-path taxonomy.  ``retriable`` tells the
    client whether the same payload can succeed later / elsewhere."""

    retriable = False


class Overloaded(ServingError):
    """Admission control said no — at the door, in microseconds.  The
    client learns the queue depth, the projected wait, and that a retry
    can help."""

    retriable = True

    def __init__(self, reason: str, queue_depth: int = 0,
                 max_depth: int = 0,
                 projected_wait_ms: Optional[float] = None,
                 deadline_ms: Optional[float] = None):
        self.reason = reason
        self.queue_depth = queue_depth
        self.max_depth = max_depth
        self.projected_wait_ms = projected_wait_ms
        self.deadline_ms = deadline_ms
        detail = f"rejected at admission ({reason}): depth " \
                 f"{queue_depth}/{max_depth}"
        if projected_wait_ms is not None:
            detail += (f", projected wait {projected_wait_ms:.1f} ms vs "
                       f"deadline {deadline_ms:.1f} ms")
        super().__init__(detail + " — retriable")


class DeadlineExceeded(ServingError):
    """The request aged past its deadline while queued and was shed at
    dequeue time — it never occupied a device slot."""

    retriable = True

    def __init__(self, waited_ms: float, deadline_ms: float):
        self.waited_ms = waited_ms
        self.deadline_ms = deadline_ms
        super().__init__(
            f"shed: waited {waited_ms:.1f} ms in queue, deadline was "
            f"{deadline_ms:.1f} ms — retriable (but mind your own deadline)")


class ServingDataError(ServingError):
    """A poison request: undecodable or ill-shaped payload.  Quarantined,
    never retried, and never allowed to kill the batch it rode in with."""

    retriable = False


class ServingInfraError(ServingError):
    """An infrastructure fault on the serving path (dispatch failure,
    drain timeout): the request payload is fine — retry it."""

    retriable = True


#: terminal request outcomes — the accounting identity is
#: completed + shed + rejected + quarantined == submitted
OUTCOMES = ("completed", "shed", "rejected", "quarantined")


class RequestHandle:
    """One admitted request: a one-shot future whose terminal state is
    exactly one of :data:`OUTCOMES` (``_finish`` is first-wins)."""

    __slots__ = ("raw", "index", "submit_ns", "deadline_ns", "finish_ns",
                 "outcome", "_result", "_error", "_done", "_lock")

    def __init__(self, raw, index: int, submit_ns: int, deadline_ns: int):
        self.raw = raw
        self.index = index            # admission position
        self.submit_ns = submit_ns
        self.deadline_ns = deadline_ns
        self._lock = threading.Lock()
        self.finish_ns: Optional[int] = None            # guarded-by: _lock
        self.outcome: Optional[str] = None              # guarded-by: _lock
        self._result = None                             # guarded-by: _lock
        self._error: Optional[BaseException] = None     # guarded-by: _lock
        self._done = threading.Event()

    def _finish(self, outcome: str, result=None,
                error: Optional[BaseException] = None) -> bool:
        with self._lock:
            if self._done.is_set():
                return False
            self.outcome = outcome
            self._result = result
            self._error = error
            self.finish_ns = time.monotonic_ns()
            self._done.set()
        return True

    def latency_ms(self) -> Optional[float]:
        """Submit-to-terminal-state latency; None while in flight."""
        if self.finish_ns is None:
            return None
        return (self.finish_ns - self.submit_ns) / 1e6

    def result(self, timeout: Optional[float] = None):
        """The per-request model output, or raises the terminal error."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.index} still in flight after {timeout} s")
        if self._error is not None:
            raise self._error
        return self._result


class _ServiceEMA:
    """The admission controller's batch service-time estimate: the first
    ``warmup`` observations are only collected (first calls pay one-time
    costs), the EMA seeds from their minimum, then moves by ``alpha``."""

    def __init__(self, warmup: int, alpha: float = 0.1):
        self.warmup = max(0, int(warmup))
        self.alpha = alpha
        self.ema: Optional[float] = None
        self._seen: List[float] = []

    def observe(self, value: float) -> None:
        if len(self._seen) < self.warmup:
            self._seen.append(value)
            return
        if self.ema is None:
            self.ema = min(self._seen) if self._seen else value
        self.ema = (1 - self.alpha) * self.ema + self.alpha * value


class ServingEngine:
    """Continuous micro-batching inference server over one model, which
    must already lie on ``device`` (default ``"cuda"``; the tests pass
    ``"cpu"``).  All knobs default from ``bigdl.serving.*``; constructor
    arguments override per-engine.  ``fold_bn=True`` serves a copy of the
    model with every conv + BatchNorm pair folded, as ``Predictor`` does."""

    def __init__(self, model: torch.nn.Module, fold_bn: bool = False,
                 max_batch: Optional[int] = None,
                 max_queue_depth: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 admission_factor: Optional[float] = None,
                 grace_period: Optional[float] = None,
                 start: bool = True, device: DeviceLike = "cuda"):
        self.device = default_device(device)
        self.model = Predictor(model, fold_bn=fold_bn,
                               device=self.device).model
        self.max_batch = int(max_batch if max_batch is not None else
                             config.get_int("bigdl.serving.maxBatch", 16))
        self.max_queue_depth = int(
            max_queue_depth if max_queue_depth is not None else
            config.get_int("bigdl.serving.maxQueueDepth", 128))
        self.deadline_ms = float(
            deadline_ms if deadline_ms is not None else
            config.get_float("bigdl.serving.deadlineMs", 1000.0))
        self.admission_factor = float(
            admission_factor if admission_factor is not None else
            config.get_float("bigdl.serving.admissionDeadlineFactor", 1.0))
        self.grace_period = float(
            grace_period if grace_period is not None else
            config.get_float("bigdl.serving.gracePeriod", 5.0))
        self.poll_interval = config.get_float("bigdl.serving.pollInterval",
                                              0.05)
        self.warmup_batches = config.get_int("bigdl.serving.warmupBatches",
                                             3)
        # maxBatch is always IN the plan, so no occupancy rounds past the
        # largest bucket warmup ran
        self._buckets = sorted(set(
            (compile_cache.configured_buckets() or []) + [self.max_batch]))
        self._forward = _eval_forward(self.model)
        # the admission queue IS the bound: put_nowait + Full -> Overloaded
        self._q: "queue.Queue[RequestHandle]" = queue.Queue(
            maxsize=self.max_queue_depth)
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = dict.fromkeys(OUTCOMES, 0)  # guarded-by: _lock
        self._counts["submitted"] = 0
        self._next_index = 0                            # guarded-by: _lock
        self._draining = False                          # guarded-by: _lock
        self._drain_deadline: Optional[float] = None    # guarded-by: _lock
        self._closed = False                            # guarded-by: _lock
        self._started = False                           # guarded-by: _lock
        self._stop_event = threading.Event()
        self._template: Optional[Tuple[Tuple[int, ...], str]] = None  # guarded-by: _lock
        self._ema = _ServiceEMA(self.warmup_batches)
        self.batches = 0
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "ServingEngine":
        if self._closed:
            raise ServingInfraError(
                "engine is terminal: stop() is one-way — build a new "
                "engine instead of restarting this one")
        with self._lock:
            if self._started:
                return self
            self._started = True
        self._thread = threading.Thread(target=self._batcher_loop,
                                        daemon=True,
                                        name="serving-batcher")
        self._thread.start()
        return self

    def warmup(self, example_row: np.ndarray) -> None:
        """Run one forward per bucket, so the first real request pays no
        first-call cost against its deadline.  ``example_row`` is one
        request payload; it also pins the row template (shape and dtype)
        that later requests are validated against."""
        row = np.asarray(example_row)
        with self._lock:
            self._template = (row.shape, str(row.dtype))
        batch = np.broadcast_to(row, (max(self._buckets),) + row.shape)
        for b in self._buckets:
            self._run_forward(batch[:b])

    def stop(self, grace: Optional[float] = None) -> None:
        """Graceful shutdown: admission closes (late arrivals get a
        retriable :class:`Overloaded`), queued work drains within
        ``grace`` (default ``bigdl.serving.gracePeriod``), leftovers are
        shed retriably and the batcher thread is joined.  Idempotent and
        terminal: a stopped engine is never restarted."""
        if not self._started or self._closed:
            with self._lock:
                self._closed = True
            self._drain_leftovers()
            return
        with self._lock:
            if not self._draining:
                self._begin_drain_locked(time.monotonic(), grace)
            elif grace is not None:
                self._drain_deadline = time.monotonic() + grace
        self._stop_event.set()
        t = self._thread
        if t is not None:
            budget = grace if grace is not None else self.grace_period
            t.join(timeout=budget + 10.0)
        self._drain_leftovers()
        with self._lock:
            self._closed = True

    def close(self) -> None:
        self.stop()

    @property
    def terminal(self) -> bool:
        """True once the engine can never serve again."""
        return self._closed

    def batcher_alive(self) -> bool:
        t = self._thread
        return bool(t is not None and t.is_alive())

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- admission --------------------------------------------------------

    def submit(self, inputs, deadline_ms: Optional[float] = None
               ) -> RequestHandle:
        """Admit one request or raise :class:`Overloaded` — fast, at the
        door.  Returns a :class:`RequestHandle` future."""
        now = time.monotonic_ns()
        deadline = float(deadline_ms if deadline_ms is not None
                         else self.deadline_ms)
        with self._lock:
            self._counts["submitted"] += 1
            if self._closed or (self._stop_event.is_set() and
                                not self._draining):
                raise self._reject_locked("closed")
            if self._draining:
                raise self._reject_locked("draining")
            depth = self._q.qsize()
            if depth >= self.max_queue_depth:
                raise self._reject_locked("queue full", depth)
            ema = self._ema.ema
            if ema is not None:
                waves = math.ceil((depth + 1) / self.max_batch)
                projected = waves * ema
                if projected > self.admission_factor * deadline:
                    raise self._reject_locked(
                        "projected wait", depth,
                        projected_wait_ms=projected, deadline_ms=deadline)
            req = RequestHandle(inputs, self._next_index, now,
                                now + int(deadline * 1e6))
            self._next_index += 1
        try:
            self._q.put_nowait(req)
        except queue.Full:
            # a racing submit filled the last slot after the depth check
            with self._lock:
                raise self._reject_locked("queue full",
                                          self.max_queue_depth)
        if self._closed:
            # the batcher exited between the admission check and the
            # enqueue: nobody will pop the queue again — shed it now
            self._drain_leftovers()
        return req

    def _reject_locked(self, reason: str, depth: Optional[int] = None,
                       **kw) -> Overloaded:
        """Build the structured rejection and account it (the caller
        raises).  Runs under ``self._lock``."""
        self._counts["rejected"] += 1
        return Overloaded(reason,
                          queue_depth=(depth if depth is not None
                                       else self._q.qsize()),
                          max_depth=self.max_queue_depth, **kw)

    # -- accounting -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Outcome counters plus the accounting identity residual
        (``unaccounted`` includes requests still in flight — read after
        quiescing for the exact identity)."""
        with self._lock:
            out: Dict[str, Any] = dict(self._counts)
        out["unaccounted"] = out["submitted"] - sum(out[o] for o in OUTCOMES)
        out["batches"] = self.batches
        out["queue_depth"] = self._q.qsize()
        out["batch_ema_ms"] = self._ema.ema
        out["draining"] = self._draining
        return out

    def _account(self, req: RequestHandle, outcome: str,
                 error: Optional[BaseException] = None,
                 result=None) -> bool:
        if not req._finish(outcome, result=result, error=error):
            return False
        with self._lock:
            self._counts[outcome] += 1
        return True

    # -- the batcher thread -----------------------------------------------

    def _batcher_loop(self) -> None:
        try:
            while True:
                if not self._draining and self._stop_event.is_set():
                    with self._lock:
                        self._begin_drain_locked(time.monotonic())
                if self._draining:
                    if self._q.empty():
                        break
                    if time.monotonic() > self._drain_deadline:
                        self._drain_leftovers()
                        break
                try:
                    first = self._q.get(timeout=self.poll_interval)
                except queue.Empty:
                    continue
                batch: List[RequestHandle] = []
                try:
                    self._assemble(first, batch)
                    if batch:
                        self._dispatch_batch(batch)
                except Exception as e:  # noqa: BLE001 — engine must outlive
                    self._abort_inflight(
                        batch, ServingInfraError(f"dispatch failed: {e!r}"))
        finally:
            # _closed BEFORE the sweep: a racing submit either observes
            # _closed (and sheds its own request) or enqueued before this
            # sweep (which sheds it)
            with self._lock:
                self._closed = True
            self._drain_leftovers()

    def _begin_drain_locked(self, started_at: float,
                            grace: Optional[float] = None) -> None:
        """Enter drain mode (callers hold ``self._lock``).  The deadline
        is published before the flag: the batcher reads both without the
        lock."""
        budget = grace if grace is not None else self.grace_period
        self._drain_deadline = started_at + budget
        self._draining = True
        logger.info("serving engine draining: grace %.1f s, %d request(s) "
                    "queued", budget, self._q.qsize())

    def _drain_leftovers(self) -> None:
        """Shed everything still queued, retriably: the payloads were never
        the problem."""
        shed = 0
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            err = ServingInfraError(
                "engine draining: request was not dispatched within the "
                "grace period — retriable")
            shed += self._account(req, "shed", error=err)
        if shed:
            logger.warning("serving drain shed %d queued request(s)", shed)

    def _assemble(self, first: RequestHandle,
                  batch: List[RequestHandle]) -> None:
        """Coalesce up to ``maxBatch`` VALID requests already queued into
        ``batch``: expired ones are shed, poison ones quarantined — neither
        consumes a slot."""
        req = first
        while True:
            now = time.monotonic_ns()
            if now > req.deadline_ns:
                waited = (now - req.submit_ns) / 1e6
                deadline = (req.deadline_ns - req.submit_ns) / 1e6
                self._account(req, "shed",
                              error=DeadlineExceeded(waited, deadline))
            else:
                try:
                    row = self._decode(req)
                except ServingDataError as e:
                    self._account(req, "quarantined", error=e)
                else:
                    req.raw = row
                    batch.append(req)
            if len(batch) >= self.max_batch:
                break
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break

    def _decode(self, req: RequestHandle) -> np.ndarray:
        """Per-request validation: anything wrong with the PAYLOAD raises
        :class:`ServingDataError` here, where it fails one request instead
        of a batch."""
        try:
            row = np.asarray(req.raw)
        except Exception as e:
            raise ServingDataError(
                f"undecodable request payload: {e!r}") from e
        if not np.issubdtype(row.dtype, np.number):
            raise ServingDataError(
                f"non-numeric request payload (dtype {row.dtype})")
        with self._lock:
            if self._template is None:
                self._template = (row.shape, str(row.dtype))
            template = self._template
        if (row.shape, str(row.dtype)) != template:
            raise ServingDataError(
                f"ill-shaped request: got {row.shape} {row.dtype}, this "
                f"engine serves {template[0]} {template[1]}")
        return row

    def _run_forward(self, rows: np.ndarray) -> np.ndarray:
        """Pad to the bucket plan, run the forward on the device, pull the
        host result once, slice the padding back off."""
        n = rows.shape[0]
        eff = compile_cache.bucket_size(n, self._buckets)
        inputs = compile_cache.pad_batch(rows, n, eff)
        out = self._forward(to_device(inputs, self.device))
        return compile_cache.slice_rows(out.cpu().numpy(), n)

    def _dispatch_batch(self, batch: List[RequestHandle]) -> None:
        t0 = time.monotonic_ns()
        self.batches += 1
        out = self._run_forward(np.stack([r.raw for r in batch]))
        for i, req in enumerate(batch):
            self._account(req, "completed", result=out[i])
        self._ema.observe((time.monotonic_ns() - t0) / 1e6)

    def _abort_inflight(self, batch: List[RequestHandle],
                        error: ServingError) -> None:
        """A dispatch died under the batch: fail every unfinished
        in-flight request with the diagnosis, each with its own exception
        instance."""
        failed = sum(
            self._account(r, "shed", error=type(error)(*error.args))
            for r in batch)
        logger.error("serving dispatch aborted: %d in-flight request(s) "
                     "failed with %s", failed, error)
