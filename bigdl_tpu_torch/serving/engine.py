"""The serving engine of the port: bounded admission, micro-batching,
graceful drain (``bigdl_tpu/serving/engine.py``).

Request lifecycle (every submitted request ends with EXACTLY one outcome,
so ``completed + shed + rejected + quarantined == submitted``)::

    submit ──► rejected   (Overloaded at the door: queue full, projected
       │                   wait past the deadline budget, cooldown after a
       │                   watchdog fire, or draining / closed — always
       │                   fast, always structured, always retriable)
       ▼
    admission queue (bounded: bigdl.serving.maxQueueDepth)
       │
       ▼  batcher thread coalesces up to bigdl.serving.maxBatch
    ── shed        (deadline expired at dequeue time, before the request
       │            takes a device slot; also requests left queued when
       │            the drain grace period lapses, and the in-flight
       │            victims of a failed or hung dispatch)
    ── quarantined (poison payload: undecodable / ill-shaped — a
       │            ServingDataError fails the ONE offending request and
       │            the batch stays alive)
       ▼
    dispatch (pad to the bucket plan → forward on the device → one host
       │      pull) ──► completed (per-row numpy results)

The dispatcher pads every batch to ``bigdl.compile.buckets`` (falling back to
a single ``maxBatch`` bucket), as the JAX package does; with
``bigdl.serving.lingerMs`` > 0 the batcher waits that long for a partial
batch to fill.  ``stop()`` closes admission, drains queued work within
``bigdl.serving.gracePeriod`` seconds, sheds what is left retriably and joins
the batcher thread.  A preemption request (``utils.elastic``: the flag a
SIGTERM sets under ``PreemptionHandler``) starts the same drain from the
batcher, its grace clock started when the preemption was requested.

The failure taxonomy (JAX :120-135, :189-231, :605-682, :866): with
``bigdl.serving.stallFactor`` > 0 a :class:`HungDispatchWatchdog` (the
trainers' ``HungStepWatchdog`` pointed at the batcher thread, seeded from
the minimum of ``bigdl.serving.warmupBatches`` dispatches) aborts a dispatch
open past that factor times the batch-time EMA by raising
:class:`HungDispatchError` in the batcher; the batch's requests are shed
with the diagnosis and admission answers ``cooldown`` for
``bigdl.serving.cooldownSteps`` clean batches, or until the backlog clears.
The abort is ``PyThreadState_SetAsyncExc``: it lands when the batcher next
runs Python bytecode.  A batcher inside one C call (a CUDA synchronize, a
device-to-host copy waiting on a kernel that never ends) is not interrupted
until that call returns, so a kernel that truly hangs the card is detected
and logged but its batch is shed only if the call ever comes back; the
injected ``bigdl.chaos.hangDispatchAt`` wedge is a Python sleep and is
aborted within one 20 ms slice.  The host-memory governor's
``serving_admission`` account holds each queued or in-flight payload's
bytes, charged at admission and released at the terminal outcome; a payload
larger than ``bigdl.resources.hostMemBudgetMB`` raises ``HostMemoryError``
before it counts as submitted.  The chaos hooks ``slowRequestAt``,
``poisonRequestAt`` and ``hangDispatchAt`` (:mod:`~bigdl_tpu_torch.utils.
chaos`) act on the batcher.  :meth:`RequestHandle.abandon` lets a
supervisor shed a request the engine can no longer account (a crashed
batcher, :meth:`ServingEngine.crashed`).

Telemetry (JAX :228-229, :323-326, :473-600, :697-882): the
``Serving/latency_ms`` (completed requests, with their trace ids as
exemplars) and ``Serving/batch_occupancy`` histograms; the
``Serving/submitted``, ``rejected``, ``shed``, ``quarantined``,
``completed`` and ``batches`` counters (by ``reason`` label too); the
``Serving/queue_depth``, ``batch_ms`` and ``p50/p95/p99_ms`` gauges.  With
``bigdl.trace.requests`` (:mod:`~bigdl_tpu_torch.telemetry.request_trace`)
every submission gets a trace id at the door and the chain
``request/admit`` → ``request/queue_wait`` → ``request/coalesce`` →
``request/dispatch``, ending in exactly one verdict (the ``rejected``
ones at the door, ``aborted`` for a supervisor's :meth:`RequestHandle.
abandon`).  The incident recorder takes the drain, a quarantine and an
aborted dispatch, and writes one bundle per quarantine or abort kind
(``bigdl.incident.autoDump``).  A watchdog fire counts
``Serving/watchdog_fired`` and sets ``Serving/watchdog_detect_ms`` and
``Serving/watchdog_threshold_ms``.
"""

from __future__ import annotations

import logging
import math
import queue
import threading
import time
from contextlib import nullcontext
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch import telemetry
from bigdl_tpu_torch.engine import DeviceLike, default_device, to_device
from bigdl_tpu_torch.optim.evaluator import _eval_forward
from bigdl_tpu_torch.optim.predictor import Predictor
from bigdl_tpu_torch.resources import GOVERNOR as _resource_governor
from bigdl_tpu_torch.resources import item_nbytes as _item_nbytes
from bigdl_tpu_torch.telemetry import incident, request_trace
from bigdl_tpu_torch.utils import chaos, compile_cache, config, elastic
from bigdl_tpu_torch.analysis.hostsync import host_pull
from bigdl_tpu_torch.analysis.lockwitness import make_lock
from bigdl_tpu_torch.analysis.retrace import RetraceSentinel, Spec

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


class HungDispatchError(ServingInfraError):
    """Injected into the batcher (or the LM scheduler) by the hung-dispatch
    watchdog: a dispatch stayed open past ``stallFactor`` x the batch-time
    EMA.  The in-flight requests fail with this diagnosis; the engine cools
    down before re-admitting."""


class HungDispatchWatchdog(elastic.HungStepWatchdog):
    """The trainers' hung-step watchdog pointed at a serving thread: the
    same monitor, warmup-minimum EMA seeding and asynchronous abort, but it
    injects :class:`HungDispatchError` and counts under
    ``Serving/watchdog_*``."""

    EXC = HungDispatchError
    METRIC_PREFIX = "Serving"
    INSTANT_NAME = "serving/hung_dispatch"


#: terminal request outcomes — the accounting identity is
#: completed + shed + rejected + quarantined == submitted
OUTCOMES = ("completed", "shed", "rejected", "quarantined")


class RequestHandle:
    """One admitted request: a one-shot future whose terminal state is
    exactly one of :data:`OUTCOMES` (``_finish`` is first-wins, so a
    request is never both shed by the drain and completed by a racing
    dispatch, or by a supervisor's :meth:`abandon`)."""

    __slots__ = ("raw", "index", "submit_ns", "deadline_ns", "finish_ns",
                 "outcome", "_result", "_error", "_done", "_lock",
                 "trace_id", "payload_nbytes")

    def __init__(self, raw, index: int, submit_ns: int, deadline_ns: int,
                 trace_id: Optional[str] = None):
        self.raw = raw
        self.index = index            # admission position
        self.submit_ns = submit_ns
        self.deadline_ns = deadline_ns
        self.trace_id = trace_id      # None when request tracing is disarmed
        self._lock = make_lock("serving.handle")
        self.payload_nbytes = 0       # guarded-by: _lock — governor bytes
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
            self.finish_ns = telemetry.clock_ns()
            self._done.set()
        return True

    def latency_ms(self) -> Optional[float]:
        """Submit-to-terminal-state latency; None while in flight."""
        if self.finish_ns is None:
            return None
        return (self.finish_ns - self.submit_ns) / 1e6

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        """The per-request model output, or raises the terminal error."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.index} still in flight after {timeout} s")
        if self._error is not None:
            raise self._error
        return self._result

    def error(self) -> Optional[BaseException]:
        return self._error if self._done.is_set() else None

    def _release_bytes(self) -> None:
        """Give the admission bytes back to the governor, once."""
        with self._lock:
            nbytes, self.payload_nbytes = self.payload_nbytes, 0
        if nbytes:
            _resource_governor.account("serving_admission").sub(nbytes)

    def abandon(self, error: Optional[BaseException] = None,
                reason: str = "abandoned") -> bool:
        """Shed this request from OUTSIDE the engine: a supervisor sweeping
        the in-flight requests of a crashed batcher, which can never account
        them.  First-wins like every terminal transition; releases the
        admission bytes (the engine that charged them may be dead) and
        records the ``aborted`` verdict in the request's trace.  The
        engine's own counts do not see it: the supervisor counts it as
        shed.  True when THIS call finished the request."""
        err = error if error is not None else ServingInfraError(
            "request abandoned by its supervisor — retriable")
        if not self._finish("shed", error=err):
            return False
        request_trace.verdict(self.trace_id, "aborted", error=err,
                              reason=reason)
        self._release_bytes()
        telemetry.counter("Serving/shed").inc()
        telemetry.counter("Serving/shed", labels={"reason": reason}).inc()
        return True


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
                 stall_factor: Optional[float] = None,
                 grace_period: Optional[float] = None,
                 cooldown_batches: Optional[int] = None,
                 start: bool = True, device: DeviceLike = "cuda"):
        chaos.refuse_unported_keys()
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
        self.stall_factor = float(
            stall_factor if stall_factor is not None else
            config.get_float("bigdl.serving.stallFactor", 0.0))
        self.grace_period = float(
            grace_period if grace_period is not None else
            config.get_float("bigdl.serving.gracePeriod", 5.0))
        self.cooldown_batches = int(
            cooldown_batches if cooldown_batches is not None else
            config.get_int("bigdl.serving.cooldownSteps", 8))
        self.linger_ms = config.get_float("bigdl.serving.lingerMs", 0.0)
        self.poll_interval = config.get_float("bigdl.serving.pollInterval",
                                              0.05)
        self.warmup_batches = config.get_int("bigdl.serving.warmupBatches",
                                             3)
        # maxBatch is always IN the plan, so no occupancy rounds past the
        # largest bucket warmup ran
        self._buckets = sorted(set(
            (compile_cache.configured_buckets() or []) + [self.max_batch]))
        self._forward = _eval_forward(self.model)
        # the recompile sentinel over the forward's signature (JAX :570).
        # A row family (row shape and dtype) is observed at its first
        # batch; the plan's other buckets of that family are then
        # registered, as the JAX package's bucket precompile registers
        # them.  A family first seen after warmup is a retrace.
        self._sentinel = RetraceSentinel.from_config("ServingEngine[forward]")
        self._families: set = set()
        # the admission queue IS the bound: put_nowait + Full -> Overloaded
        self._q: "queue.Queue[RequestHandle]" = queue.Queue(
            maxsize=self.max_queue_depth)
        self._lock = make_lock("serving.engine")
        # queued + in-flight payload bytes, rolled into Resources/host_bytes
        self._payload_acct = _resource_governor.account("serving_admission")
        self._counts: Dict[str, int] = dict.fromkeys(OUTCOMES, 0)  # guarded-by: _lock
        self._counts["submitted"] = 0
        self._next_index = 0                            # guarded-by: _lock
        self._cooldown = 0                              # guarded-by: _lock
        self._draining = False                          # guarded-by: _lock
        self._drain_deadline: Optional[float] = None    # guarded-by: _lock
        self._closed = False                            # guarded-by: _lock
        self._started = False                           # guarded-by: _lock
        self._stop_event = threading.Event()
        self._template: Optional[Tuple[Tuple[int, ...], str]] = None  # guarded-by: _lock
        self._ema = _ServiceEMA(self.warmup_batches)
        self.batches = 0
        self.watchdog: Optional[HungDispatchWatchdog] = None
        self._thread: Optional[threading.Thread] = None
        window = config.get_int("bigdl.telemetry.percentileWindow", 512)
        self._latency = telemetry.histogram(
            "Serving/latency_ms", window=window,
            help="per-request submit-to-result latency")
        self._occupancy = telemetry.histogram(
            "Serving/batch_occupancy",
            help="true (unpadded) requests per dispatched batch")
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
                self._begin_drain_locked("stop", time.monotonic(), grace)
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

    @property
    def draining(self) -> bool:
        return self._draining

    def queue_depth(self) -> int:
        """The admission queue's depth (a supervisor's load signal)."""
        return self._q.qsize()

    def batcher_alive(self) -> bool:
        t = self._thread
        return bool(t is not None and t.is_alive())

    def batcher_ident(self) -> Optional[int]:
        """The batcher thread's ident (None before ``start()``)."""
        t = self._thread
        return t.ident if t is not None else None

    def crashed(self) -> bool:
        """True when the batcher thread died WITHOUT an orderly drain or
        stop (an escaped error or an asynchronous kill): the signal a
        supervisor restarts a replica on."""
        t = self._thread
        return bool(self._started and t is not None and not t.is_alive()
                    and not self._draining and
                    not self._stop_event.is_set())

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- admission --------------------------------------------------------

    def submit(self, inputs, deadline_ms: Optional[float] = None
               ) -> RequestHandle:
        """Admit one request or raise :class:`Overloaded` — fast, at the
        door.  Returns a :class:`RequestHandle` future."""
        now = telemetry.clock_ns()
        deadline = float(deadline_ms if deadline_ms is not None
                         else self.deadline_ms)
        # a payload larger than the whole host budget can never be
        # admitted: raise BEFORE it counts as submitted
        payload_nbytes = _item_nbytes(inputs)
        _resource_governor.check_item("serving_admission", payload_nbytes)
        telemetry.counter("Serving/submitted").inc()
        # minted before the rejection checks: a rejected request still
        # explains itself
        tid = request_trace.mint("req", deadline_ms=deadline)
        with self._lock:
            self._counts["submitted"] += 1
            if self._closed or (self._stop_event.is_set() and
                                not self._draining):
                raise self._reject_locked("closed", trace_id=tid)
            if self._draining:
                raise self._reject_locked("draining", trace_id=tid)
            if self._cooldown > 0:
                raise self._reject_locked("cooldown", trace_id=tid)
            depth = self._q.qsize()
            if depth >= self.max_queue_depth:
                raise self._reject_locked("queue full", depth, trace_id=tid)
            ema = self._ema.ema
            if ema is not None:
                waves = math.ceil((depth + 1) / self.max_batch)
                projected = waves * ema
                if projected > self.admission_factor * deadline:
                    raise self._reject_locked(
                        "projected wait", depth, trace_id=tid,
                        projected_wait_ms=projected, deadline_ms=deadline)
            req = RequestHandle(inputs, self._next_index, now,
                                now + int(deadline * 1e6), trace_id=tid)
            self._next_index += 1
        request_trace.instant(tid, "request/admit", index=req.index,
                              depth=depth)
        # charged BEFORE the enqueue: once queued the batcher owns the
        # handle, and a completion racing a later charge would leak it
        with req._lock:
            req.payload_nbytes = payload_nbytes
        self._payload_acct.add(payload_nbytes)
        try:
            self._q.put_nowait(req)
        except queue.Full:
            # a racing submit filled the last slot after the depth check;
            # refund the never-queued payload
            req._release_bytes()
            with self._lock:
                raise self._reject_locked("queue full",
                                          self.max_queue_depth,
                                          trace_id=tid)
        if self._closed:
            # the batcher exited between the admission check and the
            # enqueue: nobody will pop the queue again — shed it now
            self._drain_leftovers()
        telemetry.gauge("Serving/queue_depth").set(self._q.qsize())
        return req

    def _reject_locked(self, reason: str, depth: Optional[int] = None,
                       trace_id: Optional[str] = None, **kw) -> Overloaded:
        """Build the structured rejection and account it (the caller
        raises).  Runs under ``self._lock``.  The ``rejected`` verdict's
        choke point: the error carries its trace id."""
        self._counts["rejected"] += 1
        telemetry.counter("Serving/rejected").inc()
        telemetry.counter("Serving/rejected",
                          labels={"reason": reason.replace(" ", "_")}).inc()
        err = Overloaded(reason,
                         queue_depth=(depth if depth is not None
                                      else self._q.qsize()),
                         max_depth=self.max_queue_depth, **kw)
        request_trace.verdict(trace_id, "rejected", error=err,
                              reason=reason.replace(" ", "_"))
        return err

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
        out["cooldown"] = self._cooldown
        out["draining"] = self._draining
        return out

    def _account(self, req: RequestHandle, outcome: str,
                 error: Optional[BaseException] = None,
                 result=None, reason: Optional[str] = None) -> bool:
        if not req._finish(outcome, result=result, error=error):
            return False
        req._release_bytes()
        with self._lock:
            self._counts[outcome] += 1
        # the choke point of every engine-side verdict; a completed
        # request's latency keeps its trace id as an exemplar
        request_trace.verdict(req.trace_id, outcome, error=error,
                              reason=reason)
        telemetry.counter(f"Serving/{outcome}").inc()
        if reason:
            telemetry.counter(f"Serving/{outcome}",
                              labels={"reason": reason}).inc()
        if outcome == "completed":
            self._latency.observe(req.latency_ms(), exemplar=req.trace_id)
        return True

    # -- the batcher thread -----------------------------------------------

    def _batcher_loop(self) -> None:
        telemetry.name_thread("serving-batcher")
        wd = None
        if self.stall_factor > 0:
            wd = HungDispatchWatchdog(
                self.stall_factor, warmup=self.warmup_batches,
                cooldown=self.cooldown_batches,
                poll_interval=min(self.poll_interval, 0.05))
            wd.start()                    # the abort's target: this thread
            self.watchdog = wd
        try:
            while True:
                if not self._draining:
                    if elastic.preemption_requested():
                        with self._lock:
                            self._begin_drain_locked(
                                "preemption",
                                elastic.preemption_requested_at() or
                                time.monotonic())
                    elif self._stop_event.is_set():
                        with self._lock:
                            self._begin_drain_locked("stop",
                                                     time.monotonic())
                if self._draining:
                    if self._q.empty():
                        break
                    if time.monotonic() > self._drain_deadline:
                        self._drain_leftovers()
                        break
                try:
                    with (wd.paused() if wd is not None else nullcontext()):
                        first = self._q.get(timeout=self.poll_interval)
                except queue.Empty:
                    with self._lock:
                        # backlog clear: a cooldown with no traffic would
                        # never end
                        self._cooldown = 0
                    continue
                batch: List[RequestHandle] = []
                try:
                    self._assemble(first, batch, wd)
                    if batch:
                        self._dispatch_batch(batch, wd)
                    elif wd is not None:
                        # a round that shed or quarantined all it popped
                        # supervised no dispatch: restart the open interval
                        wd.reset_interval()
                except HungDispatchError:
                    # the injected class carries no message: re-raise it to
                    # the clients as a diagnosed instance
                    ema = self._ema.ema
                    baseline = (f"{ema:.1f} ms EMA" if ema is not None
                                else "unseeded EMA")
                    diag = HungDispatchError(
                        f"dispatch wedged past {self.stall_factor:.1f}x "
                        f"the batch-time baseline ({baseline}) — the "
                        "hung-dispatch watchdog aborted it")
                    self._abort_inflight(batch, diag, "hung_dispatch", wd,
                                         cool=True)
                except Exception as e:  # noqa: BLE001 — engine must outlive
                    self._abort_inflight(
                        batch, ServingInfraError(f"dispatch failed: {e!r}"),
                        "infra", wd, cool=False)
        finally:
            if wd is not None:
                wd.stop()
            # _closed BEFORE the sweep: a racing submit either observes
            # _closed (and sheds its own request) or enqueued before this
            # sweep (which sheds it)
            with self._lock:
                self._closed = True
            self._drain_leftovers()

    def _begin_drain_locked(self, reason: str, started_at: float,
                            grace: Optional[float] = None) -> None:
        """Enter drain mode (callers hold ``self._lock``).  The deadline
        is published before the flag: the batcher reads both without the
        lock."""
        budget = grace if grace is not None else self.grace_period
        self._drain_deadline = started_at + budget
        self._draining = True
        incident.record("serving/drain", reason=reason, grace_s=budget,
                        queued=self._q.qsize())
        logger.info("serving engine draining (%s): grace %.1f s, %d "
                    "request(s) queued", reason, budget, self._q.qsize())

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
            shed += self._account(req, "shed", error=err, reason="drained")
        if shed:
            incident.record("serving/drain_shed", count=shed)
            logger.warning("serving drain shed %d queued request(s)", shed)
        telemetry.gauge("Serving/queue_depth").set(self._q.qsize())

    def _assemble(self, first: RequestHandle, batch: List[RequestHandle],
                  wd) -> None:
        """Coalesce up to ``maxBatch`` VALID requests into ``batch``: expired
        ones are shed, poison ones quarantined — neither takes a slot.  With
        ``lingerMs`` > 0 a partial batch waits that long for more."""
        req: Optional[RequestHandle] = first
        linger_until = (time.monotonic() + self.linger_ms / 1e3
                        if self.linger_ms > 0 else None)
        dequeued_ns: Dict[int, int] = {}
        while True:
            if req is not None:
                now = telemetry.clock_ns()
                request_trace.record_span(req.trace_id, "request/queue_wait",
                                          req.submit_ns, now)
                dequeued_ns[id(req)] = now
                if now > req.deadline_ns:
                    waited = (now - req.submit_ns) / 1e6
                    deadline = (req.deadline_ns - req.submit_ns) / 1e6
                    self._account(req, "shed",
                                  error=DeadlineExceeded(waited, deadline),
                                  reason="expired")
                else:
                    try:
                        row = self._decode(req)
                    except ServingDataError as e:
                        incident.record("serving/quarantine",
                                        index=req.index,
                                        error=type(e).__name__)
                        self._account(req, "quarantined", error=e)
                        # after the verdict, so the bundle's trace is
                        # terminal; the write is legitimate work, not a
                        # wedged dispatch, so the watchdog is paused
                        with (wd.paused() if wd is not None
                              else nullcontext()):
                            incident.maybe_dump("serving/quarantine",
                                                trace_id=req.trace_id)
                    else:
                        req.raw = row
                        batch.append(req)
            if len(batch) >= self.max_batch:
                break
            try:
                req = self._q.get_nowait()
                continue
            except queue.Empty:
                req = None
            if linger_until is None or not batch:
                break
            remaining = linger_until - time.monotonic()
            if remaining <= 0:
                break
            try:
                with (wd.paused() if wd is not None else nullcontext()):
                    req = self._q.get(timeout=remaining)
            except queue.Empty:
                break
        if request_trace.enabled() and batch:
            done = telemetry.clock_ns()
            for r in batch:
                request_trace.record_span(r.trace_id, "request/coalesce",
                                          dequeued_ns[id(r)], done,
                                          size=len(batch))
        telemetry.gauge("Serving/queue_depth").set(self._q.qsize())

    def _decode(self, req: RequestHandle) -> np.ndarray:
        """Per-request validation: anything wrong with the PAYLOAD raises
        :class:`ServingDataError` here, where it fails one request instead
        of a batch."""
        chaos.on_serving_request(req.index)
        if chaos.poison_request(req.index):
            raise ServingDataError(
                f"chaos: poison request at admission position {req.index}")
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
        if self._sentinel is not None:
            self._sentinel.check((inputs,))
            family = (inputs.shape[1:], inputs.dtype)
            if family not in self._families:
                self._families.add(family)
                for b in self._buckets:
                    self._sentinel.register_warmup(
                        (Spec((b,) + family[0], family[1]),))
        out = self._forward(to_device(inputs, self.device))
        return compile_cache.slice_rows(
            host_pull(out, what="serving outputs"), n)

    @property
    def sentinel(self):
        """The retrace sentinel over the serving forward (None when
        ``bigdl.analysis.retrace`` is off): a run proves zero post-warmup
        retraces with ``sentinel.retraces``."""
        return self._sentinel

    def _dispatch_batch(self, batch: List[RequestHandle], wd) -> None:
        t0 = telemetry.clock_ns()
        self.batches += 1
        chaos.on_dispatch(f"batch {self.batches}")
        out = self._run_forward(np.stack([r.raw for r in batch]))
        if request_trace.enabled():
            t1 = telemetry.clock_ns()
            padded = compile_cache.bucket_size(len(batch), self._buckets)
            for req in batch:
                request_trace.record_span(
                    req.trace_id, "request/dispatch", t0, t1,
                    batch=self.batches, rows=len(batch),
                    pad_to_bucket=padded)
        for i, req in enumerate(batch):
            self._account(req, "completed", result=out[i])
        ms = (telemetry.clock_ns() - t0) / 1e6
        self._ema.observe(ms)
        if wd is not None:
            wd.heartbeat()
        with self._lock:
            if self._cooldown > 0:
                self._cooldown -= 1
        self._occupancy.observe(len(batch))
        telemetry.counter("Serving/batches").inc()
        g = telemetry.gauge
        g("Serving/batch_ms").set(ms)
        for q in (50, 95, 99):
            g(f"Serving/p{q}_ms").set(self._latency.percentile(q))

    def _abort_inflight(self, batch: List[RequestHandle],
                        error: ServingError, reason: str, wd,
                        cool: bool) -> None:
        """A dispatch died under the batch: fail every unfinished in-flight
        request with the diagnosis, each with its own exception instance,
        and write the incident bundle of the first; after a hung dispatch,
        close admission until the engine proves itself again
        (``cooldownSteps`` clean batches, or the backlog clearing)."""
        failed = sum(
            self._account(r, "shed", error=type(error)(*error.args),
                          reason=reason)
            for r in batch)
        incident.record("serving/abort_inflight", reason=reason,
                        victims=failed, error=type(error).__name__)
        incident.maybe_dump(f"serving/{reason}",
                            trace_id=batch[0].trace_id if batch else None)
        if cool:
            with self._lock:
                self._cooldown = max(self._cooldown, self.cooldown_batches)
        logger.error("serving dispatch aborted (%s): %d in-flight "
                     "request(s) failed with %s%s", reason, failed, error,
                     f"; cooling down for {self.cooldown_batches} batches"
                     if cool else "")
        if wd is not None:
            # the stall is over from the monitor's view: the next dispatch
            # is judged on its own clock
            wd.heartbeat()
