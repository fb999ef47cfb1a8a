"""Training orchestration: the ``Optimizer`` base with its fluent setters and
factory, and the single-process ``LocalOptimizer``
(``bigdl_tpu/optim/optimizer.py``: ``_retry_backoff`` :58,
``mixed_precision_forward`` :102, ``all_finite`` :145, ``select_tree`` :165,
``regularization_penalty`` :174, ``Checkpoint`` :194, ``Optimizer`` :246,
``set_checkpoint`` :326, ``set_validation`` :341, ``optimize`` and
``_optimize_with_retry`` :393-560, ``_sync_dataset_epoch`` :667,
``_restore_latest_checkpoint`` :785, the training loop ``_drive`` :865,
``_validation_due``/``_run_validation`` :1469-1490,
``_checkpoint_due``/``_run_checkpoint`` :1492-1532, ``Optimizer.create``
:1569, ``LocalOptimizer`` :1613; reference ``optim/Optimizer.scala:42,268``,
``optim/LocalOptimizer.scala:41``, ``optim/DistriOptimizer.scala:394-416,
750-816``).  The data-parallel trainer is
:mod:`bigdl_tpu_torch.parallel.distri_optimizer`.

The JAX package fuses one training step into one jitted program.  Here the
step is eager PyTorch on the model's device: the forward (bf16 through
:func:`mixed_precision_forward` when asked), the loss plus the layers'
regularizer penalties, ``torch.autograd.grad`` back to the fp32 master
parameters (a model with ``Dropout`` draws its masks from a device
generator seeded with the step's counter, as the JAX package keys each step
with ``PRNGKey(neval - 1)``, :1246), the ``OptimMethod``'s
``pure_update``, and the divergence guard: a step whose loss or gradients
are not finite keeps every carry (parameters, optimizer slots and the
module state, BatchNorm's running statistics, which the forward updates in
place) at its pre-step value and reports its loss as NaN.  The training
loop keeps the reference's state keys (``epoch``, ``neval``, ``Loss``,
``recordsProcessedThisEpoch``, ``consecutiveBadSteps``), its epoch rollover
with a reshuffle at the record boundary, its end trigger, and raises
:class:`DivergenceError` after ``bigdl.divergence.maxBadSteps`` consecutive
bad steps.  It reads each step's loss on the host once.  Batches come
through :class:`~bigdl_tpu_torch.engine.BatchPrefetcher`, which fetches
``bigdl.prefetch.depth`` (default 2) batches ahead on a producer thread,
rolls the epoch over there and copies each batch to the device from pinned
memory on a stream of its own (``optimizer.py`` :1087-1135).

The training contract around the loop is the JAX package's.  After each
iteration (its counters advanced) the loop runs the validation, then the
checkpoint, where their triggers fire: :meth:`Optimizer.set_validation`
scores the model (``score``, the last metric's result, goes into the loop
state and the method's ``state``, where ``max_score`` and ``Plateau`` read
it); :meth:`Optimizer.set_checkpoint` writes snapshot ``neval - 1`` as a
verified unit (:mod:`bigdl_tpu_torch.utils.checkpoint_manager`).
:meth:`Optimizer.optimize` retries a failed run from the newest valid
snapshot (``bigdl.failure.retryTimes``, waits by :func:`_retry_backoff`,
the attempt count reset when a run gets further than any before;
``ValueError``, ``TypeError``, ``KeyboardInterrupt`` and a CUDA OOM
raised outside the step go straight to the caller).  A restore
loads the snapshot into the live model and method in place, the method's
``epoch`` and counters included, so a ``ShardedDataSet`` replays the
epoch's permutation (:meth:`Optimizer._sync_dataset_epoch`).

Telemetry (JAX ``_drive`` :903-1064, ``_summarize_train`` :1534): the loop
marks its phases with tracer spans (``driver/fetch``,
``driver/device_step``, ``driver/host_wait``, ``driver/summary``,
``driver/publish``, ``driver/validation``, ``driver/checkpoint``) on a lane
named ``driver``, and splits every step into the parts of
:class:`~bigdl_tpu_torch.telemetry.StepAccount`: ``data_wait`` is the wait
in the prefetcher's call, ``compute`` the eager step's call (the host's
time to enqueue the step on the device), ``host_pull`` the wait at the
loss's one host read (the device finishing the step), ``bookkeeping`` the
history, log line and MFU gauges, and ``unaccounted`` the signed rest.  A
step's wall time runs from the top of its iteration to its account; the
TrainSummary writes, validation and checkpoint after it lie between two
steps' walls, under their own spans.  The loss read stays the loop's only
host read: the telemetry reads no tensor.  ``Telemetry/*`` gauges,
``Telemetry/tflops`` and ``Telemetry/mfu`` (``bigdl.telemetry.mfu``, the
first step's FLOPs counted by :class:`~bigdl_tpu_torch.telemetry.
StepFlops`; ``bigdl.telemetry.peakTflops``), the slow-step detector
(``bigdl.telemetry.slowStepFactor``, with a profiler window and a timeline
dump under ``bigdl.telemetry.profileOnSlowStep``), the run-end account log
line and the ``telemetry.json`` / Chrome-trace exports
(``bigdl.telemetry.snapshotPath`` / ``tracePath``) are the JAX package's.
:meth:`Optimizer.set_train_summary` and :meth:`Optimizer.
set_validation_summary` write TensorBoard events (Loss, Throughput,
LearningRate, then every registry summary scalar; each validation
metric; "Parameters" histograms on their trigger), rank 0 alone.
:meth:`Optimizer.set_trace_profile` captures a ``torch.profiler`` window
in place of ``jax.profiler``.

The analysis passes (:mod:`bigdl_tpu_torch.analysis`, JAX :689,
:1105-1125, :1546-1555) ride every run.  The step is wrapped by the
recompile sentinel (``bigdl.analysis.retrace``, :meth:`Optimizer.
_arm_retrace`), and the fetch and the step with its loss read run inside
the host-sync guard (``bigdl.analysis.hostSync``; ``bigdl.analysis.
hotLoopScope`` "iteration" arms the fetch too, on the prefetcher's fetch
thread at depth > 0, "step" only the step): the loss read goes through
:func:`~bigdl_tpu_torch.analysis.host_pull`, the one intended pull of an
iteration, and any other host sync there raises (strict) or is counted
(warn).  TrainSummary gets ``Analysis/retraces`` and this run's
``Analysis/implicit_host_syncs``.  ``Optimizer.metrics``
(:class:`~bigdl_tpu_torch.optim.metrics.Metrics`) records "get batch
time", "computing time for each node", "batch fetch time" and "transfer
block time" in nanoseconds, at the JAX package's sites (:962, :1241,
:1344-1345).

The failure taxonomy of :meth:`Optimizer.optimize` (JAX
``_optimize_with_retry`` :436-560) sorts each failure and answers it:

- a device OOM (:class:`~bigdl_tpu_torch.resources.errors.
  DeviceMemoryError`, classified at the step from
  ``torch.cuda.OutOfMemoryError``, a cuBLAS allocation failure or the chaos
  injector's ``RESOURCE_EXHAUSTED``): a microbatch re-plan
  (:meth:`Optimizer._replan_microbatch`, ``resources/microbatch.py``), at
  no cost to the retry budget.  The failed step's traceback and every
  reference to its activations are dropped, ``gc.collect()`` and
  ``torch.cuda.empty_cache()`` run, then the newest snapshot is restored
  (if any) and the step re-runs as k accumulation chunks;
- preemption (:class:`~bigdl_tpu_torch.utils.elastic.Preempted`, raised
  by the loop's drain after a SIGTERM under ``bigdl.elastic.handleSignals``
  or ``bigdl.chaos.preemptAt``): the grace-period snapshot and the
  resumable marker are committed and ``Preempted`` re-raised, never
  retried;
- a hung step (:class:`~bigdl_tpu_torch.utils.elastic.HungStepError`,
  injected by the watchdog, ``bigdl.watchdog.stallFactor``), an integrity
  fault (:class:`~bigdl_tpu_torch.integrity.IntegrityError`) and any other
  failure: restore the newest valid snapshot and retry;
- a replica desync already healed in place by the data-parallel trainer
  (:class:`~bigdl_tpu_torch.integrity.ReplicaDesyncError` with ``healed``):
  retry without a restore;
- host memory exhausted (:class:`~bigdl_tpu_torch.resources.errors.
  HostMemoryError`), an argument error, an unported feature: fatal.

A failure that lands while a step writes its update into the live
parameters (an OOM or an injected ``HungStepError`` inside
:func:`select_tree`) leaves them torn: :meth:`Optimizer._params_dead` says
so, and the retry then restores a snapshot or raises; it never carries on
from a torn state.

Every iteration the loop (JAX :1198-1240) beats the hung-step watchdog's
heartbeat, polls the host-memory governor, runs the chaos harness's step
hooks (``utils/chaos.py``) and drains on a preemption request; validation,
checkpoints and the drain run with the watchdog paused.  A non-finite step
names its culprit, the first non-finite leaf (``first non-finite:
grad:<parameter>``).  ``bigdl.integrity.everyN`` > 0 carries the
fingerprint continuity of :mod:`bigdl_tpu_torch.integrity` through the
steps and checks the verdict every N iterations (JAX :1635-1700).  The
``Resources/*``, ``Integrity/*`` and ``Elastic/*`` gauges and counters and
the incident records are the JAX package's.

An optimization method that re-evaluates the loss inside a step
(``LBFGS``, ``requires_feval``) runs through
:meth:`LocalOptimizer._build_feval_step` (JAX :1755-1784): fp32 only, no
integrity pass, no sentinel and no guard (its line search reads the loss on
the host by design, JAX :1109-1112).  The data-parallel trainers refuse it
at their first step, as the JAX package's do (its ``pure_update`` raises).

Not ported yet: the compile cache and its warmup spans.  A
``bigdl.chaos.*`` key of a part the port lacks raises
:class:`NotImplementedError` (:func:`refuse_unported`).
"""

from __future__ import annotations

import gc
import logging
import math
import os
import random
import time
from contextlib import nullcontext
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.func import functional_call

from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, LocalDataSet,
                                             ShardedDataSet)
from bigdl_tpu_torch.dataset.transformer import (ChainedTransformer,
                                                 SampleToMiniBatch)
from bigdl_tpu_torch.engine import (BatchPrefetcher, DeviceLike,
                                    allgather_sum, check_on_device,
                                    default_device)
from bigdl_tpu_torch.nn.module import (Container, Criterion,
                                       collect_diagnostics, grad_scales,
                                       is_stochastic, random_stream,
                                       state_buffers)
from bigdl_tpu_torch.optim import trigger as triggers
from bigdl_tpu_torch.optim.optim_method import (SGD, OptimMethod,
                                                load_payload)
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation_method import ValidationMethod
from bigdl_tpu_torch import integrity, telemetry
from bigdl_tpu_torch.analysis.hostsync import (NULL_GUARD, STATS,
                                               HostSyncGuard, host_pull)
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.resources import microbatch
from bigdl_tpu_torch.resources import storage as resource_storage
from bigdl_tpu_torch.resources.device import classify_dispatch_error
from bigdl_tpu_torch.resources.errors import (DeviceMemoryError,
                                              HostMemoryError)
from bigdl_tpu_torch.resources.governor import GOVERNOR
from bigdl_tpu_torch.telemetry import incident
from bigdl_tpu_torch.utils import chaos, config, elastic

logger = logging.getLogger("bigdl_tpu_torch")

class DivergenceError(RuntimeError):
    """Raised by the training loop after ``bigdl.divergence.maxBadSteps``
    consecutive non-finite losses; the retry loop restores the newest
    valid snapshot."""


def _retry_backoff(attempt: int, base: float, cap: float,
                   rand: Optional[float] = None) -> float:
    """The wait before retry ``attempt``: ``min(base * 2**(attempt-1),
    cap)`` scaled by a jitter factor in [0.5, 1.0] (``rand`` pins it), so
    workers restarting off one failed store do not retry in lockstep.  A
    cap below the base wins; a cap <= 0 means no cap; a base <= 0 no
    wait."""
    if base <= 0:
        return 0.0
    r = rand if rand is not None else random.random()
    interval = base * (2.0 ** (max(attempt, 1) - 1))
    if cap > 0:
        interval = min(interval, cap)
    return interval * (0.5 + 0.5 * r)


def is_writer_process() -> bool:
    """Checkpoints are written once, by rank 0 (the reference's driver,
    ``DistriOptimizer.scala:394-416``); without a process group, by this
    process."""
    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_rank() == 0


def cast_floats(tree, dtype: torch.dtype):
    """Cast every floating tensor of a nested list/tuple/dict to ``dtype``;
    other leaves pass through."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def mixed_precision_forward(model: torch.nn.Module, inputs,
                            precision: Optional[str] = "bf16",
                            params: Optional[Dict[str, torch.Tensor]] = None):
    """Forward in the compute precision, outputs back in fp32.

    ``"bf16"``: the parameters and the floating inputs are cast down for
    the forward (the model's own fp32 parameters stay as they are) and the
    outputs come back as fp32; buffers keep their dtype, as the JAX package
    keeps module state in fp32.  BatchNorm widens its bf16-rounded affine
    parameters back to its fp32 statistics' dtype and normalises in fp32
    (:mod:`bigdl_tpu_torch.nn.normalization`).  The casts are
    differentiable, so under autograd the gradients come back to the fp32
    master parameters.  As in the JAX package, float token ids are cast
    too, so ids above 256 round to bf16's grid.  Any other precision is a
    plain forward.  ``params`` (by ``named_parameters()`` name) stand in
    for the model's own (the tensor-parallel trainer's blocks)."""
    if precision != "bf16":
        return model(inputs) if params is None else \
            functional_call(model, params, (inputs,))
    if params is None:
        params = dict(model.named_parameters())
    out = functional_call(model, cast_floats(params, torch.bfloat16),
                          (cast_floats(inputs, torch.bfloat16),))
    return cast_floats(out, torch.float32)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def all_finite(*trees):
    """Every floating tensor of every tree is finite: a 0-dim bool tensor on
    their device, computed there (no host read), or plain ``True`` for
    trees without floating tensors."""
    checks = [torch.isfinite(x).all() for tree in trees
              for x in _leaves(tree) if x.is_floating_point()]
    if not checks:
        return True
    return torch.stack(checks).all()


def select_tree(ok, new_tree, old_tree):
    """Per-tensor ``where(ok, new, old)``, written into ``old_tree``'s
    tensors, which keep their identity (the model's parameters, the
    optimizer's slots); returns ``old_tree``.  ``ok`` is a 0-dim bool tensor
    or a Python bool; ``True`` copies ``new`` over ``old``."""
    for new, old in zip(_leaves(new_tree), _leaves(old_tree), strict=True):
        if ok is True:
            old.copy_(new)
        else:
            torch.where(ok, new, old, out=old)
    return old_tree


def module_state(model: torch.nn.Module) -> List[torch.Tensor]:
    """The model's floating state tensors (:func:`state_buffers` of each
    module), which a training-mode forward updates in place."""
    return [b for m in model.modules() for b in state_buffers(m).values()
            if b.is_floating_point()]


def regularization_penalty(module: torch.nn.Module) -> Optional[torch.Tensor]:
    """The sum of the layers' regularizer penalties over the module tree
    (reference: each layer's ``accGradParameters``,
    ``optim/Regularizer.scala``); joining the loss, autograd gives the same
    gradient.  ``w_regularizer`` sees every parameter of a layer but its
    bias, ``b_regularizer`` the bias.  None when no layer has one."""
    terms = []
    if isinstance(module, Container):
        terms = [regularization_penalty(c) for c in module.layers]
    else:
        own = dict(module.named_parameters(recurse=False))
        wreg = getattr(module, "w_regularizer", None)
        breg = getattr(module, "b_regularizer", None)
        if wreg is not None:
            terms.append(wreg.penalty([own[k] for k in sorted(own)
                                       if k != "bias"]))
        if breg is not None and own.get("bias") is not None:
            terms.append(breg.penalty([own["bias"]]))
    terms = [t for t in terms if t is not None]
    return sum(terms[1:], terms[0]) if terms else None


def moe_aux_penalty(model: torch.nn.Module,
                    weight: float) -> Optional[torch.Tensor]:
    """MoE's load-balancing term: ``weight`` times the sum of every
    declared ``aux_loss`` diagnostic of the last forward, in fp32 (the
    JAX package's ``moe_aux_penalty``, ``optim/optimizer.py:132``).
    Without it the router feels no pressure to balance.  None when the
    model has no MoE layer or the weight is 0."""
    aux = collect_diagnostics(model, "aux_loss")
    if not aux or weight == 0.0:
        return None
    total = aux[0].float()
    for a in aux[1:]:
        total = total + a.float()
    return weight * total


def _yields_minibatches(ds: AbstractDataSet) -> bool:
    def has_batcher(t) -> bool:
        if isinstance(t, SampleToMiniBatch):
            return True
        if isinstance(t, ChainedTransformer):
            return any(has_batcher(s) for s in t.stages)
        return False
    if isinstance(ds, ShardedDataSet):   # every shard has the same chain
        ds = next(iter(ds.shards.values()))
    return any(has_batcher(t) for t in getattr(ds, "transformers", ()))


def close_iterators(prefetcher: Optional[BatchPrefetcher], iterators
                    ) -> None:
    """Close the data iterators of a finished run (a ``StreamingIngest``
    run joins its stage threads as it closes), unless a producer thread
    that may be inside one is still alive."""
    if prefetcher is not None and prefetcher.producer_alive():
        return
    for it in iterators:
        close = getattr(it, "close", None)
        if close is not None:
            close()


def refuse_unported() -> None:
    """Raise :class:`NotImplementedError` where a config key asks a
    trainer for a feature the port does not have yet: a fault injector of
    a part not ported (``utils/chaos.py`` ``UNPORTED_KEYS``)."""
    chaos.refuse_unported_keys()


def refuse_keys(keys, what: str) -> None:
    """Raise :class:`NotImplementedError` when any of ``keys`` is set (a
    trainer without ``what``)."""
    asked = [k for k in keys
             if config.get_property(k) not in (None, "", 0, False, "0")]
    if asked:
        raise NotImplementedError(f"{', '.join(asked)}: {what}")


class Checkpoint:
    """The ``model.N`` / ``optimMethod.N`` snapshot protocol (reference
    ``optim/DistriOptimizer.scala:394-416``) over a
    :class:`~bigdl_tpu_torch.utils.checkpoint_manager.CheckpointManager`:
    verified, committed units; ``keep_last`` retention; ``async_write`` on
    a writer thread.  Local paths only."""

    def __init__(self, path: str, trigger: Trigger, isOverwrite: bool = True,
                 keep_last: Optional[int] = None,
                 async_write: Optional[bool] = None):
        from bigdl_tpu_torch.utils.checkpoint_manager import \
            CheckpointManager
        self.path = path
        self.trigger = trigger
        self.overwrite = isOverwrite
        self.manager = CheckpointManager(path, keep_last=keep_last,
                                         async_write=async_write,
                                         overwrite=isOverwrite)

    def save(self, model: torch.nn.Module, optim: OptimMethod, neval: int,
             topology=None) -> None:
        self.manager.save(model, optim, neval, topology=topology)

    def latest(self) -> Optional[Tuple[str, str, int]]:
        """The newest snapshot that is a committed, shallow-verified
        pair."""
        return self.manager.latest_valid()

    def join(self, raise_errors: bool = True) -> None:
        """Wait for the writer; its deferred error re-raises here."""
        self.manager.join(raise_errors=raise_errors)


class _ProfileWindow:
    """The ``torch.profiler`` window of :meth:`Optimizer.set_trace_profile`
    (the JAX package's ``jax.profiler.start_trace``/``stop_trace``,
    :1151-1195), or the one-step window the slow-step detector asks for.
    The window's steps end with their loss read, so their device work has
    finished when it closes; torch.profiler synchronizes the device once
    as it stops.

    On the card the window's own steps are its control: they launch
    kernels, so a window whose trace holds no CUDA kernel at all is blind
    (``blind``; logged and counted in ``Telemetry/profile_blind_windows``),
    as torch.profiler windows were seen to be now and then after heavy
    CUDA work in the same process."""

    def __init__(self, opt: "Optimizer"):
        self.opt = opt
        self.prof = None
        self.blind = False
        self.end = 0
        self.path: Optional[str] = None
        self.slow_dir: Optional[str] = None
        self.slow_taken = False

    @staticmethod
    def _process_dir(pdir: str) -> str:
        if dist.is_available() and dist.is_initialized() and \
                dist.get_world_size() > 1:
            return os.path.join(pdir, f"process_{dist.get_rank()}")
        return pdir

    def _start(self, pdir: str, neval: int, n: int) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.opt.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.path = os.path.join(self._process_dir(pdir),
                                 "torch_profile.json")
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.end = neval + n

    def maybe_start(self, neval: int) -> None:
        opt = self.opt
        if self.prof is not None:
            return
        # >= not ==: a run resumed past the start still captures once
        if opt._profile_dir and neval >= opt._profile_start:
            self._start(opt._profile_dir, neval, opt._profile_n)
            # the request is consumed: a second optimize() needs another
            # set_trace_profile
            opt._profile_dir = None
        elif self.slow_dir and not self.slow_taken and not opt._profile_dir:
            self.slow_taken = True
            self._start(self.slow_dir, neval, 1)

    def request_slow(self, pdir: str) -> None:
        if self.slow_dir is None:
            self.slow_dir = pdir

    def maybe_stop(self, neval: int) -> None:
        if self.prof is not None and neval >= self.end:
            self.stop()

    def stop(self) -> None:
        prof, self.prof = self.prof, None
        if prof is None:
            return
        prof.__exit__(None, None, None)
        if self.opt.device.type == "cuda" and not any(
                e.device_type().name == "CUDA"
                for e in prof.profiler.kineto_results.events()):
            self.blind = True
            telemetry.counter(
                "Telemetry/profile_blind_windows",
                help="profiler windows that recorded no CUDA kernel").inc()
            logger.warning("The profiler window recorded no CUDA kernel of "
                           "its steps: the trace at %s holds the host's "
                           "side only", self.path)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        prof.export_chrome_trace(self.path)
        logger.info("Profiler trace written to %s", self.path)


def _initial_loop_state() -> Dict[str, Any]:
    """The training loop's state keys, the reference's (``optimizer.py``
    :1608, ``DistriOptimizer.scala``)."""
    return {"epoch": 1, "neval": 1, "Loss": None, "score": None,
            "recordsProcessedThisEpoch": 0, "consecutiveBadSteps": 0}


class Optimizer:
    """Trainer base (reference ``optim/Optimizer.scala:42``).  The factory
    :meth:`create` picks the trainer by dataset type.

    ``device`` (default ``"cuda"``, raising without CUDA) is where the model
    lies and the steps run.  ``history`` gets one record per iteration:
    ``neval``, ``epoch``, ``loss`` (NaN for a skipped step), ``records``,
    the iteration's wall ``seconds`` (taking the batch to the host read of
    the loss), ``wait_seconds``, the part of them the loop waited for the
    batch, and ``fetch_seconds``, the time the batch's fetch and copy to
    the device took (on the prefetcher's producer thread, apart from the
    loop, at ``bigdl.prefetch.depth`` > 0; the same as the wait at 0).
    ``prefetcher`` is the last run's
    :class:`~bigdl_tpu_torch.engine.BatchPrefetcher`, with its counters."""

    def __init__(self, model: torch.nn.Module, dataset: AbstractDataSet,
                 criterion: Criterion, device: DeviceLike = "cuda"):
        self.device = default_device(device)
        check_on_device(model, self.device)
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.optim_method: OptimMethod = SGD()
        self.end_when: Trigger = triggers.max_iteration(100)
        self.precision: Optional[str] = None   # None = fp32; "bf16" = mixed
        #: weight of MoE's balance term in the loss (the Switch paper's
        #: alpha; :meth:`set_moe_aux_weight`)
        self.moe_aux_weight: float = 0.01
        self.history: List[Dict[str, Any]] = []
        self.prefetcher: Optional[BatchPrefetcher] = None
        self.checkpoint: Optional[Checkpoint] = None
        self.validation_trigger: Optional[Trigger] = None
        self.validation_dataset: Optional[AbstractDataSet] = None
        self.validation_methods: Optional[List[ValidationMethod]] = None
        #: one record per validation: ``neval`` (the iterations done),
        #: ``epoch``, each metric's result by name, the ``records`` scored
        #: and the pass's wall ``seconds``
        self.validation_history: List[Dict[str, Any]] = []
        #: seconds of the last restore from a snapshot
        self.last_restore_seconds: Optional[float] = None
        self.train_summary = None
        self.validation_summary = None
        #: the torch.profiler window of set_trace_profile (None: none)
        self._profile_dir: Optional[str] = None
        self._profile_start = 10
        self._profile_n = 3
        #: one step's FLOPs (bigdl.telemetry.mfu), counted at a run's first
        #: step
        self._step_flops: Optional[float] = None
        #: the last run's step-time account
        self._step_account: Optional[telemetry.StepAccount] = None
        #: the OOM re-plan: accumulation chunks a step (1 = full batch) and
        #: the global batch the plan splits (set by a trainer that can)
        self._microbatch_k = 1
        self._plan_batch_size = 0
        #: a step is writing its update into the live tensors
        self._torn = False
        #: CUDA bytes allocated at the entry of the step that hit a device
        #: OOM, and after the re-plan released its memory (None: no re-plan)
        self.oom_replan_memory: Optional[Tuple[int, int]] = None
        self._step_entry_bytes = 0
        #: named phase counters (JAX ``optimizer.py`` :268)
        self.metrics = Metrics()
        #: the last run's recompile sentinel (None: the pass is off)
        self._retrace_sentinel = None
        #: the last run's step, as wrapped by the sentinel
        self._step_fn = None
        #: the host-sync counter at the run's start (None: the guard is off)
        self._hostsync_base: Optional[int] = None

    # -- fluent setters (reference Optimizer.scala fluent API) ------------

    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        return self

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
        return self

    def set_checkpoint(self, path: str, trigger: Trigger,
                       isOverwrite: bool = True,
                       keep_last: Optional[int] = None,
                       async_write: Optional[bool] = None) -> "Optimizer":
        """Snapshots into the local directory ``path`` whenever ``trigger``
        fires.  ``keep_last``: keep the N newest committed ones (default
        ``bigdl.checkpoint.keepLast``; 0 keeps all).  ``async_write``:
        write on a background thread; its errors re-raise at the next save
        and at the end of :meth:`optimize` (default
        ``bigdl.checkpoint.asyncWrite``)."""
        self.checkpoint = Checkpoint(path, trigger, isOverwrite,
                                     keep_last=keep_last,
                                     async_write=async_write)
        return self

    def set_validation(self, trigger: Trigger, dataset,
                       methods: List[ValidationMethod],
                       batch_size: Optional[int] = None) -> "Optimizer":
        """Score the model on ``dataset`` (Samples or MiniBatches; a list
        becomes a ``LocalDataSet``) with ``methods`` whenever ``trigger``
        fires; ``batch_size`` adds a ``SampleToMiniBatch`` where the
        dataset has none."""
        self.validation_trigger = trigger
        if isinstance(dataset, (list, tuple)):
            dataset = LocalDataSet(dataset)
        if batch_size is not None and not _yields_minibatches(dataset):
            dataset = dataset.transform(SampleToMiniBatch(batch_size))
        self.validation_dataset = dataset
        self.validation_methods = methods
        return self

    def set_train_summary(self, summary) -> "Optimizer":
        """A :class:`~bigdl_tpu_torch.visualization.TrainSummary`: Loss,
        Throughput and LearningRate each iteration, then every registry
        summary scalar (``Telemetry/*``, ``Ingest/*``, ...); its
        "Parameters" trigger writes weight histograms."""
        self.train_summary = summary
        return self

    def set_validation_summary(self, summary) -> "Optimizer":
        """A :class:`~bigdl_tpu_torch.visualization.ValidationSummary`: one
        scalar per validation metric at each validation."""
        self.validation_summary = summary
        return self

    def set_trace_profile(self, log_dir: str, start_iteration: int = 10,
                          n_iterations: int = 3) -> "Optimizer":
        """Capture a ``torch.profiler`` trace (host and, on a card, CUDA
        activity) of ``n_iterations`` iterations from ``start_iteration``
        into ``log_dir`` as a Chrome trace (``torch_profile.json``; a rank
        of a process group writes into ``process_<rank>``).  The window
        fires once; a second ``optimize()`` needs another call."""
        if n_iterations < 1:
            raise ValueError(f"n_iterations must be >= 1, got {n_iterations}")
        if start_iteration < 1:
            raise ValueError(
                f"start_iteration must be >= 1 (iteration counting is "
                f"1-based), got {start_iteration}")
        self._profile_dir = log_dir
        self._profile_start = start_iteration
        self._profile_n = n_iterations
        return self

    def set_precision(self, precision: Optional[str]) -> "Optimizer":
        """``"bf16"`` runs the forward and backward in bfloat16 while the
        master weights, the loss and the update stay float32."""
        if precision not in (None, "bf16"):
            raise ValueError(f"unsupported precision {precision!r}")
        self.precision = precision
        return self

    def _feval(self) -> bool:
        """The method re-evaluates the loss inside a step (LBFGS)."""
        return getattr(self.optim_method, "requires_feval", False)

    def _arm_retrace(self, step_fn, label: str):
        """Wrap a step with the recompile sentinel (``bigdl.analysis.
        retrace``, JAX :689): post-warmup signature drift raises (strict) or
        logs a per-leaf shape/dtype diff (warn), charted as
        ``Analysis/retraces``.  A fresh sentinel each run.  Host-driven
        feval methods (LBFGS) pass through unwrapped."""
        self._retrace_sentinel = None
        if self._feval():
            self._step_fn = step_fn
            return step_fn
        from bigdl_tpu_torch.analysis.retrace import RetraceSentinel
        sentinel = RetraceSentinel.from_config(
            f"{type(self).__name__}[{label}]")
        if sentinel is not None:
            self._retrace_sentinel = sentinel
            step_fn = sentinel.wrap(step_fn)
        self._step_fn = step_fn
        return step_fn

    def set_moe_aux_weight(self, weight: float) -> "Optimizer":
        """The weight of the MoE load-balancing term folded into the loss
        (:func:`moe_aux_penalty`); 0 takes the pressure off (the
        diagnostic stays in the layer's ``aux_loss``)."""
        self.moe_aux_weight = float(weight)
        return self

    def _loss(self, out, targets, penalty=False) -> torch.Tensor:
        """The step's objective: the criterion, the layers' regularizer
        penalties and MoE's balance term, in the JAX step's order.
        ``penalty``, where given, stands in for the model's own
        :func:`regularization_penalty` (a sharded step's)."""
        loss = self.criterion.apply(out, targets)
        if penalty is False:
            penalty = regularization_penalty(self.model)
        for term in (penalty,
                     moe_aux_penalty(self.model, self.moe_aux_weight)):
            if term is not None:
                loss = loss + term
        return loss

    def optimize(self) -> torch.nn.Module:
        """Train until the end trigger fires, answering each failure by its
        class (the module docstring's taxonomy; reference
        ``DistriOptimizer.scala:750-816``); returns the model, whose
        parameters hold the trained weights.

        Up to ``bigdl.failure.retryTimes`` attempts, waiting
        :func:`_retry_backoff` (``bigdl.failure.retryTimeInterval``,
        ``bigdl.failure.maxRetryInterval``) between them.  The attempt
        count resets when a run gets past the furthest ``evalCounter`` any
        attempt reached (a fresh fault), never after a divergence or an
        integrity fault.  A preemption flag or marker left by an earlier
        run is cleared first; ``bigdl.elastic.handleSignals`` routes
        SIGTERM/SIGINT into the drain for the run's length (main thread
        only; the previous handlers are put back).  The asynchronous
        writer is drained before this returns or raises.  The
        ``Parallel/*`` gauges of an earlier run are dropped first (a
        ``DistriOptimizer`` sets them again)."""
        telemetry.REGISTRY.drop_prefix("Parallel/")
        retry_times = config.get_int("bigdl.failure.retryTimes", 5)
        base = config.get_float("bigdl.failure.retryTimeInterval", 120.0)
        cap = config.get_float("bigdl.failure.maxRetryInterval", 900.0)
        elastic.clear_preemption()
        if self.checkpoint is not None and is_writer_process():
            elastic.clear_preemption_marker(self.checkpoint.path)
        try:
            with elastic.PreemptionHandler():
                return self._optimize_with_retry(retry_times, base, cap)
        except BaseException:
            if self.checkpoint is not None:
                self.checkpoint.join(raise_errors=False)
            raise

    def _optimize_with_retry(self, retry_times: int, base: float,
                             cap: float) -> torch.nn.Module:
        attempt = 0
        high_water = None   # the furthest evalCounter of any attempt
        while True:
            replanned = None
            try:
                result = self._optimize()
            except (ValueError, TypeError, KeyboardInterrupt,
                    NotImplementedError, HostMemoryError,
                    torch.cuda.OutOfMemoryError):
                # an argument error, an unported feature, host memory
                # exhausted at depth 1 (no ring shrinks below one item), or
                # a device OOM outside the step: no retry
                raise
            except DeviceMemoryError as e:
                # a resource fault, not divergence: the same step would fail
                # forever, so the answer is a re-plan, at no cost to the
                # retry budget; next_k bounds the loop
                if not self._replan_microbatch(e):
                    raise
                # keep the error without its traceback, whose frames hold
                # the failed step's activations
                replanned = (time.monotonic(), e.with_traceback(None))
            except elastic.Preempted:
                # the loop drained and published before raising: commit the
                # grace snapshot and leave (an eviction, not a fault)
                incident.record("optim/preempted",
                                reason=elastic.preemption_reason())
                self._commit_preemption_snapshot()
                incident.maybe_dump("preemption", reason="preemption")
                raise
            except Exception as e:
                cur = self.optim_method.state.get("evalCounter", 0)
                if (not isinstance(e, (DivergenceError,
                                       integrity.IntegrityError))
                        and high_water is not None and cur > high_water):
                    attempt = 0    # new ground: a fresh fault
                high_water = cur if high_water is None else max(high_water,
                                                                cur)
                attempt += 1
                if attempt >= retry_times:
                    incident.record("optim/retries_exhausted",
                                    attempt=attempt, error=type(e).__name__)
                    incident.maybe_dump("optim/retries_exhausted",
                                        reason=type(e).__name__)
                    raise
                if (isinstance(e, integrity.ReplicaDesyncError)
                        and getattr(e, "healed", False)):
                    # the trainer already broadcast the majority's state and
                    # rewound the counter: a restore would throw away the
                    # surviving replicas' newer, valid ground
                    incident.record("optim/desync_heal", attempt=attempt,
                                    error=type(e).__name__)
                    interval = _retry_backoff(attempt, base, cap)
                    logger.warning(
                        "Replica desync healed in place (attempt %d/%d); "
                        "re-entering training in %.1fs: %s", attempt,
                        retry_times, interval, e)
                    time.sleep(interval)
                    continue
                heal_t0 = time.monotonic()
                restored = self._restore_latest_checkpoint()
                if restored and isinstance(e, integrity.IntegrityError):
                    telemetry.gauge(
                        "Integrity/heal_ms",
                        help="detection-to-heal latency of the last "
                             "integrity fault (restore or re-broadcast)"
                    ).set((time.monotonic() - heal_t0) * 1000.0)
                if not restored and self._params_dead():
                    # the update was cut off halfway: with nothing to
                    # reload, the live state is torn
                    raise
                incident.record("optim/retry_restore", attempt=attempt,
                                error=type(e).__name__, restored=restored)
                interval = _retry_backoff(attempt, base, cap)
                logger.exception(
                    "Training failed (attempt %d/%d); %s and retrying in "
                    "%.1fs", attempt, retry_times,
                    "restored the latest valid checkpoint" if restored
                    else "resuming from the live state", interval)
                time.sleep(interval)
                continue
            if replanned is not None:
                heal_t0, err = replanned
                self._release_device_memory()
                restored = self._restore_latest_checkpoint()
                if not restored and self._params_dead():
                    raise err
                if self.device.type == "cuda":
                    self.oom_replan_memory = (
                        self._step_entry_bytes,
                        torch.cuda.memory_allocated(self.device))
                heal_ms = (time.monotonic() - heal_t0) * 1000.0
                telemetry.gauge(
                    "Resources/oom_replan_ms",
                    help="device-OOM detection to re-planned-step readiness "
                         "(re-plan, memory release and restore)").set(heal_ms)
                incident.record("optim/oom_replan", restored=restored,
                                heal_ms=round(heal_ms, 2))
                continue
            if self.checkpoint is not None:
                self.checkpoint.join()
            return result

    def _release_device_memory(self) -> None:
        """Give back what a failed step held: its frames are gone with its
        traceback, so a collection frees any cycle left, and the caching
        allocator returns its blocks to the card."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _replan_microbatch(self, e: DeviceMemoryError) -> bool:
        """Answer a device OOM with the next microbatch plan: the global
        batch of B samples re-runs as k equal accumulation chunks
        (``resources/microbatch.py``: Kahan-compensated mean gradient, one
        update).  False when no further split exists (already per-sample)
        or the trainer has no plan (no batch observed; a trainer without
        the accumulation step)."""
        bsz = int(self._plan_batch_size or 0)
        if bsz <= 0:
            return False
        k = microbatch.next_k(bsz, self._microbatch_k)
        if k is None:
            return False
        prev = self._microbatch_k
        self._microbatch_k = k
        telemetry.counter(
            "Resources/microbatch_replans",
            help="device-OOM-driven microbatch re-plans this process").inc()
        telemetry.gauge(
            "Resources/microbatch_k",
            help="gradient-accumulation chunks per step after OOM "
                 "re-planning (1 = full batch)").set(k)
        logger.warning(
            "Device memory exhausted (%s; %s) - re-planning the step: "
            "global batch %d now runs as %d accumulation chunk(s) of %d "
            "samples (was k=%d)", e, getattr(e, "detail", ""), bsz, k,
            bsz // k, prev)
        return True

    def _commit_preemption_snapshot(self) -> None:
        """The grace-period exit: the loop published the newest state
        before raising ``Preempted``; commit it as a final verified
        snapshot, drain the writer, then write the resumable marker.  A
        snapshot that fails to commit gets no marker (resume falls back to
        the newest earlier snapshot), and the failure does not replace the
        ``Preempted`` unwinding.  Only the writer process touches the
        store, and no barrier is added: peers may already be gone."""
        if self.checkpoint is None:
            logger.warning(
                "Preempted with no checkpoint configured - the state of "
                "this run is lost (set_checkpoint enables the grace-period "
                "snapshot)")
            return
        opened = elastic.preemption_requested_at()
        deadline = ((opened if opened is not None else time.monotonic())
                    + elastic.grace_period())
        neval = self.optim_method.state.get("evalCounter", 0)
        committed = True
        if is_writer_process():
            with elastic.timed("preempt_snapshot"):
                try:
                    self.checkpoint.save(self.model, self.optim_method,
                                         neval,
                                         topology=self._topology_meta())
                    self.checkpoint.join()
                except Exception:
                    committed = False
                    logger.exception(
                        "Grace-period snapshot %d failed to commit - NOT "
                        "writing the preemption marker; resume will fall "
                        "back to the newest earlier valid snapshot", neval)
            if committed:
                elastic.write_preemption_marker(self.checkpoint.path, neval)
        overshoot = time.monotonic() - deadline
        status = ("snapshot %d is committed" % neval if committed else
                  "snapshot %d FAILED to commit" % neval)
        if overshoot > 0:
            logger.warning(
                "Preemption drain exceeded bigdl.elastic.gracePeriod by "
                "%.1fs - the scheduler may have killed peers already; %s",
                overshoot, status)
        else:
            logger.info("Preemption drain complete: %s with %.1fs of the "
                        "grace period to spare", status, -overshoot)

    def _params_dead(self) -> bool:
        """True when a step was cut off while writing its update into the
        live parameters and slots (the JAX package's donated-and-deleted
        buffers): the live state is torn."""
        return self._torn

    def _optimize(self) -> torch.nn.Module:
        raise NotImplementedError

    def _group(self):
        """The process group validation and checkpoints synchronise over
        (None: this process alone)."""
        return None

    def _group_size(self) -> int:
        return 1

    def _validation_group(self):
        """The group whose ranks score the validation set's partitions
        between them (the ``data`` axis of a mesh)."""
        return self._group()

    def _any_rank(self, flag: bool) -> bool:
        """``flag`` on any rank of :meth:`_group`; a barrier when there
        are several."""
        if self._group_size() == 1:
            return flag
        return bool(allgather_sum([1.0 if flag else 0.0], self._group())[0])

    def _topology_meta(self) -> Dict[str, Any]:
        """The topology recorded in a snapshot's manifest."""
        return elastic.describe_topology(step="local")

    def _restore_latest_checkpoint(self) -> bool:
        """Load the newest valid snapshot into the live model and method,
        in place (reference ``DistriOptimizer.scala:766-788``): the
        model's ``state_dict`` and the method's ``state`` and slots.
        Torn, uncommitted or corrupt snapshots are skipped, a payload that
        fails to load falls back to the next-older one.  False when there
        is nothing to restore."""
        if self.checkpoint is None:
            return False
        # an in-flight write is either committed or absent before the scan
        self.checkpoint.join(raise_errors=False)
        self._any_rank(False)    # every rank scans after the writer ends
        t0 = time.perf_counter()
        with elastic.timed("restore") as timer:
            loaded = self.checkpoint.manager.load_latest(
                expected_topology=self._topology_meta())
            if loaded is None:
                timer.cancel()   # an empty scan is not a restore
                return False
            model_payload, optim_payload, n = loaded
            self.model.load_state_dict(model_payload)
            load_payload(self.optim_method, optim_payload,
                         device=self.device, hyper=False)
        self._torn = False
        self.last_restore_seconds = time.perf_counter() - t0
        logger.info("Restored snapshot model.%d / optimMethod.%d (%s) in "
                    "%.3f s", n, n, self.checkpoint.manager.last_restore_mode,
                    self.last_restore_seconds)
        return True

    def _validation_due(self, state) -> bool:
        return (self.validation_trigger is not None and
                self.validation_dataset is not None and
                self.validation_trigger(state))

    def _run_validation(self, state) -> None:
        from bigdl_tpu_torch.optim.evaluator import evaluate_dataset
        t0 = time.perf_counter()
        results = evaluate_dataset(self.model, self.validation_dataset,
                                   self.validation_methods, self.device,
                                   group=self._validation_group())
        record = {"neval": state["neval"] - 1, "epoch": state["epoch"],
                  "records": results[0][1].count if results else 0,
                  "seconds": time.perf_counter() - t0}
        for method, res in results:
            logger.info("%s is %s", method.name, res)
            state["score"] = res.final_result()
            self.optim_method.state["score"] = res.final_result()
            record[method.name] = res.final_result()
            if self.validation_summary is not None and is_writer_process():
                self.validation_summary.add_scalar(
                    method.name, res.final_result(), state["neval"] - 1)
        self.validation_history.append(record)

    def _checkpoint_due(self, state) -> bool:
        return self.checkpoint is not None and self.checkpoint.trigger(state)

    def _run_checkpoint(self, state) -> None:
        """Rank 0 writes snapshot ``neval - 1``; a write error is shared
        with every rank (:meth:`_any_rank`), so all raise the same
        retryable ``RuntimeError`` and enter the restore together."""
        err: Optional[BaseException] = None
        if is_writer_process():
            try:
                self.checkpoint.save(self.model, self.optim_method,
                                     state["neval"] - 1,
                                     topology=self._topology_meta())
            except BaseException as e:  # noqa: BLE001 - re-raised below
                err = e
        if self._any_rank(err is not None) and self._group_size() > 1:
            raise RuntimeError(
                "checkpoint write failed on the writer process (rank 0): "
                "restoring the latest valid snapshot on every rank") from err
        if err is not None:
            raise err

    def _sync_dataset_epoch(self) -> None:
        """Set a ``ShardedDataSet``'s shuffle round to ``epoch - 1``, so
        that the first reshuffle of a run that continues at epoch E draws
        epoch E's permutation (shuffles are pure in ``(seed, round)``); a
        ``LocalDataSet`` has no rounds."""
        sync = getattr(self.dataset, "set_shuffle_round", None)
        if sync is not None:
            sync(self.optim_method.state.get("epoch", 1) - 1)

    def _drive(self, fetch_batch, run_step, reset_epoch,
               epoch_size: int, publish=None,
               integrity=None) -> Dict[str, Any]:
        """The training loop (reference ``optim/DistriOptimizer.scala:141-344``,
        ``LocalOptimizer.scala:78``): fetch, step, bookkeeping and logging,
        epoch rollover, then the validation and the checkpoint where their
        triggers fire (``publish()`` first, which hands the trainer's live
        slots to the method; None when they are the method's own).
        ``fetch_batch() -> (inputs, targets, batch_size)``
        with host (numpy) arrays; ``run_step(inputs, targets, hyper, seed)
        -> loss`` (a 0-dim tensor; ``seed`` is the step's random-stream
        counter, ``neval - 1``, the JAX package's ``rng_counter``) or
        ``-> (loss, aux)`` with the step's device-side diagnostics;
        ``reset_epoch()`` reshuffles and restarts the data iterator.
        ``integrity`` is the trainer's :class:`~bigdl_tpu_torch.integrity.
        DriverIntegrity`: it names the first non-finite leaf of a bad step
        and checks the fingerprint verdicts at its cadence.

        The hung-step watchdog (``bigdl.watchdog.stallFactor``) starts
        here, on this thread, and stops first in the ``finally``, before
        the profiler and the prefetcher.

        A :class:`~bigdl_tpu_torch.engine.BatchPrefetcher` calls
        ``fetch_batch`` and moves the batch to the device; the rollover
        runs on its producer, at the record boundary as the batch that
        crosses it is fetched (the reference's batch producer), so the
        batch sequence is the same at every ``bigdl.prefetch.depth``.

        Telemetry (JAX :903-928): the tracer is armed by
        ``bigdl.telemetry.trace``, this thread's lane is named ``driver``
        and its spans reset, the ``Telemetry/*`` gauges of an earlier run
        are dropped, and a fresh :class:`~bigdl_tpu_torch.telemetry.
        StepAccount` takes the run's steps."""
        state = _initial_loop_state()
        # a second optimize() continues the counters the OptimMethod carries
        state["neval"] = self.optim_method.state.get("evalCounter", 0) + 1
        state["epoch"] = self.optim_method.state.get("epoch", 1)
        max_bad_steps = config.get_int("bigdl.divergence.maxBadSteps", 5)
        telemetry.maybe_arm_from_config()
        if telemetry.tracing_enabled():
            telemetry.name_thread("driver")
            telemetry.reset_tracer()
        telemetry.REGISTRY.drop_prefix("Telemetry/")
        telemetry.REGISTRY.drop_prefix("Analysis/")
        account = telemetry.StepAccount(
            window=config.get_int("bigdl.telemetry.percentileWindow", 512),
            detector=telemetry.SlowStepDetector(
                config.get_float("bigdl.telemetry.slowStepFactor", 0.0),
                warmup=config.get_int("bigdl.telemetry.slowStepWarmup", 5),
                cooldown=config.get_int("bigdl.telemetry.slowStepCooldown",
                                        50)))
        self._step_account = account
        fetched = {"records": 0}

        def on_batch(batch):
            fetched["records"] += batch[2]
            if fetched["records"] >= epoch_size:
                fetched["records"] = 0
                reset_epoch()

        # the host-sync guard (JAX :1105-1134): implicit syncs inside the
        # fetch -> step -> loss-read region fail with their call site
        # (strict) or are counted (warn); the host-driven feval path (LBFGS
        # line search) pulls by design and is exempt.  hotLoopScope
        # "iteration" arms the fetch too, "step" only the step.
        hot_guard = (NULL_GUARD if self._feval() else
                     HostSyncGuard.from_config(device=self.device))
        scope = str(config.get_property("bigdl.analysis.hotLoopScope",
                                        "iteration"))
        fetch_guard = hot_guard if scope == "iteration" else NULL_GUARD
        # a per-run baseline: the process-wide counter survives runs, and
        # TrainSummary charts THIS run's syncs
        self._hostsync_base = (STATS.snapshot()["implicit"]
                               if hot_guard.enabled else None)
        fetch = BatchPrefetcher(
            fetch_batch, on_batch=on_batch, device=self.device,
            guard=fetch_guard if fetch_guard.enabled else None)
        self.prefetcher = fetch
        profiler = _ProfileWindow(self)
        watchdog = elastic.HungStepWatchdog.from_config()
        wall_start = time.perf_counter()
        if watchdog is not None:
            watchdog.start()
        # the guard's tier 1 is held for the run, so the per-iteration
        # regions below switch only thread-local state
        with hot_guard.hold():
            try:
                self._loop(state, fetch, run_step, epoch_size, max_bad_steps,
                           publish, account, profiler, watchdog, integrity,
                           hot_guard, fetch_guard)
            finally:
                # the watchdog first: the teardown below may block, and an
                # armed monitor would read that as a hung step
                try:
                    if watchdog is not None:
                        watchdog.stop()
                finally:
                    try:
                        profiler.stop()
                    finally:
                        fetch.stop()
                        if fetch.batches:
                            # where the input pipeline spent its time (JAX
                            # :1344-1345)
                            self.metrics.add("batch fetch time",
                                             fetch.fetch_ns)
                            self.metrics.add("transfer block time",
                                             fetch.block_ns)
        logger.info("Training finished in %.1f s; batch fetch %.3f s, the "
                    "loop's wait for batches %.3f s, large copies waited "
                    "for %.3f s, over %d batches.",
                    time.perf_counter() - wall_start, fetch.fetch_ns / 1e9,
                    fetch.wait_ns / 1e9, fetch.block_ns / 1e9, fetch.batches)
        from bigdl_tpu_torch.dataset import ingest
        for eng in sorted((e for e in ingest._LIVE if e.has_active_run()),
                          key=lambda e: e.name):
            for stage, snap in eng.stats().items():
                logger.info(
                    "Ingest %s stage %s: %d items, %.1f/s, busy %.1fs, "
                    "starve %.1fs, backpressure %.1fs, workers %d",
                    eng.name, stage, snap["items"],
                    snap["throughput_per_sec"], snap["busy_s"],
                    snap["starve_s"], snap["backpressure_s"],
                    eng.stage_workers.get(stage, 1))
        # where the step time went, one line (JAX :1385)
        acct = account.summary()
        if acct.get("steps"):
            logger.info(
                "Step time decomposition over %d steps (mean %.1f ms): "
                "data-wait %.0f%%, compute %.0f%%, host-pull %.0f%%, "
                "bookkeeping %.0f%%, unaccounted %.0f%%; p50/p95/p99 "
                "%.1f/%.1f/%.1f ms; %d slow step(s)",
                acct["steps"], acct["mean_step_ms"],
                100 * acct["data_wait_frac"], 100 * acct["compute_frac"],
                100 * acct["host_pull_frac"],
                100 * acct["bookkeeping_frac"],
                100 * acct["unaccounted_frac"], acct.get("p50_ms", 0.0),
                acct.get("p95_ms", 0.0), acct.get("p99_ms", 0.0),
                acct["slow_steps"])
        self._export_telemetry(account)
        return state

    def _export_telemetry(self, account) -> None:
        """The run-end artifacts (rank 0 alone): the Chrome trace
        (``bigdl.telemetry.tracePath``) and the registry snapshot with the
        step account (``bigdl.telemetry.snapshotPath``; a directory gets
        ``telemetry.json``), each disk-full guarded.  The trace waits for
        an asynchronous snapshot still being written, so that it holds the
        writer's span (the JAX package exports before the write ends; its
        error still re-raises at :meth:`optimize`'s join)."""
        if not is_writer_process():
            return
        trace_path = config.get_property("bigdl.telemetry.tracePath")
        if trace_path and telemetry.tracing_enabled():
            if self.checkpoint is not None:
                self.checkpoint.manager.wait()
            if resource_storage.guarded_export(
                    "telemetry",
                    lambda: telemetry.export_chrome_trace(str(trace_path))):
                logger.info("Telemetry timeline written to %s", trace_path)
        snap_path = config.get_property("bigdl.telemetry.snapshotPath")
        if snap_path:
            import json
            snap_path = str(snap_path)
            if os.path.isdir(snap_path):
                snap_path = os.path.join(snap_path, "telemetry.json")
            snap = telemetry.REGISTRY.snapshot()
            snap["step_summary"] = account.summary()

            def write_snap():
                with open(snap_path, "w") as f:
                    json.dump(snap, f, indent=1, sort_keys=True)

            if resource_storage.guarded_export("telemetry", write_snap):
                logger.info("Telemetry snapshot written to %s", snap_path)

    def _loop(self, state, fetch, run_step, epoch_size: int,
              max_bad_steps: int, publish, account, profiler,
              watchdog=None, integrity=None, hot_guard=NULL_GUARD,
              fetch_guard=NULL_GUARD) -> None:
        clock = telemetry.clock_ns
        want_flops = (config.get_bool("bigdl.telemetry.mfu", False) and
                      self._step_flops is None)
        peak_tflops = config.get_float("bigdl.telemetry.peakTflops", 0.0)
        log_every = max(1, config.get_int("bigdl.telemetry.logEveryN", 1))
        slow_dir = config.get_property("bigdl.telemetry.profileOnSlowStep")
        wd_pause = watchdog.paused if watchdog is not None else nullcontext
        while not self.end_when(state):
            profiler.maybe_start(state["neval"])
            t0 = clock()
            if watchdog is not None:
                watchdog.heartbeat()
            # one governor tick an iteration: the accounted buffers against
            # bigdl.resources.hostMemBudgetMB, the shrinkers on an edge
            GOVERNOR.poll()
            # the chaos step hooks: a step failure raises, a preemption
            # sets the flag read below, a stall sleeps, a NaN-loss
            # injection flags this iteration
            inject_nan = (chaos.on_step(state["neval"]) if chaos.active()
                          else False)
            if elastic.preemption_requested():
                # the drain: publish the live state into the model and
                # method, and unwind as Preempted; the counter is bumped
                # here, not in the signal handler
                telemetry.counter(
                    "Elastic/preemptions",
                    help="graceful-shutdown drains observed").inc()
                with wd_pause():
                    if publish is not None:
                        with telemetry.span("driver/publish"):
                            publish()
                raise elastic.Preempted(
                    f"preemption requested "
                    f"({elastic.preemption_reason()}) - drained and "
                    f"published at iteration {state['neval']}")
            t_fetch = clock()
            with fetch_guard.armed():
                with telemetry.span("driver/fetch"):
                    inputs, targets, bsz = fetch()
            t_fetched = clock()
            self.metrics.add("get batch time", t_fetched - t_fetch)
            with hot_guard.armed():
                self.optim_method.state["epoch"] = state["epoch"]
                hyper = self.optim_method.hyper()
                t_step = clock()
                with telemetry.span("driver/device_step"):
                    if want_flops:
                        # the first step runs under the flop counter, which
                        # changes nothing it computes
                        want_flops = False
                        with telemetry.StepFlops() as sf:
                            loss_t = run_step(inputs, targets, hyper,
                                              state["neval"] - 1)
                        self._step_flops = sf.total
                        if sf.total:
                            logger.info("Step FLOPs for MFU: %.3f GFLOP",
                                        sf.total / 1e9)
                    else:
                        loss_t = run_step(inputs, targets, hyper,
                                          state["neval"] - 1)
                t_stepped = clock()
                loss_t, aux = (loss_t if isinstance(loss_t, tuple)
                               else (loss_t, None))
                self.optim_method.step_done()
                t_pull = clock()
                with telemetry.span("driver/host_wait"):
                    # the one intended host read of the iteration, through
                    # the explicit choke point
                    loss = float(host_pull(loss_t, what="iteration loss"))
            if inject_nan:
                loss = math.nan
            t_book = clock()
            dt = (t_book - t0) / 1e9
            self.metrics.add("computing time for each node", t_book - t0)
            neval, recs = state["neval"], state["recordsProcessedThisEpoch"]
            state["Loss"] = loss
            self.history.append({"neval": neval, "epoch": state["epoch"],
                                 "loss": loss, "records": bsz,
                                 "seconds": dt,
                                 "wait_seconds": fetch.last_wait_ns / 1e9,
                                 "fetch_seconds": fetch.last_fetch_ns / 1e9})
            throughput = bsz / max(dt, 1e-9)
            mfu_note = ""
            if self._step_flops:
                tflops = self._step_flops / max(dt, 1e-9) / 1e12
                telemetry.gauge("Telemetry/tflops", summary=True).set(tflops)
                if peak_tflops > 0:
                    telemetry.gauge("Telemetry/mfu", summary=True).set(
                        tflops / peak_tflops)
                    mfu_note = f" MFU is {100 * tflops / peak_tflops:.1f}%."
                else:
                    mfu_note = f" Achieved {tflops:.3f} TFLOP/s."
            if neval % log_every == 0:
                logger.info(
                    "[Epoch %d %d/%d][Iteration %d] Train %d in %.4f "
                    "seconds. Throughput is %.1f records/second. Loss is "
                    "%.6f.%s", state["epoch"], recs + bsz, epoch_size, neval,
                    bsz, dt, throughput, loss, mfu_note)
            if not math.isfinite(loss):
                state["consecutiveBadSteps"] += 1
                # the step kept the index of the first non-finite leaf on
                # the device; it is read only on this bad-step path
                culprit = ""
                if (integrity is not None and aux is not None
                        and "nf" in aux):
                    culprit = integrity.describe_nonfinite(int(host_pull(
                        aux["nf"], what="first non-finite leaf")))
                logger.warning(
                    "Non-finite loss/grads (%s) at iteration %d - update "
                    "skipped (%d consecutive bad step(s); limit %d)%s",
                    loss, neval, state["consecutiveBadSteps"], max_bad_steps,
                    culprit)
                if 0 < max_bad_steps <= state["consecutiveBadSteps"]:
                    incident.record(
                        "optim/divergence", iteration=neval,
                        bad_steps=state["consecutiveBadSteps"])
                    raise DivergenceError(
                        f"{state['consecutiveBadSteps']} consecutive "
                        f"non-finite losses (last at iteration {neval})"
                        f"{culprit}")
            else:
                state["consecutiveBadSteps"] = 0
            # training-state integrity at its cadence: a disagreement or a
            # continuity break raises into the retry loop, healthy verdicts
            # feed the weight-health gates
            if (integrity is not None and aux is not None
                    and "cont" in aux and integrity.due(neval)):
                with telemetry.span("driver/integrity_check"):
                    integrity.check(aux, neval)
            t_end = clock()
            # the parts are the timed calls; the signed rest (the
            # hyper-parameters, the counters, the governor's poll and the
            # chaos hooks) is unaccounted
            fired = account.account(
                t_end - t0, data_wait=t_fetched - t_fetch,
                compute=t_stepped - t_step, host_pull=t_book - t_pull,
                bookkeeping=t_end - t_book)
            if fired:
                self._slow_step(account, neval, t_end - t0, slow_dir,
                                profiler)
            with telemetry.span("driver/summary"):
                self._summarize_train(loss, throughput, neval)
            state["recordsProcessedThisEpoch"] += bsz
            if state["recordsProcessedThisEpoch"] >= epoch_size:
                state["epoch"] += 1
                state["recordsProcessedThisEpoch"] = 0
            state["neval"] += 1
            profiler.maybe_stop(state["neval"])
            self.optim_method.state["epoch"] = state["epoch"]
            v_due = self._validation_due(state)
            c_due = self._checkpoint_due(state)
            p_due = (self.train_summary is not None and
                     self.train_summary.save_parameters_due(state))
            if v_due or c_due or p_due:
                # a validation or a snapshot may take many steps' time: not
                # a stall
                with wd_pause():
                    self._after_step(state, publish, v_due, c_due, p_due)

    def _after_step(self, state, publish, v_due: bool, c_due: bool,
                    p_due: bool) -> None:
        if publish is not None:
            with telemetry.span("driver/publish"):
                publish()
        if v_due:
            with telemetry.span("driver/validation"):
                self._run_validation(state)
        if c_due:
            with telemetry.span("driver/checkpoint"):
                self._run_checkpoint(state)
        if p_due and is_writer_process():
            # weight histograms (DistriOptimizer.scala:426-456); every rank
            # publishes, rank 0 writes
            with telemetry.span("driver/param_histograms"):
                self.train_summary.save_parameters(self.model,
                                                   state["neval"] - 1)

    def _slow_step(self, account, neval: int, wall_ns: int, slow_dir,
                   profiler) -> None:
        """A step opened a slow-step window: mark it on the timeline, log
        it, and under ``bigdl.telemetry.profileOnSlowStep`` ask for a
        one-step profiler window and dump the timeline (bounded by
        ``bigdl.telemetry.maxTimelineDumps``; rank 0 alone)."""
        telemetry.instant("driver/slow_step", iteration=neval,
                          step_ms=round(wall_ns / 1e6, 3))
        logger.warning(
            "Slow step at iteration %d: %.1f ms (> %.1f ms = k x EMA); %d "
            "anomaly window(s) this run", neval, wall_ns / 1e6,
            account.detector.threshold() / 1e6, account.detector.fired)
        if not slow_dir:
            return
        profiler.request_slow(os.path.join(str(slow_dir), "slowstep_profile"))
        if is_writer_process() and telemetry.tracing_enabled():
            resource_storage.bounded_timeline_export(os.path.join(
                str(slow_dir), f"slowstep_{neval}_timeline.json"))

    def _summarize_train(self, loss: float, throughput: float,
                         neval: int) -> None:
        """Loss, Throughput and LearningRate, then THE one emission loop
        over the registry's summary scalars and the step latency
        percentiles (JAX :1534).  Rank 0 alone."""
        if self.train_summary is None or not is_writer_process():
            return
        self.train_summary.add_scalar("Loss", loss, neval)
        self.train_summary.add_scalar("Throughput", throughput, neval)
        self.train_summary.add_scalar(
            "LearningRate", self.optim_method.get_learning_rate(), neval)
        # the sanitizers' counters (JAX :1543-1555): post-warmup retraces
        # of the step and implicit host syncs caught in the hot loop THIS
        # run; a healthy run charts both flat at zero.  Each pass gates
        # its own gauge.
        if self._retrace_sentinel is not None:
            telemetry.gauge("Analysis/retraces", summary=True).set(
                self._retrace_sentinel.retraces)
        if self._hostsync_base is not None:
            telemetry.gauge("Analysis/implicit_host_syncs",
                            summary=True).set(
                STATS.snapshot()["implicit"] - self._hostsync_base)
        scalars = telemetry.summary_scalars()
        acct = self._step_account
        if acct is not None and acct.steps:
            scalars += acct.percentile_scalars()
        for tag, value in scalars:
            self.train_summary.add_scalar(tag, value, neval)

    # -- factory ----------------------------------------------------------

    @staticmethod
    def create(model: torch.nn.Module, dataset, criterion: Criterion,
               batch_size: Optional[int] = None,
               device: DeviceLike = "cuda") -> "Optimizer":
        """(reference ``Optimizer.apply:268``): a list of samples or a
        ``LocalDataSet`` gives a :class:`LocalOptimizer`, a
        ``ShardedDataSet`` a :class:`~bigdl_tpu_torch.parallel.
        distri_optimizer.DistriOptimizer` over the default process group;
        ``batch_size`` (the global batch) adds a
        ``SampleToMiniBatch(batch_size, partition_num)`` where the dataset
        has none."""
        if isinstance(dataset, (list, tuple)):
            dataset = LocalDataSet(dataset)
        if not isinstance(dataset, (LocalDataSet, ShardedDataSet)):
            raise NotImplementedError(
                f"{type(dataset).__name__}: only LocalDataSet and "
                "ShardedDataSet are ported")
        if batch_size is not None and not _yields_minibatches(dataset):
            dataset = dataset.transform(SampleToMiniBatch(
                batch_size, getattr(dataset, "partition_num", 1)))
        if isinstance(dataset, ShardedDataSet):
            from bigdl_tpu_torch.parallel.distri_optimizer import \
                DistriOptimizer
            return DistriOptimizer(model, dataset, criterion, device=device)
        return LocalOptimizer(model, dataset, criterion, device=device)


class LocalOptimizer(Optimizer):
    """Single-process trainer (reference ``optim/LocalOptimizer.scala:41``):
    one step per iteration on the model's device.

    After a device OOM the step runs as ``k`` accumulation chunks of the
    global batch (:meth:`Optimizer._replan_microbatch`); with
    ``bigdl.integrity.everyN`` > 0 it carries the fingerprint continuity
    of its parameters and slots from step to step (JAX :1635-1700)."""

    def _step(self, params, slots, mstate, inputs, targets, hyper,
              guard: bool, scales=None, fpc=None, tick: int = 0,
              k: int = 1):
        """Forward, loss + penalties, gradients (times the layers'
        ``scales``, :func:`grad_scales`), update and divergence guard;
        returns ``(loss, aux)``, the loss NaN when the guard skipped the
        update.  ``mstate`` is :func:`module_state`, snapshotted first
        where a bad step, a frozen step or the chunks need it back.

        ``k`` > 1 splits the batch into k equal chunks: each chunk's
        forward starts from the pre-step module state, and the loss, the
        gradients and the new module state are the Kahan-compensated means
        over the chunks (:func:`~bigdl_tpu_torch.resources.microbatch.
        scan_mean`), followed by one update.

        ``fpc`` is the integrity carry: the input fingerprints of the
        parameters and slots are checked against the previous step's
        output ones; a break latches and freezes the update like a bad
        step (without poisoning the loss), and ``aux`` carries the
        verdicts, the output fingerprints, the norms and the next carry.
        ``aux["nf"]`` is the first non-finite leaf under the guard."""
        seed = config.get_int("bigdl.integrity.seed", integrity.DEFAULT_SEED)
        saved = ([b.clone() for b in mstate]
                 if guard or k > 1 or fpc is not None else [])
        aux: Dict[str, Any] = {}
        if fpc is not None:
            with torch.no_grad():
                fp_p_in = integrity.fingerprint_tree(params, seed)
                fp_s_in = integrity.fingerprint_tree(
                    _leaves(slots), seed + integrity.SLOT_SEED_OFF)
                _, latch, bad_iter = integrity.continuity_check(
                    fpc, fp_p_in, fp_s_in, tick)

        def loss_and_grads(x, y):
            out = mixed_precision_forward(self.model, x, self.precision)
            loss = self._loss(out, y)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            return loss.detach(), [torch.zeros_like(p) if g is None else g
                                   for g, p in zip(grads, params)]

        if k == 1:
            loss, grads = loss_and_grads(inputs, targets)
        else:
            def chunk(xs):
                with torch.no_grad():
                    for live, kept in zip(mstate, saved):
                        live.copy_(kept)
                closs, cgrads = loss_and_grads(*xs)
                return [closs] + cgrads + [b.detach().clone()
                                           for b in mstate]

            vals = microbatch.scan_mean(chunk, (inputs, targets), k)
            loss, grads = vals[0], vals[1:1 + len(params)]
            with torch.no_grad():
                for live, v in zip(mstate, vals[1 + len(params):]):
                    live.copy_(v)
        if scales is not None:
            grads = [g if s == 1.0 else g * s for g, s in zip(grads, scales)]
        with torch.no_grad():
            new_params, new_slots = self.optim_method.pure_update(
                grads, params, slots, hyper)
            ok = True
            if guard:
                ok, nf = integrity.first_nonfinite(loss, grads)
                aux["nf"] = nf
            if fpc is not None:
                intact = latch == 0
                ok = intact if ok is True else ok & intact
                un = integrity.sq_norm_diff(new_params, params)
            # a failure from here until the writes end leaves the live
            # parameters torn (_params_dead)
            self._torn = True
            select_tree(ok, new_params, params)
            select_tree(ok, new_slots, slots)
            if ok is not True:
                for live, kept in zip(mstate, saved):
                    torch.where(ok, live, kept, out=live)
            self._torn = False
            if guard and ok is not True:
                # only the finiteness verdict poisons the loss: a frozen
                # integrity step reports through aux
                loss = torch.where(
                    aux["nf"] == integrity.NF_SENTINEL, loss,
                    torch.full_like(loss, math.nan))
            if fpc is not None:
                fp_p_out = integrity.fingerprint_tree(params, seed)
                fp_s_out = integrity.fingerprint_tree(
                    _leaves(slots), seed + integrity.SLOT_SEED_OFF)
                aux.update(
                    cont=latch, bad_iter=bad_iter, fp_p=fp_p_out,
                    fp_s=fp_s_out,
                    fp_g=integrity.fingerprint_tree(
                        grads, seed + integrity.GRAD_SEED_OFF),
                    pn=integrity.sq_norm(params),
                    un=torch.where(ok, un, torch.zeros_like(un)),
                    gn=integrity.sq_norm(grads),
                    fpc=integrity.pack_carry(latch, bad_iter, fp_p_out,
                                             fp_s_out))
        return loss, aux

    def _build_feval_step(self, params, mstate, stream=None):
        """The host-driven step of a feval method (LBFGS; JAX :1755):
        ``step(inputs, targets, seed) -> (loss, aux)`` hands the method's
        inner loop one loss-and-gradient function of the parameters,
        called as often as it asks.  Each call writes its point into the
        live parameters, runs the forward from the step's module state
        (BatchNorm's running statistics are held fixed within a step, as
        the JAX step discards the new state; a stochastic model replays the
        step's random stream ``stream``) and returns the criterion plus the
        regularizer penalties with their gradients.  LBFGS is a full-batch
        method in the reference too.  The step's loss is the last one (a
        Python float); its aux is empty."""
        def step(inputs, targets, seed):
            saved = [b.clone() for b in mstate]

            def feval(point):
                with torch.no_grad():
                    for live, new in zip(params, point):
                        live.copy_(new)
                    for live, kept in zip(mstate, saved):
                        live.copy_(kept)
                if stream is not None:
                    stream.manual_seed(seed)
                out = self.model(inputs)
                loss = self.criterion.apply(out, targets)
                penalty = regularization_penalty(self.model)
                if penalty is not None:
                    loss = loss + penalty
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                return loss.detach(), [torch.zeros_like(p) if g is None
                                       else g for g, p in zip(grads, params)]

            start = [p.detach().clone() for p in params]
            self._torn = True
            new_params, losses = self.optim_method.optimize(feval, start)
            with torch.no_grad():
                for live, new in zip(params, new_params):
                    live.copy_(new)
                for live, kept in zip(mstate, saved):
                    live.copy_(kept)
            self._torn = False
            return losses[-1], {}

        return step

    def _optimize(self) -> torch.nn.Module:
        refuse_unported()
        feval = self._feval()
        if feval and self.precision is not None:
            raise ValueError(
                f"{type(self.optim_method).__name__} uses the host-driven "
                "feval path, which is fp32-only; unset set_precision")
        self.model.train()
        # one generator on the device, seeded afresh each step: the same
        # seed and data give the same masks, run after run
        stream = (torch.Generator(device=self.device)
                  if is_stochastic(self.model) else None)
        params = list(self.model.parameters())
        scales = grad_scales(self.model, params)
        mstate = module_state(self.model)
        slots = self.optim_method.slots(params)
        self.optim_method.state.setdefault("epoch", 1)
        # the integrity pass and its continuity are off for feval methods
        # (JAX :1800-1805): the line search's steps are not one update
        guard = not feval and config.get_bool("bigdl.divergence.guard", True)
        every_n = 0 if feval else config.get_int("bigdl.integrity.everyN", 0)
        integ = None
        if guard or every_n > 0:
            integ = integrity.DriverIntegrity(
                "local",
                integrity.nonfinite_names(
                    ("loss", 0.0),
                    ("grad", dict(self.model.named_parameters()))),
                every_n=every_n,
                health=integrity.WeightHealthMonitor(
                    config.get_float("bigdl.integrity.healthFactor", 0.0),
                    warmup=config.get_int("bigdl.integrity.healthWarmup", 5),
                    cooldown=config.get_int(
                        "bigdl.integrity.healthCooldown", 50)))
        # a fresh carry each attempt: a restored or healed state
        # legitimately differs from the last carry
        carry = {"fpc": integrity.init_carry(self.device)
                 if every_n > 0 else None}
        it = {"data": None}

        def reset_epoch():
            self.dataset.shuffle()
            it["data"] = self.dataset.data(train=True)

        def fetch_batch():
            batch = next(it["data"])
            # the OOM re-plan picks k against the observed global batch
            self._plan_batch_size = batch.size()
            return batch.get_input(), batch.get_target(), batch.size()

        feval_step = (self._build_feval_step(params, mstate, stream)
                      if feval else None)

        def step(inputs, targets, hyper, seed):
            if feval_step is not None:
                if stream is None:
                    return feval_step(inputs, targets, seed)
                with random_stream(self.model, stream):
                    return feval_step(inputs, targets, seed)
            args = (params, slots, mstate, inputs, targets, hyper, guard,
                    scales, carry["fpc"],
                    self.optim_method.state.get("evalCounter", 0) + 1,
                    self._microbatch_k)
            if stream is None:
                return self._step(*args)
            stream.manual_seed(seed)
            with random_stream(self.model, stream):
                return self._step(*args)

        def run_step(inputs, targets, hyper, seed):
            if chaos.active():
                flip = chaos.take_bitflip()
                if flip is not None:
                    # injected silent corruption between steps: finite,
                    # invisible to the guard; the fingerprints must see it
                    integrity.bitflip_tree(params, flip)
            k = self._microbatch_k
            label = "local" if k == 1 else f"local_mb{k}"
            if self.device.type == "cuda":
                self._step_entry_bytes = torch.cuda.memory_allocated(
                    self.device)
            oom = None
            try:
                if chaos.active():
                    chaos.take_oom_dispatch(label)
                loss, aux = step(inputs, targets, hyper, seed)
            except Exception as e:  # noqa: BLE001 re-raised unless an OOM
                oom = classify_dispatch_error(e, label, self.device)
                if oom is None:
                    raise
            if oom is not None:
                # raised here, outside the handler: the failed step's
                # traceback, which holds its activations, is already gone
                raise oom
            if "fpc" in aux:
                carry["fpc"] = aux["fpc"]
            return loss, aux

        run_step = self._arm_retrace(run_step, "local")
        self._sync_dataset_epoch()
        reset_epoch()
        try:
            self._drive(fetch_batch, run_step, reset_epoch,
                        epoch_size=self.dataset.size(), integrity=integ)
        finally:
            close_iterators(self.prefetcher, [it["data"]])
        return self.model
