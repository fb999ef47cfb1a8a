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
``ValueError``, ``TypeError``, ``KeyboardInterrupt`` and
``torch.cuda.OutOfMemoryError`` go straight to the caller).  A restore
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
in place of ``jax.profiler``.  The port has no ``analysis`` package, so no
``Analysis/*`` gauge is written.

Not ported yet: integrity fingerprints, the microbatch re-plan after a
device OOM, the compile cache and its warmup spans, the host-sync and
retrace counters, the hung-step watchdog, the chaos hooks, the host-memory
governor and preemption.  The keys that ask for two of them
(``bigdl.integrity.everyN``, ``bigdl.elastic.handleSignals``) raise
:class:`NotImplementedError` (:func:`refuse_unported`).
"""

from __future__ import annotations

import logging
import math
import os
import random
import time
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
from bigdl_tpu_torch import telemetry
from bigdl_tpu_torch.resources import storage as resource_storage
from bigdl_tpu_torch.utils import config, elastic

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
    trainer for a feature the port does not have yet."""
    asked = [k for k in ("bigdl.integrity.everyN",)
             if config.get_int(k, 0) > 0]
    if config.get_bool("bigdl.elastic.handleSignals", False):
        asked.append("bigdl.elastic.handleSignals")
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: integrity fingerprints and elastic "
            "drain/resume are not ported yet")


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
    as it stops."""

    def __init__(self, opt: "Optimizer"):
        self.opt = opt
        self.prof = None
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
        """Train until the end trigger fires, retrying failures from the
        newest valid snapshot (reference ``DistriOptimizer.scala:750-816``);
        returns the model, whose parameters hold the trained weights.

        Up to ``bigdl.failure.retryTimes`` attempts, waiting
        :func:`_retry_backoff` (``bigdl.failure.retryTimeInterval``,
        ``bigdl.failure.maxRetryInterval``) between them.  The attempt
        count resets when a run gets past the furthest ``evalCounter`` any
        attempt reached (a fresh fault), never after a divergence.  The
        asynchronous writer is drained before this returns or raises.
        The ``Parallel/*`` gauges of an earlier run are dropped first
        (a ``DistriOptimizer`` sets them again)."""
        telemetry.REGISTRY.drop_prefix("Parallel/")
        retry_times = config.get_int("bigdl.failure.retryTimes", 5)
        base = config.get_float("bigdl.failure.retryTimeInterval", 120.0)
        cap = config.get_float("bigdl.failure.maxRetryInterval", 900.0)
        try:
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
            try:
                result = self._optimize()
            except (ValueError, TypeError, KeyboardInterrupt,
                    NotImplementedError, torch.cuda.OutOfMemoryError):
                # an argument error, an unported feature, or a device OOM
                # (its re-plan is not ported): no retry
                raise
            except Exception as e:
                cur = self.optim_method.state.get("evalCounter", 0)
                if (not isinstance(e, DivergenceError) and
                        high_water is not None and cur > high_water):
                    attempt = 0    # new ground: a fresh fault
                high_water = cur if high_water is None else max(high_water,
                                                                cur)
                attempt += 1
                if attempt >= retry_times:
                    raise
                restored = self._restore_latest_checkpoint()
                interval = _retry_backoff(attempt, base, cap)
                logger.exception(
                    "Training failed (attempt %d/%d); %s and retrying in "
                    "%.1fs", attempt, retry_times,
                    "restored the latest valid checkpoint" if restored
                    else "resuming from the live state", interval)
                time.sleep(interval)
                continue
            if self.checkpoint is not None:
                self.checkpoint.join()
            return result

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
        loaded = self.checkpoint.manager.load_latest(
            expected_topology=self._topology_meta())
        if loaded is None:
            return False
        model_payload, optim_payload, n = loaded
        self.model.load_state_dict(model_payload)
        load_payload(self.optim_method, optim_payload, device=self.device,
                     hyper=False)
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
               epoch_size: int, publish=None) -> Dict[str, Any]:
        """The training loop (reference ``optim/DistriOptimizer.scala:141-344``,
        ``LocalOptimizer.scala:78``): fetch, step, bookkeeping and logging,
        epoch rollover, then the validation and the checkpoint where their
        triggers fire (``publish()`` first, which hands the trainer's live
        slots to the method; None when they are the method's own).
        ``fetch_batch() -> (inputs, targets, batch_size)``
        with host (numpy) arrays; ``run_step(inputs, targets, hyper, seed)
        -> loss`` (a 0-dim tensor; ``seed`` is the step's random-stream
        counter, ``neval - 1``, the JAX package's ``rng_counter``);
        ``reset_epoch()`` reshuffles and restarts the data iterator.

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

        fetch = BatchPrefetcher(fetch_batch, on_batch=on_batch,
                                device=self.device)
        self.prefetcher = fetch
        profiler = _ProfileWindow(self)
        wall_start = time.perf_counter()
        try:
            self._loop(state, fetch, run_step, epoch_size, max_bad_steps,
                       publish, account, profiler)
        finally:
            try:
                profiler.stop()
            finally:
                fetch.stop()
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
              max_bad_steps: int, publish, account, profiler) -> None:
        clock = telemetry.clock_ns
        want_flops = (config.get_bool("bigdl.telemetry.mfu", False) and
                      self._step_flops is None)
        peak_tflops = config.get_float("bigdl.telemetry.peakTflops", 0.0)
        log_every = max(1, config.get_int("bigdl.telemetry.logEveryN", 1))
        slow_dir = config.get_property("bigdl.telemetry.profileOnSlowStep")
        while not self.end_when(state):
            profiler.maybe_start(state["neval"])
            t0 = clock()
            with telemetry.span("driver/fetch"):
                inputs, targets, bsz = fetch()
            t_fetched = clock()
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
            self.optim_method.step_done()
            t_pull = clock()
            with telemetry.span("driver/host_wait"):
                loss = float(loss_t)     # the one host read of the iteration
            t_book = clock()
            dt = (t_book - t0) / 1e9
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
                logger.warning(
                    "Non-finite loss/grads (%s) at iteration %d - update "
                    "skipped (%d consecutive bad step(s); limit %d)", loss,
                    neval, state["consecutiveBadSteps"], max_bad_steps)
                if 0 < max_bad_steps <= state["consecutiveBadSteps"]:
                    telemetry.incident.record(
                        "optim/divergence", iteration=neval,
                        bad_steps=state["consecutiveBadSteps"])
                    raise DivergenceError(
                        f"{state['consecutiveBadSteps']} consecutive "
                        f"non-finite losses (last at iteration {neval})")
            else:
                state["consecutiveBadSteps"] = 0
            t_end = clock()
            # the parts are the timed calls; the signed rest (the
            # hyper-parameters, the counters) is unaccounted
            fired = account.account(
                t_end - t0, data_wait=t_fetched - t0,
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
                    # weight histograms (DistriOptimizer.scala:426-456);
                    # every rank publishes, rank 0 writes
                    with telemetry.span("driver/param_histograms"):
                        self.train_summary.save_parameters(
                            self.model, state["neval"] - 1)

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
    one step per iteration on the model's device."""

    def _step(self, params, slots, mstate, inputs, targets, hyper,
              guard: bool, scales=None) -> torch.Tensor:
        """Forward, loss + penalties, gradients (times the layers'
        ``scales``, :func:`grad_scales`), update and divergence guard;
        returns the loss (NaN when the guard skipped the update).
        ``mstate`` is :func:`module_state`; under the guard it is
        snapshotted first, to be put back after a bad step."""
        saved = [b.clone() for b in mstate] if guard else []
        out = mixed_precision_forward(self.model, inputs, self.precision)
        loss = self._loss(out, targets)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        if scales is not None:
            grads = [g if s == 1.0 else g * s for g, s in zip(grads, scales)]
        with torch.no_grad():
            new_params, new_slots = self.optim_method.pure_update(
                grads, params, slots, hyper)
            ok = all_finite(loss, grads) if guard else True
            select_tree(ok, new_params, params)
            select_tree(ok, new_slots, slots)
            for live, kept in zip(mstate, saved):
                torch.where(ok, live, kept, out=live)
            loss = loss.detach()
            if ok is not True:
                loss = torch.where(ok, loss, torch.full_like(loss, math.nan))
        return loss

    def _optimize(self) -> torch.nn.Module:
        refuse_unported()
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
        guard = config.get_bool("bigdl.divergence.guard", True)
        it = {"data": None}

        def reset_epoch():
            self.dataset.shuffle()
            it["data"] = self.dataset.data(train=True)

        def fetch_batch():
            batch = next(it["data"])
            return batch.get_input(), batch.get_target(), batch.size()

        def run_step(inputs, targets, hyper, seed):
            if stream is None:
                return self._step(params, slots, mstate, inputs, targets,
                                  hyper, guard, scales)
            stream.manual_seed(seed)
            with random_stream(self.model, stream):
                return self._step(params, slots, mstate, inputs, targets,
                                  hyper, guard, scales)

        self._sync_dataset_epoch()
        reset_epoch()
        try:
            self._drive(fetch_batch, run_step, reset_epoch,
                        epoch_size=self.dataset.size())
        finally:
            close_iterators(self.prefetcher, [it["data"]])
        return self.model
