"""Training orchestration: the ``Optimizer`` base with its fluent setters and
factory, and the single-process ``LocalOptimizer``
(``bigdl_tpu/optim/optimizer.py``: ``mixed_precision_forward`` :102,
``all_finite`` :145, ``select_tree`` :165, ``regularization_penalty`` :174,
``Optimizer`` :246, ``_sync_dataset_epoch`` :667, ``Optimizer.create`` :1569,
``LocalOptimizer`` :1613, the training loop ``_drive`` :865; reference
``optim/Optimizer.scala:42,268``, ``optim/LocalOptimizer.scala:41``).  The
data-parallel trainer is :mod:`bigdl_tpu_torch.parallel.distri_optimizer`.

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

Not ported yet: checkpoints, validation, the failure-retry loop, telemetry
and the step-time account, integrity fingerprints, the microbatch re-plan
after a device OOM, the compile cache and preemption.  The keys that ask
for the last two (``bigdl.integrity.everyN``, ``bigdl.elastic.handleSignals``)
raise :class:`NotImplementedError` (:func:`refuse_unported`).
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Dict, List, Optional

import torch
from torch.func import functional_call

from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, LocalDataSet,
                                             ShardedDataSet)
from bigdl_tpu_torch.dataset.transformer import (ChainedTransformer,
                                                 SampleToMiniBatch)
from bigdl_tpu_torch.engine import (BatchPrefetcher, DeviceLike,
                                    check_on_device, default_device)
from bigdl_tpu_torch.nn.module import (Container, Criterion, is_stochastic,
                                       random_stream, state_buffers)
from bigdl_tpu_torch.optim import trigger as triggers
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.utils import config

logger = logging.getLogger("bigdl_tpu_torch")


class DivergenceError(RuntimeError):
    """Raised by the training loop after ``bigdl.divergence.maxBadSteps``
    consecutive non-finite losses."""


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
                            precision: Optional[str] = "bf16"):
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
    plain forward."""
    if precision != "bf16":
        return model(inputs)
    params = cast_floats(dict(model.named_parameters()), torch.bfloat16)
    out = functional_call(model, params,
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
        self.history: List[Dict[str, Any]] = []
        self.prefetcher: Optional[BatchPrefetcher] = None

    # -- fluent setters (reference Optimizer.scala fluent API) ------------

    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        return self

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
        return self

    def set_precision(self, precision: Optional[str]) -> "Optimizer":
        """``"bf16"`` runs the forward and backward in bfloat16 while the
        master weights, the loss and the update stay float32."""
        if precision not in (None, "bf16"):
            raise ValueError(f"unsupported precision {precision!r}")
        self.precision = precision
        return self

    def optimize(self) -> torch.nn.Module:
        """Train until the end trigger fires; returns the model, whose
        parameters hold the trained weights."""
        return self._optimize()

    def _optimize(self) -> torch.nn.Module:
        raise NotImplementedError

    def _sync_dataset_epoch(self) -> None:
        """Set a ``ShardedDataSet``'s shuffle round to ``epoch - 1``, so
        that the first reshuffle of a run that continues at epoch E draws
        epoch E's permutation (shuffles are pure in ``(seed, round)``); a
        ``LocalDataSet`` has no rounds."""
        sync = getattr(self.dataset, "set_shuffle_round", None)
        if sync is not None:
            sync(self.optim_method.state.get("epoch", 1) - 1)

    def _drive(self, fetch_batch, run_step, reset_epoch,
               epoch_size: int) -> Dict[str, Any]:
        """The training loop (reference ``optim/DistriOptimizer.scala:141-344``,
        ``LocalOptimizer.scala:78``): fetch, step, bookkeeping and logging,
        epoch rollover.  ``fetch_batch() -> (inputs, targets, batch_size)``
        with host (numpy) arrays; ``run_step(inputs, targets, hyper, seed)
        -> loss`` (a 0-dim tensor; ``seed`` is the step's random-stream
        counter, ``neval - 1``, the JAX package's ``rng_counter``);
        ``reset_epoch()`` reshuffles and restarts the data iterator.

        A :class:`~bigdl_tpu_torch.engine.BatchPrefetcher` calls
        ``fetch_batch`` and moves the batch to the device; the rollover
        runs on its producer, at the record boundary as the batch that
        crosses it is fetched (the reference's batch producer), so the
        batch sequence is the same at every ``bigdl.prefetch.depth``."""
        state = _initial_loop_state()
        # a second optimize() continues the counters the OptimMethod carries
        state["neval"] = self.optim_method.state.get("evalCounter", 0) + 1
        state["epoch"] = self.optim_method.state.get("epoch", 1)
        max_bad_steps = config.get_int("bigdl.divergence.maxBadSteps", 5)
        fetched = {"records": 0}

        def on_batch(batch):
            fetched["records"] += batch[2]
            if fetched["records"] >= epoch_size:
                fetched["records"] = 0
                reset_epoch()

        fetch = BatchPrefetcher(fetch_batch, on_batch=on_batch,
                                device=self.device)
        self.prefetcher = fetch
        wall_start = time.perf_counter()
        try:
            self._loop(state, fetch, run_step, epoch_size, max_bad_steps)
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
        return state

    def _loop(self, state, fetch, run_step, epoch_size: int,
              max_bad_steps: int) -> None:
        while not self.end_when(state):
            t0 = time.perf_counter()
            inputs, targets, bsz = fetch()
            self.optim_method.state["epoch"] = state["epoch"]
            hyper = self.optim_method.hyper()
            loss_t = run_step(inputs, targets, hyper, state["neval"] - 1)
            self.optim_method.step_done()
            loss = float(loss_t)     # the one host read of the iteration
            dt = time.perf_counter() - t0
            neval, recs = state["neval"], state["recordsProcessedThisEpoch"]
            state["Loss"] = loss
            self.history.append({"neval": neval, "epoch": state["epoch"],
                                 "loss": loss, "records": bsz,
                                 "seconds": dt,
                                 "wait_seconds": fetch.last_wait_ns / 1e9,
                                 "fetch_seconds": fetch.last_fetch_ns / 1e9})
            logger.info(
                "[Epoch %d %d/%d][Iteration %d] Train %d in %.4f seconds. "
                "Throughput is %.1f records/second. Loss is %.6f.",
                state["epoch"], recs + bsz, epoch_size, neval, bsz, dt,
                bsz / max(dt, 1e-9), loss)
            if not math.isfinite(loss):
                state["consecutiveBadSteps"] += 1
                logger.warning(
                    "Non-finite loss/grads (%s) at iteration %d - update "
                    "skipped (%d consecutive bad step(s); limit %d)", loss,
                    neval, state["consecutiveBadSteps"], max_bad_steps)
                if 0 < max_bad_steps <= state["consecutiveBadSteps"]:
                    raise DivergenceError(
                        f"{state['consecutiveBadSteps']} consecutive "
                        f"non-finite losses (last at iteration {neval})")
            else:
                state["consecutiveBadSteps"] = 0
            state["recordsProcessedThisEpoch"] += bsz
            if state["recordsProcessedThisEpoch"] >= epoch_size:
                state["epoch"] += 1
                state["recordsProcessedThisEpoch"] = 0
            state["neval"] += 1
            self.optim_method.state["epoch"] = state["epoch"]

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
              guard: bool) -> torch.Tensor:
        """Forward, loss + penalties, gradients, update and divergence
        guard; returns the loss (NaN when the guard skipped the update).
        ``mstate`` is :func:`module_state`; under the guard it is
        snapshotted first, to be put back after a bad step."""
        saved = [b.clone() for b in mstate] if guard else []
        out = mixed_precision_forward(self.model, inputs, self.precision)
        loss = self.criterion.apply(out, targets)
        penalty = regularization_penalty(self.model)
        if penalty is not None:
            loss = loss + penalty
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
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
                                  hyper, guard)
            stream.manual_seed(seed)
            with random_stream(self.model, stream):
                return self._step(params, slots, mstate, inputs, targets,
                                  hyper, guard)

        reset_epoch()
        try:
            self._drive(fetch_batch, run_step, reset_epoch,
                        epoch_size=self.dataset.size())
        finally:
            close_iterators(self.prefetcher, [it["data"]])
        return self.model
