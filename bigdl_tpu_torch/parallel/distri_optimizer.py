"""DistriOptimizer: synchronous data-parallel SGD over a process group
(``bigdl_tpu/parallel/distri_optimizer.py``: ``local_data_partitions`` :90,
``map_over_slots`` :121, ``DistriOptimizer`` :198, its data-parallel step
``_build_step`` :258-612, the training loop ``_optimize`` :613-827,
``_flat_slots`` :1195, ``_global_batch`` :1210; reference
``optim/DistriOptimizer.scala:89-330``).

One process per rank, in the ``torchrun`` model (:meth:`Engine.init_distributed
<bigdl_tpu_torch.engine.Engine.init_distributed>`).  Every rank holds the
whole model, feeds partition ``rank`` of a :class:`ShardedDataSet` and runs
the same step, in the JAX package's order:

1. the forward on its own batch (bf16 through ``mixed_precision_forward``
   when asked), the loss plus the regularizer penalties, the gradients by
   autograd, concatenated into one padded flat fp32 vector;
2. the reduce-scatter of that vector (a sum) divided by the rank count:
   the rank holds the mean gradient of its 1/N slice;
3. the ``OptimMethod``'s ``pure_update`` of that slice alone, its slots
   held as flat 1/N shards (ZeRO-1, the reference's partition-sharded
   update, ``DistriOptimizer.scala:265-280``);
4. the divergence guard's verdict, made global by the minimum of the
   ranks' finite flags: after a bad step every rank keeps its pre-step
   slice, slots and module state, and reports the loss as NaN;
5. the all-gather of the slices, straight into the flat buffer whose views
   are the model's parameters (:meth:`AllReduceParameter.bind`);
6. BatchNorm's running statistics averaged over the group, and the loss.

``bigdl.parallel.overlap`` (on by default) runs steps 2-5 in buckets: the
flat vector viewed as an ``(n_ranks, shard_size)`` matrix is cut into
``bigdl.parallel.overlapBuckets`` column blocks, every block's
reduce-scatter is issued at once (``async_op=True``), so that block k+1's is
in flight while block k updates, and each block's all-gather is issued as
soon as the global verdict has been applied to it.  Every element is summed
and updated as in the one-block schedule, so the two give the same bits
wherever the sum of the ranks' operands does not depend on their order (one
or two ranks).  The collectives start after the whole backward: overlapping
them with it (gradient hooks) is not done.

Dropout: a rank's per-step generator is seeded from the step's seed and its
rank (the twin of ``fold_in(rng, axis_index)``, :311), so masks differ
between ranks and repeat run to run; rank 0 draws ``LocalOptimizer``'s.

At the end of ``optimize()`` the weights stay the model's parameters, and
the slot shards are all-gathered and handed back per parameter to the
``OptimMethod``, from which a later ``LocalOptimizer`` or ``optimize()``
continues.

Not ported, each raising :class:`NotImplementedError` where asked for: the
``seq``/``model``/``expert`` mesh axes (the GSPMD step, ring attention,
expert parallelism; :meth:`DistriOptimizer.set_mesh`), integrity
fingerprints and desync healing (``bigdl.integrity.everyN > 0``), the audit
fault injections (``bigdl.chaos.extraAllGather``,
``bigdl.chaos.dropBucketCollective``), elastic drain and resume
(``bigdl.elastic.handleSignals``), the batch prefetcher
(``bigdl.prefetch.depth > 0``), and what ``LocalOptimizer`` lacks
(:mod:`bigdl_tpu_torch.optim.optimizer`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch.dataset.dataset import ShardedDataSet
from bigdl_tpu_torch.engine import DeviceLike
from bigdl_tpu_torch.nn.module import Criterion, is_stochastic, random_stream
from bigdl_tpu_torch.optim.optimizer import (Optimizer, _to_device,
                                             all_finite,
                                             mixed_precision_forward,
                                             module_state,
                                             refuse_unported,
                                             regularization_penalty,
                                             select_tree)
from bigdl_tpu_torch.parallel.all_reduce import (AllReduceParameter,
                                                 axis_mean, axis_min,
                                                 pmean_floats)
from bigdl_tpu_torch.utils import config

#: a rank's offset of its dropout seed (the 64-bit golden ratio)
_RANK_STRIDE = 0x9E3779B97F4A7C15


def local_data_partitions(group: Optional[dist.ProcessGroup] = None
                          ) -> List[int]:
    """The dataset partitions this rank feeds: its own (the reference's
    partition-to-node locality, ``AllReduceParameter.scala:87-92``)."""
    return [dist.get_rank(group)]


def map_over_slots(optim_method, fn, slots: Dict[str, List[torch.Tensor]],
                   per_param: List) -> Dict[str, List]:
    """``fn(slot, x)`` over every slot family of ``optim_method`` (SGD's
    momentum ``dfdx``, Adam's ``s`` and ``r``), zipping each family's
    per-parameter list with ``per_param``."""
    return {k: [fn(s, x) for s, x in zip(slots[k], per_param, strict=True)]
            for k in optim_method.init_slots([])}


def _same_shape(slot: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    if slot.shape != param.shape:
        raise ValueError(f"optimizer slot of shape {tuple(slot.shape)} for "
                         f"a parameter of shape {tuple(param.shape)}")
    return slot


def _rank_seed(seed: int, rank: int) -> int:
    return (seed + rank * _RANK_STRIDE) % (2 ** 63)


class DistriOptimizer(Optimizer):
    """Data-parallel trainer over a process group (reference
    ``optim/DistriOptimizer.scala:689``).

    ``dataset`` is a :class:`ShardedDataSet` with one partition per rank
    of ``group`` (the default group when None, which
    :meth:`Engine.init_distributed
    <bigdl_tpu_torch.engine.Engine.init_distributed>` must have created).
    A CUDA ``device`` trains over NCCL and the CPU over gloo; any other
    pairing raises.  ``compression="bf16"`` sends the gradients as bf16.
    """

    def __init__(self, model: torch.nn.Module, dataset: ShardedDataSet,
                 criterion: Criterion,
                 group: Optional[dist.ProcessGroup] = None,
                 compression: Optional[str] = None,
                 device: DeviceLike = "cuda"):
        super().__init__(model, dataset, criterion, device=device)
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "DistriOptimizer needs a process group: call "
                "Engine.init_distributed() in every rank first")
        backend = dist.get_backend(group)
        wire = "nccl" if self.device.type == "cuda" else "gloo"
        if wire not in backend:
            raise ValueError(
                f"a model on {self.device} trains over {wire}, but the "
                f"group's backend is {backend!r}")
        if compression not in (None, "bf16"):
            raise ValueError(f"unknown compression {compression!r} (only "
                             "'bf16' is supported)")
        self.group = group
        self.compression = compression
        self._arp: Optional[AllReduceParameter] = None
        self._slot_shards: Dict[str, torch.Tensor] = {}

    def set_mesh(self, mesh) -> "DistriOptimizer":
        raise NotImplementedError(
            "the port's DistriOptimizer is data-parallel over a process "
            "group: meshes with seq/model/expert axes (sequence, tensor and "
            "expert parallelism) are not ported yet")

    # ---- the step ----------------------------------------------------------

    def _step(self, params, flat, row, slots, mstate, edges, guard,
              inputs, targets, hyper) -> torch.Tensor:
        """One data-parallel step; returns the loss averaged over the
        ranks (NaN when the guard skipped the update).  ``row`` is this
        rank's slice of ``flat``, ``slots`` its slot shards, ``edges``
        the column buckets (None: the one-block schedule)."""
        arp, group = self._arp, self.group
        n = arp.n_shards
        saved = [b.clone() for b in mstate] if guard else []
        out = mixed_precision_forward(self.model, inputs, self.precision)
        loss = self.criterion.apply(out, targets)
        penalty = regularization_penalty(self.model)
        if penalty is not None:
            loss = loss + penalty
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad():
            loss = loss.detach()
            flat_grads = arp.flatten([torch.zeros_like(p) if g is None else g
                                      for g, p in zip(grads, params)])
            del grads
            if edges is None:
                issued = [(0, arp.shard_size, arp.reduce_scatter_gradients(
                    flat_grads, async_op=True))]
            else:
                gmat = flat_grads.view(n, arp.shard_size)
                issued = [(a, b, arp.reduce_scatter_bucket(
                    gmat[:, a:b], async_op=True)) for a, b in edges]
            grad_b, updates = [], []
            for a, b, pending in issued:
                g_k = pending.wait() / n
                grad_b.append(g_k)
                updates.append(self.optim_method.pure_update(
                    [g_k], [row[a:b]],
                    {k: [v[a:b]] for k, v in slots.items()}, hyper))
            ok = True
            if guard:
                # the verdict is global: each rank sees 1/N of the
                # gradient, and ranks applying different verdicts would
                # fork the model
                ok = axis_min(all_finite(loss, grad_b).to(torch.int32),
                              group).bool()
            gathers = []
            for (a, b, _), (p_k, s_k) in zip(issued, updates):
                select_tree(ok, p_k, [row[a:b]])
                select_tree(ok, s_k, {k: [v[a:b]] for k, v in slots.items()})
                if edges is not None:
                    gathers.append((a, b, arp.all_gather_bucket(
                        row[a:b], async_op=True)))
            if guard:
                for live, kept in zip(mstate, saved):
                    torch.where(ok, live, kept, out=live)
                loss = torch.where(ok, loss, torch.full_like(loss, math.nan))
            if edges is None:
                arp.all_gather_weights(row, flat)    # in place
            else:
                fmat = flat.view(n, arp.shard_size)
                for a, b, pending in gathers:
                    fmat[:, a:b].copy_(pending.wait())
            loss = axis_mean(loss, group)
            pmean_floats(mstate, group)
        return loss

    # ---- the training loop -------------------------------------------------

    def _flat_slots(self, params, rank: int) -> Dict[str, torch.Tensor]:
        """This rank's 1/N shard of each slot family: the
        ``OptimMethod``'s fresh slots, or its per-parameter ones (from a
        ``LocalOptimizer`` or an earlier ``optimize()``) flattened."""
        arp, om = self._arp, self.optim_method
        cached = om._slots
        if cached is None:
            zeros = torch.zeros(arp.shard_size, dtype=arp.dtype,
                                device=self.device)
            return {k: v[0] for k, v in om.init_slots([zeros]).items()}
        cached = map_over_slots(om, _same_shape, cached, params)
        return {k: arp.local_shard(arp.flatten(v), rank).clone()
                for k, v in cached.items()}

    def _publish_slots(self) -> None:
        """All-gather the slot shards and hand them back per parameter
        (the twin of the JAX package's ``publish``, :790-810)."""
        arp = self._arp
        full = {k: arp.all_gather_weights(
                    v, v.new_empty(arp.padded_size))
                for k, v in self._slot_shards.items()}
        self.optim_method.set_slots({k: arp.unflatten(v)
                                     for k, v in full.items()})

    def _optimize(self) -> torch.nn.Module:
        group = self.group
        n = dist.get_world_size(group)
        if self.dataset.partition_num != n:
            raise ValueError(
                f"dataset has {self.dataset.partition_num} partitions but "
                f"the process group has {n} ranks: they must match "
                "(reference DistriOptimizer.scala:492)")
        refuse_unported()
        if (config.get_bool("bigdl.chaos.extraAllGather", False) or
                config.get_property("bigdl.chaos.dropBucketCollective")
                not in (None, "")):
            raise NotImplementedError(
                "bigdl.chaos.extraAllGather/dropBucketCollective: the "
                "audit's fault injection is not ported yet")
        rank = dist.get_rank(group)
        local = local_data_partitions(group)
        missing = [p for p in local
                   if p not in self.dataset.local_partitions]
        if missing:
            raise ValueError(
                f"rank {rank} feeds partitions {missing}, which the "
                f"dataset does not hold: build ShardedDataSet(..., "
                f"local_partitions={local}) on this rank")
        model = self.model
        model.train()
        params = list(model.parameters())
        self._arp = arp = AllReduceParameter(params, n, self.compression,
                                             group)
        flat = arp.bind(params)
        row = arp.local_shard(flat, rank)
        self._slot_shards = slots = self._flat_slots(params, rank)
        mstate = module_state(model)
        self.optim_method.state.setdefault("epoch", 1)
        guard = config.get_bool("bigdl.divergence.guard", True)
        edges = (arp.bucket_edges(
                     config.get_int("bigdl.parallel.overlapBuckets", 4))
                 if config.get_bool("bigdl.parallel.overlap", True)
                 else None)
        stream = (torch.Generator(device=self.device)
                  if is_stochastic(model) else None)
        it = {"shards": None}

        def reset_epoch():
            self.dataset.shuffle()
            it["shards"] = {p: self.dataset.shard_data(p, train=True)
                            for p in local}

        def fetch_batch():
            return _global_batch(it["shards"], self.dataset.partition_num,
                                 self.device)

        def run_step(inputs, targets, hyper, seed):
            args = (params, flat, row, slots, mstate, edges, guard, inputs,
                    targets, hyper)
            if stream is None:
                return self._step(*args)
            stream.manual_seed(_rank_seed(seed, rank))
            with random_stream(model, stream):
                return self._step(*args)

        self._sync_dataset_epoch()
        reset_epoch()
        self._drive(fetch_batch, run_step, reset_epoch,
                    epoch_size=self.dataset.size())
        self._publish_slots()
        return model


def _global_batch(shard_iters, partition_num: int, device: torch.device):
    """One minibatch from each local partition (ascending), joined along
    the batch axis and moved to ``device``; the record count is the global
    batch's (epoch accounting is global)."""
    batches = [next(shard_iters[p]) for p in sorted(shard_iters)]
    sizes = {b.size() for b in batches}
    if len(sizes) != 1:
        raise ValueError(
            f"local partitions yielded unequal minibatch sizes "
            f"{sorted(sizes)}: SampleToMiniBatch(batch, partition_num) "
            "must split evenly across partitions")
    inputs = _cat([b.get_input() for b in batches])
    targets = _cat([b.get_target() for b in batches])
    return (_to_device(inputs, device), _to_device(targets, device),
            sizes.pop() * partition_num)


def _cat(parts):
    first = parts[0]
    if isinstance(first, (list, tuple)):
        return [_cat([p[i] for p in parts]) for i in range(len(first))]
    if len(parts) == 1:
        return np.asarray(first)
    return np.concatenate([np.asarray(p) for p in parts], axis=0)
