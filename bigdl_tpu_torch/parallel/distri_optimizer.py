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

Validation and checkpoints (JAX ``optimizer.py`` :1469-1532, :785-820):
each rank scores its own partitions of a ``ShardedDataSet`` and the
partial sums are all-reduced (:func:`~bigdl_tpu_torch.optim.evaluator.
evaluate_dataset`).  Before a snapshot every rank all-gathers the slot
shards into full slots (the publish); rank 0 alone writes; its error is
shared with every rank as a flag, so all raise the same error and restore
together; a barrier stands before the restore's scan.  The snapshot holds
full slots, so a restore onto another world size re-slices them
(``bigdl.elastic.reshardOnRestore``; off, it raises
``TopologyMismatchError``).

Telemetry (JAX :302-303, :780-863, :1078): the ``Parallel/overlap_buckets``
summary gauge, the spans ``parallel/reduce_scatter`` (the buckets' issue),
``parallel/update`` (a bucket's wait and update) and ``parallel/all_gather``
inside the step's ``driver/device_step``, and the MFU count of
:class:`~bigdl_tpu_torch.optim.optimizer.Optimizer`'s loop, which counts
this rank's step (its collectives add no FLOPs).  With NCCL a wait only
orders the current stream, so the spans show the host's enqueue; with gloo
it blocks.  Summaries, the trace and the snapshot are rank 0's alone.

Meshes (:meth:`DistriOptimizer.set_mesh`, an
:meth:`Engine.create_mesh <bigdl_tpu_torch.engine.Engine.create_mesh>` over
the group; JAX :221-256).  A ``("data", "expert")`` mesh is the dp x ep step
(JAX :258-337): every ``MixtureOfExperts`` is wired to the ``expert`` axis
(:meth:`_wire_expert_parallel`), rank (d, e) feeds partition d and takes
block e of its rows, the step runs with the axis bound, so each rank runs
its expert block on the tokens every rank of its ``expert`` line routed to
it, and the flat step above runs over all ``data x expert`` ranks (the sum
over the ``expert`` axis and the reduce-scatter over ``data`` are one
reduce-scatter over both; slots 1/(data x expert)).  A ``("data",
"model")`` mesh is the dp x tp step, the counterpart of the JAX package's
GSPMD step (:892-1050; :meth:`_optimize_tp`): each rank keeps its
``model`` block of the split weights (``tensor_parallel.tp_shard_params``)
and trains them under the bound axis; the gradients are averaged over the
``data`` subgroup per parameter and the update runs ZeRO-1 over that
subgroup along the dim ``zero1_slot_specs`` gives each slot.  Validation,
``predict``, snapshots and the end of ``optimize()`` see the whole model
and canonical, unsharded slots (the blocks are gathered at each publish),
so a restore onto another mesh re-slices them.  A ``("data", "seq")`` mesh
is the dp x sp step (JAX :239-242, :263-337, :1160-1190): every
``MultiHeadAttention`` and ``PositionalEncoding`` is wired to the ``seq``
axis (:meth:`_wire_sequence_parallel`; a time-mixing module raises), rank
(d, s) feeds partition d and takes time block s of its rows, and the step
runs with the axis bound, so the attention runs as the ring
(:mod:`bigdl_tpu_torch.parallel.ring_attention`) and each shard reads its
rows of the position table.  As for ``expert``, the flat step runs over all
``data x seq`` ranks: its one reduce-scatter holds the JAX package's sum
over ``seq`` and its ZeRO-1 reduce-scatter over ``data``, divided by the
rank count (slots 1/(data x seq)).

Integrity (JAX :273-541, :679-696, :757, :821-873), with
``bigdl.integrity.everyN`` > 0: at the top of each step every rank
fingerprints its own copy of the flat parameter vector and its slot shards,
the ranks all-gather the parameter fingerprints into the agreement table,
and each checks continuity against its own carry with the agreement folded
in; the global minimum of the ranks' verdicts freezes the step on every
rank, and a frozen step keeps each rank's input copy bit for bit (the
all-gather's result is discarded), so the evidence survives for the vote.
The loop reads the verdicts every N steps (:class:`~bigdl_tpu_torch.
integrity.DriverIntegrity` with its weight-health gates): a disagreement
raises :class:`~bigdl_tpu_torch.integrity.ReplicaDesyncError` naming the
minority ranks, and the trainer heals in place (:meth:`_heal_desync`): the
majority's copy (:func:`~bigdl_tpu_torch.integrity.majority_split`: a tie
goes to the lowest rank's) is broadcast to every rank, the eval counter is
rewound to before the first frozen step, and the retry loop re-enters
without a restore; the ZeRO-1 slot shards, each verified by its own rank's
continuity, stay.  A continuity break alone raises ``IntegrityError``,
answered by a restore.  The chaos injectors ``bitflipParamAt`` ("k:r":
rank r flips a bit of its copy between steps) and ``desyncReplicaAt``
("k:r": rank r adds 1.0 to its copy after step k's update) act here.
The dp x tp step has no fingerprints: the integrity and replica
injectors raise :class:`NotImplementedError` there.

Not ported, each raising :class:`NotImplementedError` where asked for: the
audit fault injections (``bigdl.chaos.extraAllGather``,
``bigdl.chaos.dropBucketCollective``) and what ``LocalOptimizer`` lacks
(:mod:`bigdl_tpu_torch.optim.optimizer`).  A device OOM in the step is
fatal here (the microbatch re-plan is ``LocalOptimizer``'s, as in the JAX
package).  Batches come through the trainers' shared loop and its
prefetcher (``bigdl.prefetch.depth``), which joins the local partitions'
minibatches on its producer thread.
"""

from __future__ import annotations

import contextlib
import logging
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch import integrity, telemetry
from bigdl_tpu_torch.dataset.dataset import ShardedDataSet
from bigdl_tpu_torch.engine import DeviceLike, Mesh, bind_axes
from bigdl_tpu_torch.nn.module import (Criterion, grad_scales, is_stochastic,
                                       random_stream)
from bigdl_tpu_torch.optim.optimizer import (Optimizer, close_iterators,
                                             all_finite,
                                             mixed_precision_forward,
                                             module_state, refuse_keys,
                                             refuse_unported,
                                             select_tree)
from bigdl_tpu_torch.parallel.all_reduce import (AllReduceParameter,
                                                 axis_mean, axis_min,
                                                 axis_sum,
                                                 gather_fingerprints,
                                                 pmean_floats)
from bigdl_tpu_torch.resources.device import classify_dispatch_error
from bigdl_tpu_torch.utils import chaos, config, elastic

logger = logging.getLogger("bigdl_tpu_torch")

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
    ``mesh`` (:meth:`set_mesh`) lays the group's ranks out over named
    axes.
    """

    def __init__(self, model: torch.nn.Module, dataset: ShardedDataSet,
                 criterion: Criterion,
                 group: Optional[dist.ProcessGroup] = None,
                 compression: Optional[str] = None,
                 device: DeviceLike = "cuda", mesh: Optional[Mesh] = None):
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
        self._kept_shards = None
        self._slot_shards: Dict[str, torch.Tensor] = {}
        self._mesh: Optional[Mesh] = None
        #: a dp x tp run's blocks on this rank (:meth:`_optimize_tp`)
        self.tp_shards: Optional[Dict[str, dict]] = None
        #: the smallest position capacity of a seq-mesh model
        #: (:meth:`_wire_sequence_parallel`)
        self._max_seq_len: Optional[int] = None
        if mesh is not None:
            self.set_mesh(mesh)

    def _group(self):
        return self.group

    def _group_size(self) -> int:
        return dist.get_world_size(self.group)

    def _validation_group(self):
        return self.group if self._mesh is None else \
            self._mesh.group("data")

    def _topology_meta(self):
        mesh = self._mesh
        return elastic.describe_topology(
            dist.get_world_size(self.group),
            step="tensor_parallel" if self.model_axis else "distri",
            slot_axis="data", axes=None if mesh is None else mesh.shape)

    # ---- meshes (JAX :221-256) ----------------------------------------------

    @property
    def mesh(self) -> Optional[Mesh]:
        """The named mesh over the group (None: every rank on ``data``)."""
        return self._mesh

    def set_mesh(self, mesh: Mesh) -> "DistriOptimizer":
        """Train over ``mesh``: ``("data",)``, ``("data", "expert")`` (dp x
        ep), ``("data", "seq")`` (dp x sp, ring attention) or ``("data",
        "model")`` (dp x tp).  A mesh without a ``data`` axis or with an
        unknown one raises :class:`ValueError`."""
        unknown = [a for a in mesh.axis_names
                   if a not in ("data", "model", "expert", "seq")]
        if unknown or "data" not in mesh.shape:
            raise ValueError(f"mesh axes {mesh.axis_names}: expected 'data' "
                             "with 'model', 'expert' or 'seq'")
        self._mesh = mesh
        return self

    @property
    def seq_axis(self) -> Optional[str]:
        """``"seq"`` when the mesh has that axis (dp x sp)."""
        mesh = self._mesh
        return "seq" if mesh is not None and "seq" in mesh.shape else None

    @property
    def expert_axis(self) -> Optional[str]:
        """``"expert"`` when the mesh has that axis (dp x ep)."""
        mesh = self._mesh
        return "expert" if mesh is not None and "expert" in mesh.shape \
            else None

    @property
    def model_axis(self) -> Optional[str]:
        """``"model"`` when the mesh has that axis (dp x tp)."""
        mesh = self._mesh
        return "model" if mesh is not None and "model" in mesh.shape \
            else None

    def _wire_expert_parallel(self, module: torch.nn.Module) -> None:
        """Point every ``MixtureOfExperts`` at the mesh's ``expert`` axis
        (JAX :875-890).  A dp x ep mesh without one would be plain data
        parallelism at twice the mesh: raises :class:`ValueError`."""
        from bigdl_tpu_torch.nn.moe import MixtureOfExperts
        n = self._mesh.shape["expert"]
        moes = [m for m in module.modules()
                if isinstance(m, MixtureOfExperts)]
        if not moes:
            raise ValueError(
                "mesh declares an 'expert' axis but the model has no "
                "MixtureOfExperts layer — use a ('data',) mesh")
        for m in moes:
            m.set_expert_parallel("expert", n)

    def _wire_sequence_parallel(self, module: torch.nn.Module) -> None:
        """Point every module with ``set_sequence_parallel``
        (``MultiHeadAttention``'s ring, ``PositionalEncoding``'s chunk
        offset) at the ``seq`` axis and keep the smallest ``max_seq_len``
        (JAX :1160-1190).  The ring engages only while the axis is bound,
        inside the step, so validation and ``predict`` see the whole
        sequence.  A recurrent module would restart its state at every
        chunk edge: it raises :class:`ValueError`."""
        from bigdl_tpu_torch.nn.recurrent import BiRecurrent, Recurrent
        offenders = sorted({type(m).__name__ for m in module.modules()
                            if isinstance(m, (Recurrent, BiRecurrent))})
        if offenders:
            raise ValueError(
                "sequence-parallel training (mesh with a 'seq' axis) shards "
                "the time dimension, but these modules mix information "
                f"across time with no ring path: {offenders}; train them on "
                "a ('data',)-only mesh")
        self._max_seq_len = None
        for m in module.modules():
            if hasattr(m, "set_sequence_parallel"):
                m.set_sequence_parallel(self.seq_axis)
            cap = getattr(m, "max_seq_len", None)
            if cap is not None:
                self._max_seq_len = (cap if self._max_seq_len is None
                                     else min(self._max_seq_len, cap))

    def _check_seq_batch(self, x) -> None:
        """A batch leaf of a ``seq`` mesh: (N, T, ...) with T split evenly
        over the axis and within every module's position capacity."""
        if isinstance(x, (list, tuple)):
            for t in x:
                self._check_seq_batch(t)
            return
        x = np.asarray(x)
        n_s = self._mesh.shape["seq"]
        if x.ndim < 2 or x.shape[1] % n_s != 0:
            raise ValueError(
                "sequence-parallel training needs (N, T, ...) inputs and "
                "(N, T, ...) per-timestep targets with T divisible by the "
                f"seq axis size {n_s} (got shape {x.shape})")
        cap = self._max_seq_len
        if cap is not None and x.shape[1] > cap:
            raise ValueError(
                f"sequence length {x.shape[1]} exceeds a module's position "
                f"capacity {cap} — sharded offsets would silently clamp; "
                "raise max_len")

    # ---- the step ----------------------------------------------------------

    def _step(self, params, flat, row, slots, mstate, edges, guard,
              inputs, targets, hyper, scales=None, fpc=None, tick: int = 0,
              desync=(0, 0)):
        """One data-parallel step; returns ``(loss, aux)``, the loss
        averaged over the ranks (NaN when the guard skipped the update).
        ``row`` is this rank's slice of ``flat``, ``slots`` its slot
        shards, ``edges`` the column buckets (None: the one-block
        schedule), ``scales`` the layers' gradient scales
        (:func:`grad_scales`), ``fpc`` this rank's integrity carry (None:
        off), ``desync`` the chaos injector's ``(iteration, rank)``."""
        arp, group = self._arp, self.group
        n = arp.n_shards
        aux: Dict[str, torch.Tensor] = {}
        saved = ([b.clone() for b in mstate]
                 if guard or fpc is not None else [])
        if fpc is not None:
            seed = config.get_int("bigdl.integrity.seed",
                                  integrity.DEFAULT_SEED)
            with torch.no_grad():
                # each rank hashes its own copy of the replicated vector
                # and its own slot shards
                fp_p_in = integrity.fingerprint_flat(flat, seed)
                fp_s_in = integrity.fingerprint_tree(
                    slots, seed + integrity.SLOT_SEED_OFF)
                fps_table = gather_fingerprints(fp_p_in, group)
                agree_ok = (fps_table == fps_table[0]).all()
                _, latch, bad_iter = integrity.continuity_check(
                    fpc, fp_p_in, fp_s_in, tick, extra_ok=agree_ok)
                # the freeze is global: one latched rank freezing alone
                # would fork the model
                intact = axis_min((latch == 0).to(torch.int32),
                                  group).bool()
                old_row = row.clone()
        out = mixed_precision_forward(self.model, inputs, self.precision)
        loss = self._loss(out, targets)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad():
            loss = loss.detach()
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, params)]
            if scales is not None:
                grads = [g if s == 1.0 else g * s
                         for g, s in zip(grads, scales)]
            flat_grads = arp.flatten(grads)
            del grads
            with telemetry.span("parallel/reduce_scatter",
                                buckets=1 if edges is None else len(edges)):
                if edges is None:
                    issued = [(0, arp.shard_size,
                               arp.reduce_scatter_gradients(
                                   flat_grads, async_op=True))]
                else:
                    gmat = flat_grads.view(n, arp.shard_size)
                    issued = [(a, b, arp.reduce_scatter_bucket(
                        gmat[:, a:b], async_op=True)) for a, b in edges]
            grad_b, updates = [], []
            for k_, (a, b, pending) in enumerate(issued):
                with telemetry.span("parallel/update", bucket=k_):
                    g_k = pending.wait() / n
                    grad_b.append(g_k)
                    updates.append(self.optim_method.pure_update(
                        [g_k], [row[a:b]],
                        {k: [v[a:b]] for k, v in slots.items()}, hyper))
            ok = okf = True
            if guard:
                # the verdict is global: each rank sees 1/N of the
                # gradient, and ranks applying different verdicts would
                # fork the model; the first non-finite bucket rides along
                _, nf = integrity.first_nonfinite(loss, grad_b)
                okf = all_finite(loss, grad_b)
                verdict = axis_min(torch.stack([okf.to(torch.int64), nf]),
                                   group)
                ok = okf = verdict[0].bool()
                aux["nf"] = verdict[1]
            if fpc is not None:
                ok = intact if ok is True else ok & intact
            self._torn = True
            gathers = []
            for (a, b, _), (p_k, s_k) in zip(issued, updates):
                select_tree(ok, p_k, [row[a:b]])
                select_tree(ok, s_k, {k: [v[a:b]] for k, v in slots.items()})
                if edges is not None:
                    gathers.append((a, b, arp.all_gather_bucket(
                        row[a:b], async_op=True)))
            if ok is not True:
                for live, kept in zip(mstate, saved):
                    torch.where(ok, live, kept, out=live)
            if okf is not True:
                # only the finiteness verdict poisons the loss
                loss = torch.where(okf, loss,
                                   torch.full_like(loss, math.nan))
            with telemetry.span("parallel/all_gather"):
                # under integrity a frozen step keeps each rank's input
                # copy bit for bit: the gather would wash a diverged copy
                # back into agreement and destroy the vote's evidence
                if edges is None:
                    if fpc is None:
                        arp.all_gather_weights(row, flat)    # in place
                    else:
                        gathered = arp.all_gather_weights(
                            row, torch.empty_like(flat))
                        torch.where(ok, gathered, flat, out=flat)
                else:
                    fmat = flat.view(n, arp.shard_size)
                    for a, b, pending in gathers:
                        block = pending.wait()
                        if fpc is not None:
                            block = torch.where(ok, block, fmat[:, a:b])
                        fmat[:, a:b].copy_(block)
            self._torn = False
            if fpc is not None:
                if desync[0] and tick == desync[0] and \
                        dist.get_rank(group) == desync[1] % n:
                    # chaos: this rank's copy drifts after the update; its
                    # own output fingerprint hashes the drifted copy, so
                    # only the next step's agreement table sees it
                    flat[0] += 1.0
                aux.update(self._integrity_aux(
                    flat, row, old_row, slots, grad_b, edges, seed, latch,
                    bad_iter, intact, fps_table))
            loss = axis_mean(loss, group)
            pmean_floats(mstate, group)
        return loss, aux

    def _integrity_aux(self, flat, row, old_row, slots, grad_b, edges,
                       seed, latch, bad_iter, intact, fps_table) -> dict:
        """The step's integrity verdicts, output fingerprints, carry and
        norms; one all-reduce carries every norm (the shards partition
        the vector, so their sums are the global squares)."""
        group = self.group
        fp_p_out = integrity.fingerprint_flat(flat, seed)
        fp_s_out = integrity.fingerprint_tree(
            slots, seed + integrity.SLOT_SEED_OFF)
        edges = edges or [(0, self._arp.shard_size)]
        new64, old64 = row.to(torch.float64), old_row.to(torch.float64)
        pb = torch.stack([(new64[a:b] ** 2).sum() for a, b in edges])
        ub = torch.stack([((new64[a:b] - old64[a:b]) ** 2).sum()
                          for a, b in edges])
        nb = len(edges)
        stats = axis_sum(torch.cat([pb, ub,
                                    integrity.sq_norm(grad_b)[None]]),
                         group)
        return dict(
            cont=(~intact).to(torch.int32),
            bad_iter=-axis_min(-bad_iter.clone(), group),
            fps_all=fps_table, pn=stats[:nb].sum(),
            un=stats[nb:2 * nb].sum(), gn=stats[2 * nb], pb=stats[:nb],
            ub=stats[nb:2 * nb],
            fpc=integrity.pack_carry(latch, bad_iter, fp_p_out, fp_s_out))

    # ---- the training loop -------------------------------------------------

    def _flat_slots(self, params, rank: int) -> Dict[str, torch.Tensor]:
        """This rank's 1/N shard of each slot family: the live shards a
        failed attempt left (:meth:`_optimize`), unless the method's slots
        were replaced since (a restore); else the ``OptimMethod``'s fresh
        slots, or its per-parameter ones (from a ``LocalOptimizer`` or an
        earlier ``optimize()``) flattened."""
        arp, om = self._arp, self.optim_method
        kept, self._kept_shards = self._kept_shards, None
        if (kept is not None and kept[0] is om and kept[1] is om._slots
                and all(v.numel() == arp.shard_size
                        for v in kept[2].values())):
            return kept[2]
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

    def _check_run(self) -> List[int]:
        """The checks every run makes before its first step; returns the
        partitions this rank feeds."""
        group, mesh = self.group, self._mesh
        n = dist.get_world_size(group)
        if mesh is not None and mesh.size != n:
            raise ValueError(f"mesh of {mesh.size} ranks over a process "
                             f"group of {n}")
        n_data = n if mesh is None else mesh.shape["data"]
        if self.dataset.partition_num != n_data:
            raise ValueError(
                f"dataset has {self.dataset.partition_num} partitions but "
                f"the {'process group' if mesh is None else 'data axis'} "
                f"has {n_data} ranks: they must match "
                "(reference DistriOptimizer.scala:492)")
        refuse_unported()
        local = (local_data_partitions(group) if mesh is None
                 else [mesh.coord("data")])
        missing = [p for p in local
                   if p not in self.dataset.local_partitions]
        if missing:
            raise ValueError(
                f"rank {dist.get_rank(group)} feeds partitions {missing}, "
                f"which the dataset does not hold: build "
                f"ShardedDataSet(..., local_partitions={local}) on this "
                "rank")
        return local

    def _optimize(self) -> torch.nn.Module:
        if self.model_axis:
            # the JAX package's refusals (distri_optimizer.py:626-645)
            if self.expert_axis or self.seq_axis:
                raise ValueError(
                    "the tensor-parallel step composes with 'data' only — "
                    "a mesh mixing 'model' with 'seq'/'expert' is not "
                    "supported")
            if self.compression:
                raise ValueError(
                    "compression='bf16' is the wire of the data-parallel "
                    "step's reduce-scatter; the tensor-parallel ('model') "
                    "step has no such wire — drop compression for this "
                    "mesh (set_precision('bf16') already keeps the "
                    "activations and backward matmuls in bf16)")
            return self._optimize_tp()
        group, mesh = self.group, self._mesh
        n = dist.get_world_size(group)
        local = self._check_run()
        rank = dist.get_rank(group)
        model = self.model
        if self.seq_axis:
            self._wire_sequence_parallel(model)
        if self.expert_axis:
            self._wire_expert_parallel(model)
        axes = [a for a in (self.seq_axis, self.expert_axis) if a]
        n_e = mesh.shape["expert"] if self.expert_axis else 1
        e = mesh.coord("expert") if self.expert_axis else 0
        n_s = mesh.shape["seq"] if self.seq_axis else 1
        s_ = mesh.coord("seq") if self.seq_axis else 0
        model.train()
        params = list(model.parameters())
        self._arp = arp = AllReduceParameter(params, n, self.compression,
                                             group)
        flat = arp.bind(params)
        row = arp.local_shard(flat, rank)
        self._slot_shards = slots = self._flat_slots(params, rank)
        mstate = module_state(model)
        scales = grad_scales(model, params)
        self.optim_method.state.setdefault("epoch", 1)
        guard = config.get_bool("bigdl.divergence.guard", True)
        edges = (arp.bucket_edges(
                     config.get_int("bigdl.parallel.overlapBuckets", 4))
                 if config.get_bool("bigdl.parallel.overlap", True)
                 else None)
        telemetry.gauge(
            "Parallel/overlap_buckets", summary=True,
            help="per-step collective buckets (1 = monolithic schedule)"
        ).set(float(len(edges) if edges else 1))
        stream = (torch.Generator(device=self.device)
                  if is_stochastic(model) else None)
        every_n = config.get_int("bigdl.integrity.everyN", 0)
        integ = None
        if guard or every_n > 0:
            integ = integrity.DriverIntegrity(
                "distri", ["loss"] + [f"grad:bucket{i}" for i in
                                      range(len(edges) if edges else 1)],
                every_n=every_n,
                health=integrity.WeightHealthMonitor(
                    config.get_float("bigdl.integrity.healthFactor", 0.0),
                    warmup=config.get_int("bigdl.integrity.healthWarmup", 5),
                    cooldown=config.get_int(
                        "bigdl.integrity.healthCooldown", 50)))
        carry = {"fpc": integrity.init_carry(self.device)
                 if every_n > 0 else None}
        desync = chaos.desync_replica()
        it = {"shards": None}

        def reset_epoch():
            self.dataset.shuffle()
            it["shards"] = {p: self.dataset.shard_data(p, train=True)
                            for p in local}

        def fetch_batch():
            inputs, targets, count = _global_batch(
                it["shards"], self.dataset.partition_num)
            if n_e > 1:
                # tokens co-shard over the expert axis: block e of the rows
                inputs, targets = (_block(x, e, n_e)
                                   for x in (inputs, targets))
            if self.seq_axis:
                # time (dim 1) over the seq axis: block s of every row
                for x in (inputs, targets):
                    self._check_seq_batch(x)
                inputs, targets = (_block(x, s_, n_s, dim=1)
                                   for x in (inputs, targets))
            return inputs, targets, count

        def step(inputs, targets, hyper, seed):
            args = (params, flat, row, slots, mstate, edges, guard, inputs,
                    targets, hyper, scales, carry["fpc"],
                    self.optim_method.state.get("evalCounter", 0) + 1,
                    desync)
            with bind_axes(mesh, axes) if axes else \
                    contextlib.nullcontext():
                if stream is None:
                    return self._step(*args)
                stream.manual_seed(_rank_seed(seed, rank))
                with random_stream(model, stream):
                    return self._step(*args)

        def run_step(inputs, targets, hyper, seed):
            if chaos.active():
                flip = chaos.take_bitflip()
                if flip is not None:
                    # injected corruption of one rank's copy between steps
                    integrity.bitflip_one_replica(flat, flip, rank, n)
            oom = None
            try:
                if chaos.active():
                    chaos.take_oom_dispatch("distri")
                loss, aux = step(inputs, targets, hyper, seed)
            except Exception as e:  # noqa: BLE001 re-raised unless an OOM
                oom = classify_dispatch_error(e, "distri", self.device)
                if oom is None:
                    raise
            if oom is not None:
                raise oom
            if "fpc" in aux:
                carry["fpc"] = aux["fpc"]
            return loss, aux

        run_step = self._arm_retrace(run_step, "shard_map")
        self._sync_dataset_epoch()
        reset_epoch()
        try:
            self._drive(fetch_batch, run_step, reset_epoch,
                        epoch_size=self.dataset.size(),
                        publish=self._publish_slots, integrity=integ)
        except BaseException as e:
            # the weights and statistics stay live in the model; keep the
            # slot shards beside them, so that a retry with nothing to
            # restore goes on from one consistent step
            self._kept_shards = (self.optim_method,
                                 self.optim_method._slots, slots)
            if isinstance(e, integrity.ReplicaDesyncError):
                self._heal_desync(e, flat)
            raise
        finally:
            close_iterators(self.prefetcher, it["shards"].values())
        self._publish_slots()
        return model

    def _heal_desync(self, err, flat: torch.Tensor) -> None:
        """Heal a replica desync in place (JAX :829-873): the ranks vote on
        their copies' fingerprints (:func:`~bigdl_tpu_torch.integrity.
        majority_split`), the first rank of the majority broadcasts its
        copy to all, the eval counter is rewound to just before the first
        frozen step (the verdict froze every rank the moment the copies
        diverged, so the majority's copy is the last healthy state), and
        the error is marked ``healed`` for the retry loop.  The slot shards
        are each rank's own, verified by its continuity: they stay."""
        t0 = time.monotonic()
        group = self.group
        seed = config.get_int("bigdl.integrity.seed", integrity.DEFAULT_SEED)
        with torch.no_grad():
            table = gather_fingerprints(
                integrity.fingerprint_flat(flat, seed), group)
            minority, _ = integrity.replicated_shard_disagreement(
                list(table))
            major = next(i for i in range(table.shape[0])
                         if i not in minority)
            src = major if group is None else \
                dist.get_global_rank(group, major)
            dist.broadcast(flat, src=src, group=group)
        self.optim_method.state["evalCounter"] = max(
            (err.iteration or 1) - 1, 0)
        telemetry.gauge(
            "Integrity/heal_ms",
            help="detection-to-heal latency of the last integrity fault "
                 "(restore or re-broadcast)").set(
            (time.monotonic() - t0) * 1000.0)
        logger.warning(
            "Healed replica desync at iteration %s: broadcast rank %d's "
            "copy over minority replica(s) %s and rewound to iteration %d",
            err.iteration, major, list(err.replicas),
            self.optim_method.state["evalCounter"])
        err.healed = True

    # ---- dp x tp: the Megatron step (JAX _optimize_gspmd :892-1050) ---------

    def _optimize_tp(self) -> torch.nn.Module:
        """Train over a ``("data", "model")`` mesh.  Each rank holds its
        ``model`` block of every split weight (``tp_specs``; fresh tensors
        the step trains, the model's own replicated parameters beside
        them) and the ``data`` block of each of their slots along the dim
        ``zero1_slot_specs`` gives it (none: the slot is whole on every
        ``data`` rank).  A step: the forward and backward with the
        ``model`` axis bound (the Megatron pairs' all-reduces), then per
        parameter the gradient's mean over the ``data`` subgroup (a
        reduce-scatter along the slot dim, else an all-reduce), the
        update of this rank's block, the global divergence verdict, and
        the all-gather of the updated blocks.  :meth:`_publish_tp` gathers
        the model and canonical slots for validation, snapshots and the
        end of the run."""
        from bigdl_tpu_torch.nn.attention import MultiHeadAttention
        from bigdl_tpu_torch.nn.linear import Linear
        from bigdl_tpu_torch.parallel.tensor_parallel import (
            named_specs, split_dim, tp_shard_params, zero1_slot_specs)
        mesh, group, model = self._mesh, self.group, self.model
        local = self._check_run()
        refuse_keys(("bigdl.integrity.everyN", "bigdl.chaos.bitflipParamAt",
                     "bigdl.chaos.desyncReplicaAt", "bigdl.chaos.oomStepAt"),
                    "the dp x tp step has no integrity fingerprints, replica "
                    "injectors or OOM classification yet")
        specs = named_specs(model, "model", mesh)
        for m in model.modules():
            if isinstance(m, MultiHeadAttention):
                m.set_model_parallel("model")
            elif isinstance(m, Linear) and m._tp:
                m.model_parallel = "model"
        n_d, c_d, g_d = (mesh.shape["data"], mesh.coord("data"),
                         mesh.group("data"))
        model.train()
        names = [k for k, _ in model.named_parameters()]
        full = [p for _, p in model.named_parameters()]
        split = [split_dim(specs[k], "model") for k in names]
        split_names = {k for k, d in zip(names, split) if d is not None}
        slot_specs = zero1_slot_specs(
            {k: tuple(p.shape) for k, p in zip(names, full)}, specs, n_d)
        sdims = [split_dim(slot_specs[k], "data") for k in names]
        om = self.optim_method
        kept, self._kept_shards = self._kept_shards, None
        if kept is not None and kept[0] is om and kept[1] is om._slots:
            live, slots = kept[2], kept[3]
        else:
            blocks = tp_shard_params(model, mesh, specs)
            live = [blocks[k].requires_grad_() if k in blocks else p
                    for k, p in zip(names, full)]
            slots = self._tp_slots(names, full, specs, live, sdims)

        #: this rank's blocks, the split parameters' and every slot's
        self.tp_shards = {
            "params": {k: t for k, t, d in zip(names, live, split)
                       if d is not None},
            "slots": {fam: dict(zip(names, per))
                      for fam, per in slots.items()}}

        def piece(t, k):
            return t if k is None else _block_dim(t, k, c_d, n_d)

        def publish():
            self._publish_tp(full, live, split, slots, sdims)

        mstate = module_state(model)
        scales = grad_scales(model, full)
        om.state.setdefault("epoch", 1)
        guard = config.get_bool("bigdl.divergence.guard", True)
        stream = (torch.Generator(device=self.device)
                  if is_stochastic(model) else None)
        it = {"shards": None}

        def reset_epoch():
            self.dataset.shuffle()
            it["shards"] = {p: self.dataset.shard_data(p, train=True)
                            for p in local}

        def fetch_batch():
            return _global_batch(it["shards"], self.dataset.partition_num)

        def step(inputs, targets, hyper):
            saved = [b.clone() for b in mstate] if guard else []
            with bind_axes(mesh, ["model"]):
                by_name = dict(zip(names, live))
                out = mixed_precision_forward(model, inputs, self.precision,
                                              params=by_name)
                loss = self._loss(out, targets, penalty=_split_penalty(
                    model, by_name, split_names, mesh.group("model")))
                grads = torch.autograd.grad(loss, live, allow_unused=True)
            with torch.no_grad():
                loss = loss.detach()
                grads = [torch.zeros_like(p) if g is None else g
                         for g, p in zip(grads, live)]
                if scales is not None:
                    grads = [g if sc == 1.0 else g * sc
                             for g, sc in zip(grads, scales)]
                with telemetry.span("parallel/reduce_scatter"):
                    g_b = [_mean_block(g, k, g_d, n_d)
                           for g, k in zip(grads, sdims)]
                p_b = [piece(p.detach(), k) for p, k in zip(live, sdims)]
                with telemetry.span("parallel/update"):
                    new_p, new_s = om.pure_update(g_b, p_b, slots, hyper)
                ok = True
                if guard:
                    ok = axis_min(all_finite(loss, g_b).to(torch.int32),
                                  group).bool()
                self._torn = True
                select_tree(ok, new_p, p_b)
                select_tree(ok, new_s, slots)
                with telemetry.span("parallel/all_gather"):
                    for p, b, k in zip(live, p_b, sdims):
                        if k is not None and n_d > 1:
                            p.detach().copy_(_gather_dim(b, k, g_d, n_d))
                self._torn = False
                if guard:
                    for live_b, kept_b in zip(mstate, saved):
                        torch.where(ok, live_b, kept_b, out=live_b)
                    loss = torch.where(ok, loss,
                                       torch.full_like(loss, math.nan))
                loss = axis_mean(loss, group)
                pmean_floats(mstate, group)
            return loss

        def run_step(inputs, targets, hyper, seed):
            if stream is None:
                return step(inputs, targets, hyper)
            # the model ranks of a data row share their masks
            stream.manual_seed(_rank_seed(seed, c_d))
            with random_stream(model, stream):
                return step(inputs, targets, hyper)

        run_step = self._arm_retrace(run_step, "gspmd")
        self._sync_dataset_epoch()
        reset_epoch()
        try:
            self._drive(fetch_batch, run_step, reset_epoch,
                        epoch_size=self.dataset.size(), publish=publish)
        except BaseException:
            self._kept_shards = (om, om._slots, live, slots)
            raise
        finally:
            close_iterators(self.prefetcher, it["shards"].values())
        publish()
        return model

    def _tp_slots(self, names, full, specs, live, sdims
                  ) -> Dict[str, List[torch.Tensor]]:
        """This rank's slot blocks: the method's canonical per-parameter
        slots (a restore, an earlier run) cut to this rank's ``model``
        and ``data`` blocks (``sdims``: each slot's ``data`` dim), else
        fresh ones."""
        from bigdl_tpu_torch.parallel.tensor_parallel import local_slice
        mesh, om = self._mesh, self.optim_method
        n_d, c_d = mesh.shape["data"], mesh.coord("data")
        n_m, c_m = mesh.shape["model"], mesh.coord("model")
        if om._slots is None:
            return om.init_slots([t.detach() if k is None else
                                  _block_dim(t.detach(), k, c_d, n_d)
                                  for t, k in zip(live, sdims)])
        canon = map_over_slots(om, _same_shape, om._slots, full)
        out = {}
        for fam, per in canon.items():
            blocks = []
            for name, s_full, k in zip(names, per, sdims):
                b = local_slice(s_full.to(self.device), specs[name],
                                "model", n_m, c_m)
                if k is not None:
                    b = _block_dim(b, k, c_d, n_d)
                blocks.append(b.clone())
            out[fam] = blocks
        return out

    def _publish_tp(self, full, live, split, slots, sdims) -> None:
        """Gather the whole model into its own parameters and the
        canonical slots into the method (the twin of ``publish``):
        ``split`` and ``sdims`` are each parameter's ``model`` dim and
        its slots' ``data`` dim."""
        mesh = self._mesh
        n_d, g_d = mesh.shape["data"], mesh.group("data")
        n_m, g_m = mesh.shape["model"], mesh.group("model")
        with torch.no_grad():
            for p, t, d in zip(full, live, split):
                if d is not None:
                    p.copy_(_gather_dim(t.detach(), d, g_m, n_m))
            canon = {}
            for fam, per in slots.items():
                out = []
                for s_b, k, d in zip(per, sdims, split):
                    if k is not None:
                        s_b = _gather_dim(s_b, k, g_d, n_d)
                    if d is not None:
                        s_b = _gather_dim(s_b, d, g_m, n_m)
                    out.append(s_b.clone())
                canon[fam] = out
        self.optim_method.set_slots(canon)


def _split_penalty(model: torch.nn.Module, params: Dict[str, torch.Tensor],
                   split: set, group) -> Optional[torch.Tensor]:
    """The layers' regularizer penalties over ``params`` (by parameter
    name), some of them this rank's blocks of weights split over
    ``group`` (the names in ``split``): the whole model's penalty in value
    (the blocks' terms summed over the group), and in gradient each
    block's own term (the JAX GSPMD step's ``regularization_penalty`` over
    its sharded parameters).  None when no layer has a regularizer."""
    whole, blocks = [], []
    for mname, m in model.named_modules():
        regs = {"weight": getattr(m, "w_regularizer", None),
                "bias": getattr(m, "b_regularizer", None)}
        if regs["weight"] is None and regs["bias"] is None:
            continue
        for k in sorted(dict(m.named_parameters(recurse=False))):
            reg = regs["bias" if k == "bias" else "weight"]
            if reg is None:
                continue
            full = f"{mname}.{k}" if mname else k
            (blocks if full in split else whole).append(
                reg.penalty([params[full]]))
    terms = whole + blocks
    if not terms:
        return None
    total = sum(terms[1:], terms[0])
    if blocks and dist.get_world_size(group) > 1:
        local = sum(blocks[1:], blocks[0]).detach()
        total = total + (axis_sum(local.clone(), group) - local)
    return total


def _block_dim(t: torch.Tensor, dim: int, i: int, n: int) -> torch.Tensor:
    """Block ``i`` of ``n`` of ``t`` along ``dim`` (a view)."""
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


def _mean_block(g: torch.Tensor, dim: Optional[int], group, n: int
                ) -> torch.Tensor:
    """The mean of ``g`` over ``group``'s ``n`` ranks: this rank's block
    along ``dim`` (a reduce-scatter), or all of it (an all-reduce) where
    ``dim`` is None."""
    if n == 1:
        return g.clone()
    if dim is None:
        t = g.contiguous().clone()
        dist.all_reduce(t, group=group)
        return t / n
    moved = g.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // n,) + tuple(moved.shape[1:]))
    dist.reduce_scatter_tensor(out, moved, group=group)
    return (out / n).movedim(0, dim)


def _gather_dim(block: torch.Tensor, dim: int, group, n: int
                ) -> torch.Tensor:
    """Every rank's ``block`` of ``group``, joined along ``dim``."""
    if n == 1:
        return block
    moved = block.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] * n,) + tuple(moved.shape[1:]))
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def _block(x, i: int, n: int, dim: int = 0):
    """Block ``i`` of ``n`` along dim ``dim`` (the batch rows, or time) of a
    host batch (nested lists of arrays)."""
    if isinstance(x, (list, tuple)):
        return [_block(t, i, n, dim) for t in x]
    x = np.asarray(x)
    if x.shape[dim] % n:
        raise ValueError(f"a batch of {x.shape[dim]} along dim {dim} does "
                         f"not split over an axis of {n} ranks")
    size = x.shape[dim] // n
    cut = [slice(None)] * x.ndim
    cut[dim] = slice(i * size, (i + 1) * size)
    return x[tuple(cut)]


def _global_batch(shard_iters, partition_num: int):
    """One minibatch from each local partition (ascending), joined along
    the batch axis on the host; the record count is the global batch's
    (epoch accounting is global)."""
    batches = [next(shard_iters[p]) for p in sorted(shard_iters)]
    sizes = {b.size() for b in batches}
    if len(sizes) != 1:
        raise ValueError(
            f"local partitions yielded unequal minibatch sizes "
            f"{sorted(sizes)}: SampleToMiniBatch(batch, partition_num) "
            "must split evenly across partitions")
    inputs = _cat([b.get_input() for b in batches])
    targets = _cat([b.get_target() for b in batches])
    return inputs, targets, sizes.pop() * partition_num


def _cat(parts):
    first = parts[0]
    if isinstance(first, (list, tuple)):
        return [_cat([p[i] for p in parts]) for i in range(len(first))]
    if len(parts) == 1:
        return np.asarray(first)
    return np.concatenate([np.asarray(p) for p in parts], axis=0)
