"""Pipeline parallelism: GPipe microbatching over a mesh's ``stage`` axis
(``bigdl_tpu/parallel/pipeline.py``: ``stack_stage_params`` :45,
``pipeline_shard_params`` :57, ``stage_tp_specs`` :74, ``wire_model_parallel``
:87, ``_check_block`` :106, ``pipeline_apply`` :116, ``PipelineOptimizer``
:256).

The JAX package runs the schedule as one ``lax.scan`` whose carry rotates
around the ``stage`` axis with ``ppermute``, and lets ``jax.grad`` derive
the backward.  Here a rank holds its stage's block and runs the GPipe
fill-drain schedule explicitly, one process per rank: the forward takes
microbatch i from the stage before (stage 0: from ``x``), runs the block
and sends the activation to the stage after with ``isend``; the backward
runs the microbatches again in the same order, each receiving its output's
gradient from the stage after and sending its input's gradient to the stage
before.  Both schedules live in one ``torch.autograd.Function``, so a loss
over :func:`pipeline_apply`'s output differentiates as the JAX package's
does.  The numbers are the reference's: the output is the stages run in
turn on each microbatch, concatenated (its drain-tick re-runs of stage 0
are SPMD padding whose output is never selected, and are not run here).

Replication over the ``stage`` axis, as the reference's ``axis_sum`` of the
masked last-stage output: the last stage's output is broadcast to every
stage rank, and its backward hands the head's gradient to the last stage
once (every stage rank computes the same head and loss); the gradient of
``x`` is broadcast back from stage 0, so a replicated embedding before the
pipeline gets the same gradient on every stage rank.

Scope, as in the JAX package: homogeneous blocks (each maps a microbatch to
the same shape and dtype), stateless (no BatchNorm statistics); MoE's
``aux_loss`` is collected per real microbatch execution
(``return_aux=True``).

Usage (every rank of the group)::

    mesh = Engine.create_mesh((S,), ("stage",))
    stacked = stack_stage_params([dict(b.named_parameters())
                                  for b in blocks])
    mine = pipeline_shard_params(stacked, mesh)   # this rank's stage row
    y = pipeline_apply(blocks[mesh.coord("stage")], mine, x, n_micro=M,
                       mesh=mesh)
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.func import functional_call

from bigdl_tpu_torch import telemetry
from bigdl_tpu_torch.dataset.dataset import ShardedDataSet
from bigdl_tpu_torch.engine import DeviceLike, Engine, Mesh, bind_axes
from bigdl_tpu_torch.nn.module import (Sequential, collect_diagnostics,
                                       is_stochastic, random_stream,
                                       semantic_state_leaves)
from bigdl_tpu_torch.optim.optimizer import (Optimizer, all_finite,
                                             close_iterators,
                                             refuse_keys,
                                             refuse_unported,
                                             regularization_penalty,
                                             select_tree)
from bigdl_tpu_torch.parallel.all_reduce import (AllReduceParameter,
                                                 axis_min, axis_sum)
from bigdl_tpu_torch.utils import config, elastic

#: seed offsets of a step's three random streams (embed, stages, head)
_EMBED, _STAGES, _HEAD = 0, 1, 2


def stack_stage_params(per_stage: List[Dict[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """S per-stage parameter maps (by parameter name) stacked leaf-wise
    into one map of (S, ...) tensors."""
    return {k: torch.stack([p[k].detach() for p in per_stage])
            for k in per_stage[0]}


def unstack_stage_params(stacked: Dict[str, torch.Tensor],
                         n_stages: int) -> List[Dict[str, torch.Tensor]]:
    """The inverse of :func:`stack_stage_params`."""
    return [{k: v[i] for k, v in stacked.items()} for i in range(n_stages)]


class StageShard(dict):
    """One rank's row of a stacked parameter map (by name; with a ``model``
    axis, its block of that row), from :func:`pipeline_shard_params`;
    ``n_stages`` is the stacked map's stage count."""

    def __init__(self, params: Dict[str, torch.Tensor], n_stages: int):
        super().__init__(params)
        self.n_stages = n_stages


def _check_stages(stacked, n_stages: int, axis: str) -> None:
    got = ({stacked.n_stages} if isinstance(stacked, StageShard) else
           {int(v.shape[0]) for v in stacked.values()})
    if got - {n_stages}:
        got = got.pop() if len(got) == 1 else sorted(got)
        raise ValueError(
            f"stacked params carry {got} stages but the '{axis}' axis has "
            f"{n_stages} devices — with a mismatch each device would "
            "silently run only its first local stage")


def pipeline_shard_params(stacked: Dict[str, torch.Tensor], mesh: Mesh,
                          axis: str = "stage", specs=None) -> StageShard:
    """This rank's stage row of ``stacked`` (fresh tensors): each rank holds
    only its own stage's weights.  ``specs`` (from :func:`stage_tp_specs`)
    also cuts each weight to this rank's block over the ``model`` axis, the
    pipeline x tensor-parallel composition."""
    from bigdl_tpu_torch.parallel.tensor_parallel import P, local_slice
    n = mesh.shape[axis]
    _check_stages(stacked, n, axis)
    row = {k: v[mesh.coord(axis)] for k, v in stacked.items()}
    if specs is not None:
        tp = _tp_axis(specs, axis)
        row = {k: local_slice(v, P(*specs[k][1:]), tp, mesh.shape[tp],
                              mesh.coord(tp)) if tp else v
               for k, v in row.items()}
    return StageShard({k: v.detach().clone() for k, v in row.items()}, n)


def _tp_axis(specs, axis: str) -> Optional[str]:
    names = {e for s in specs.values() for e in s[1:] if e is not None}
    names.discard(axis)
    return names.pop() if names else None


def stage_tp_specs(block: torch.nn.Module, tp_axis: str = "model",
                   axis: str = "stage"):
    """The partition specs of a tp-tagged block's STACKED parameters (by
    name): dim 0, the stage dim, splits over ``axis`` and each parameter's
    Megatron split (:func:`~bigdl_tpu_torch.parallel.tensor_parallel.
    named_specs`) shifts right by one."""
    from bigdl_tpu_torch.parallel.tensor_parallel import P, named_specs
    return {k: P(axis, *s) for k, s in named_specs(block, tp_axis).items()}


def wire_model_parallel(block: torch.nn.Module, axis: Optional[str],
                        mesh: Optional[Mesh] = None) -> None:
    """Point every tensor-parallel module of ``block`` (each
    ``MultiHeadAttention``, each tagged ``Linear``) at the mesh axis
    ``axis`` for the explicit Megatron split (None: unwire).  A stochastic
    block raises :class:`ValueError`: a dropout mask drawn per ``model``
    rank would decorrelate over a feature-split activation."""
    from bigdl_tpu_torch.nn.attention import MultiHeadAttention
    from bigdl_tpu_torch.nn.linear import Linear
    from bigdl_tpu_torch.parallel.tensor_parallel import head_count_divisible
    if axis and is_stochastic(block):
        raise ValueError(
            "tensor-parallel pipeline stages must be deterministic "
            "(Dropout & co. would draw per-shard masks over a "
            "feature-sharded activation)")
    if axis and mesh is not None:
        head_count_divisible(block, mesh, axis)
    for m in block.modules():
        if isinstance(m, MultiHeadAttention):
            m.set_model_parallel(axis)
        elif isinstance(m, Linear) and getattr(m, "_tp", None):
            m.model_parallel = axis


def _wired(block: torch.nn.Module) -> bool:
    return any(getattr(m, "model_parallel", None) for m in block.modules())


def _check_block(block: torch.nn.Module) -> None:
    if semantic_state_leaves(block):
        raise ValueError(
            "pipeline blocks must be stateless (no BatchNorm running "
            "statistics) — the pipeline schedule cannot thread per-stage "
            "module state")


def _fold(*keys: int) -> int:
    """One 63-bit seed from several integers (the twin of nested
    ``fold_in``)."""
    h = 0x9E3779B97F4A7C15
    for k in keys:
        h = (h * 0x100000001B3 + int(k) + 0x7F4A7C15) % (2 ** 63)
    return h


class _Schedule:
    """What one rank's pipeline run needs: its block and stage, the stage
    subgroup and its neighbours' global ranks, the microbatch count, the
    bound axes for the block, and the random streams."""

    def __init__(self, block, names, mesh, axis, data_axis, n_micro,
                 training, rng, tp_axis):
        self.block, self.names, self.mesh = block, names, mesh
        self.n = mesh.shape[axis]
        self.s = mesh.coord(axis)
        self.group = mesh.group(axis)
        self.data_group = mesh.group(data_axis) if data_axis else None
        self.n_data = mesh.shape[data_axis] if data_axis else 1
        self.c_data = mesh.coord(data_axis) if data_axis else 0
        self.n_micro, self.training, self.rng = n_micro, training, rng
        self.tp_axis = tp_axis

        def peer(i):
            return dist.get_global_rank(self.group, i) if self.n > 1 else 0
        self.prev = peer(self.s - 1) if self.s > 0 else None
        self.next = peer(self.s + 1) if self.s < self.n - 1 else None
        self.first, self.last = peer(0), peer(self.n - 1)

    @contextlib.contextmanager
    def bound(self):
        """The block in ``training`` mode (the JAX package's ``apply(...,
        training=)``), with the ``model`` axis bound where it splits."""
        was = self.block.training
        self.block.train(self.training)
        try:
            with (bind_axes(self.mesh, [self.tp_axis]) if self.tp_axis
                  else contextlib.nullcontext()):
                yield
        finally:
            self.block.train(was)

    def stream(self, i: int, device):
        if self.rng is None or not self.training:
            return contextlib.nullcontext()
        g = torch.Generator(device=device)
        g.manual_seed(_fold(self.rng, self.c_data, self.s, i))
        return random_stream(self.block, g)

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        if self.n > 1:
            dist.broadcast(t, src, group=self.group)
        return t

    def stage_mean(self, t: torch.Tensor) -> torch.Tensor:
        if self.n > 1:
            dist.all_reduce(t, group=self.group)
        return t / self.n


def _data_rows(x: torch.Tensor, sch: _Schedule) -> torch.Tensor:
    rows = x.shape[0] // sch.n_data
    return x.narrow(0, sch.c_data * rows, rows)


def _gather_rows(x: torch.Tensor, sch: _Schedule) -> torch.Tensor:
    if sch.n_data == 1:
        return x
    out = x.new_empty((x.shape[0] * sch.n_data,) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=sch.data_group)
    return out


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule of one rank: ``forward(sch, x, *params) -> (out,
    aux)``, ``out`` the whole (data-replica) batch's last-stage output on
    every stage rank, ``aux`` the mean ``aux_loss`` over real microbatch
    executions, stages (and data replicas)."""

    @staticmethod
    def forward(ctx, sch: _Schedule, x, *params):
        xs = (_data_rows(x, sch) if sch.data_group is not None else x)
        micro = list(xs.chunk(sch.n_micro))
        leaves = [p.detach().requires_grad_(p.requires_grad) for p in params]
        by_name = dict(zip(sch.names, leaves))
        saved, outs, sends = [], [], []
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        has_aux = False
        with torch.enable_grad(), sch.bound():
            for i, mb in enumerate(micro):
                if sch.s == 0:
                    inp = mb.detach().requires_grad_(x.requires_grad)
                else:
                    inp = torch.empty_like(mb)
                    dist.irecv(inp, sch.prev).wait()
                    inp.requires_grad_(True)
                with sch.stream(i, x.device):
                    y = functional_call(sch.block, by_name, (inp,))
                if y.shape != inp.shape or y.dtype != inp.dtype:
                    raise ValueError(
                        f"a pipeline block maps {tuple(inp.shape)} "
                        f"{inp.dtype} to {tuple(y.shape)} {y.dtype}: "
                        "stages must keep the microbatch's shape and dtype")
                diags = collect_diagnostics(sch.block, "aux_loss")
                aux = sum(d.float() for d in diags) if diags else None
                if aux is not None:
                    has_aux = True
                    aux_sum = aux_sum + aux.detach()
                if sch.next is not None:
                    sends.append(dist.isend(y.detach().contiguous(),
                                            sch.next))
                else:
                    outs.append(y.detach())
                saved.append((inp, y, aux))
        for w in sends:
            w.wait()
        out = (torch.cat(outs) if outs else torch.empty_like(xs))
        out = sch.broadcast(out.contiguous(), sch.last)
        aux_mean = sch.stage_mean(aux_sum / sch.n_micro)
        if sch.data_group is not None:
            if sch.n_data > 1:
                dist.all_reduce(aux_mean, group=sch.data_group)
            aux_mean = aux_mean / sch.n_data
            out = _gather_rows(out, sch)
        ctx.sch, ctx.saved, ctx.leaves = sch, saved, leaves
        ctx.has_aux, ctx.x_grad = has_aux, x.requires_grad
        return out, aux_mean

    @staticmethod
    def backward(ctx, grad_out, grad_aux):
        sch, saved, leaves = ctx.sch, ctx.saved, ctx.leaves
        if sch.data_group is not None:
            grad_out = _data_rows(grad_out, sch)
        g_micro = list(grad_out.chunk(sch.n_micro))
        g_aux = None
        if ctx.has_aux:
            g_aux = grad_aux / (sch.n_micro * sch.n * sch.n_data)
        want = [p for p in leaves if p.requires_grad]
        p_grads = [torch.zeros_like(p) for p in want]
        x_parts, sends = [], []
        with sch.bound():
            for i, (inp, y, aux) in enumerate(saved):
                if sch.next is None:
                    g_y = g_micro[i]
                else:
                    g_y = torch.empty_like(y)
                    dist.irecv(g_y, sch.next).wait()
                outputs, grads = [y], [g_y]
                if aux is not None:
                    outputs.append(aux)
                    grads.append(g_aux)
                wrt = ([inp] if inp.requires_grad else []) + want
                got = torch.autograd.grad(outputs, wrt, grads,
                                          allow_unused=True)
                if inp.requires_grad:
                    g_inp, got = got[0], got[1:]
                    if g_inp is None:
                        g_inp = torch.zeros_like(inp)
                    if sch.prev is not None:
                        sends.append(dist.isend(g_inp.contiguous(),
                                                sch.prev))
                    else:
                        x_parts.append(g_inp)
                for acc, g in zip(p_grads, got):
                    if g is not None:
                        acc.add_(g)
        for w in sends:
            w.wait()
        grad_x = None
        if ctx.x_grad:
            local = (torch.cat(x_parts) if x_parts else
                     torch.empty_like(grad_out))
            grad_x = sch.broadcast(local.contiguous(), sch.first)
            if sch.data_group is not None:
                grad_x = _gather_rows(grad_x, sch)
        if sch.data_group is not None and sch.n_data > 1:
            for g in p_grads:
                dist.all_reduce(g, group=sch.data_group)
        it = iter(p_grads)
        grads = [next(it) if p.requires_grad else None for p in leaves]
        # the saved graphs are freed with the context
        ctx.saved = None
        return (None, grad_x) + tuple(grads)


def pipeline_apply(block: torch.nn.Module, stacked_params, x: torch.Tensor,
                   n_micro: int, mesh: Mesh, axis: str = "stage",
                   data_axis: Optional[str] = None, training: bool = False,
                   rng: Optional[int] = None, return_aux: bool = False,
                   param_specs=None):
    """Run the S-stage pipeline over ``x`` (batch, ...), the same on every
    rank, and return the last stage's output for the whole batch on every
    rank.  ``block`` is this rank's stage (``mesh.coord(axis)``);
    ``stacked_params`` is the stacked map of :func:`stack_stage_params`
    (this rank takes its row, and with ``param_specs`` its ``model``
    block) or this rank's :class:`StageShard`.  ``x`` splits into
    ``n_micro`` microbatches along dim 0.  Differentiable: a stage's
    parameters get that stage's gradients (its row of a stacked map).

    ``data_axis``: pp x dp on a ``("data", "stage")`` mesh; each data
    replica runs its own pipeline over its block of the batch rows
    (``n_micro`` per replica), the output is gathered over the replicas,
    and each stage's gradients are summed over them (the JAX package's
    replicated-in transpose).  ``training``/``rng``: a stochastic block
    draws a stream per (data replica, stage, microbatch) from the integer
    seed ``rng``; training one without ``rng`` raises.  ``return_aux``
    also returns the mean of the blocks' ``aux_loss`` over the real
    microbatch executions and the stages (then the data replicas): the term
    a trainer folds into its objective.  ``param_specs`` (from
    :func:`stage_tp_specs`): pp x tp on a ``("data", "stage", "model")``
    mesh, the block wired first by :func:`wire_model_parallel`."""
    n_stages = mesh.shape[axis]
    if training and rng is None and is_stochastic(block):
        raise ValueError(
            "training a stochastic pipeline block (Dropout & co.) needs "
            "an rng — without one the block would silently train "
            "without its noise")
    if data_axis is not None:
        n_data = mesh.shape[data_axis]
        if x.shape[0] % n_data != 0:
            raise ValueError(f"batch {x.shape[0]} must divide by the "
                             f"'{data_axis}' axis size {n_data}")
    _check_block(block)
    if param_specs is not None and not _wired(block):
        raise ValueError(
            "param_specs splits stage weights over a model axis but no "
            "module in the block is wired for the explicit Megatron "
            "split — call wire_model_parallel(block, axis, mesh) first")
    _check_stages(stacked_params, n_stages, axis)
    local_batch = x.shape[0] // (mesh.shape[data_axis]
                                 if data_axis is not None else 1)
    if n_micro < 1 or local_batch % n_micro != 0:
        raise ValueError(f"per-replica batch {local_batch} not divisible "
                         f"into {n_micro} microbatches")
    names = [k for k, _ in block.named_parameters()]
    tp_axis = _tp_axis(param_specs, axis) if param_specs else None
    if isinstance(stacked_params, StageShard):
        mine = [stacked_params[k] for k in names]
    else:
        from bigdl_tpu_torch.parallel.tensor_parallel import P, local_slice
        s = mesh.coord(axis)
        mine = [stacked_params[k][s] if tp_axis is None else
                local_slice(stacked_params[k][s], P(*param_specs[k][1:]),
                            tp_axis, mesh.shape[tp_axis],
                            mesh.coord(tp_axis))
                for k in names]
    sch = _Schedule(block, names, mesh, axis, data_axis, n_micro, training,
                    rng, tp_axis)
    out, aux = _Pipeline.apply(sch, x, *mine)
    return (out, aux) if return_aux else out


class PipelineOptimizer(Optimizer):
    """GPipe trainer over a ``("stage",)``, ``("data", "stage")`` or
    ``("data", "stage", "model")`` mesh (the JAX package's
    ``PipelineOptimizer``), one process per rank.

    ``blocks``: the S homogeneous stages, one a stage rank; ``embed`` and
    ``head``: optional stateless modules before and after the stack (token
    embedding, LM head), replicated on every rank.  ``model`` is
    ``Sequential(embed, *blocks, head)``.  A step: embed -> the pipeline
    (:func:`pipeline_apply`) -> head -> criterion, plus ``moe_aux_weight``
    times the blocks' ``aux_loss`` and every layer's regularizer penalty
    (each stage's on its stage rank, its value summed over the stages);
    then the gradients' mean over the ``data`` subgroup and a ZeRO-1 update:
    each rank's flat vector (embed, its stage's block, head) reduce-
    scattered over ``data``, its slice updated with the slots' 1/data
    shard, all-gathered back.  The divergence guard's verdict is the
    minimum over every rank.  With a ``model`` axis each stage's tagged
    weights split over it (:func:`stage_tp_specs`; the Megatron pairs of
    ``bigdl_tpu_torch.parallel.tensor_parallel``).

    Validation, snapshots, ``predict`` and the end of ``optimize()`` see
    the whole model and canonical slots: each publish gathers the ``model``
    blocks and broadcasts every stage's weights and slots to every rank.
    A snapshot's topology is ``describe_topology(step="pipeline",
    slot_axis="data")`` with the mesh's axes; a restore onto another mesh
    cuts the canonical slots again.  fp32 only, as in the JAX package:
    :meth:`set_precision` raises at ``optimize()``.

    The failure taxonomy is the shared loop's and ``optimize()``'s: the
    hung-step watchdog, the governor's poll, the chaos step hooks
    (``failStepAt``, ``nanLossAt``, ``preemptAt``, ``stallStepAt``,
    ``topologyChangeAt``) and the preemption drain act here as in the other
    trainers.  The JAX package's pipeline step has no integrity
    fingerprints, no replica or bit-flip injection and no microbatch
    re-plan of its own (its pipeline already splits the batch into
    ``n_micro`` microbatches): ``bigdl.integrity.everyN``,
    ``bigdl.chaos.bitflipParamAt``, ``desyncReplicaAt`` and ``oomStepAt``
    raise :class:`NotImplementedError` here, and a device OOM is fatal."""

    def __init__(self, blocks: Sequence[torch.nn.Module], dataset, criterion,
                 mesh: Optional[Mesh] = None, n_micro: int = 4,
                 embed: Optional[torch.nn.Module] = None,
                 head: Optional[torch.nn.Module] = None,
                 device: DeviceLike = "cuda"):
        model = Sequential()
        for m in ([embed] if embed is not None else []) + list(blocks) + \
                ([head] if head is not None else []):
            model.add(m)
        super().__init__(model, dataset, criterion, device=device)
        self.blocks = list(blocks)
        self.embed, self.head = embed, head
        self.n_micro = n_micro
        self._mesh = mesh if mesh is not None else Engine.create_mesh()
        shape = self._mesh.shape
        if "stage" not in shape:
            raise ValueError("PipelineOptimizer needs a mesh with a "
                             "'stage' axis")
        unknown = [a for a in shape if a not in ("data", "stage", "model")]
        if unknown:
            raise ValueError(f"mesh axes {self._mesh.axis_names}: expected "
                             "'stage' with 'data' and 'model'")
        if len(self.blocks) != shape["stage"]:
            raise ValueError(
                f"{len(self.blocks)} blocks vs 'stage' axis size "
                f"{shape['stage']} — one stage per device")
        self.data_axis = "data" if "data" in shape else None
        self.model_axis = "model" if "model" in shape else None
        for m in (embed, head):
            if m is not None and semantic_state_leaves(m):
                raise ValueError(
                    "embed/head modules must be stateless (their state "
                    "would not thread through the pipelined step)")
        self._kept = None

    @property
    def mesh(self) -> Mesh:
        return self._mesh

    def _group_size(self) -> int:
        return (dist.get_world_size() if dist.is_initialized() else 1)

    def _topology_meta(self):
        return elastic.describe_topology(
            self._mesh.size, step="pipeline", slot_axis=self.data_axis,
            axes=self._mesh.shape)

    # ---- the run -----------------------------------------------------------

    def _check_run(self) -> List[int]:
        """The checks before the first step; returns the partitions of a
        ``ShardedDataSet`` this rank feeds (None for another dataset)."""
        mesh = self._mesh
        world = dist.get_world_size() if dist.is_initialized() else 1
        if mesh.size != world:
            raise ValueError(f"mesh of {mesh.size} ranks over a process "
                             f"group of {world}")
        refuse_unported()
        refuse_keys(("bigdl.integrity.everyN", "bigdl.chaos.bitflipParamAt",
                     "bigdl.chaos.desyncReplicaAt", "bigdl.chaos.oomStepAt"),
                    "the pipeline step has no integrity fingerprints, "
                    "replica injectors or microbatch re-plan, as in the JAX "
                    "package")
        if self.precision is not None:
            raise ValueError("PipelineOptimizer is fp32-only for now; "
                             "unset set_precision")
        for b in self.blocks:
            _check_block(b)
        if not isinstance(self.dataset, ShardedDataSet):
            return None
        if self.data_axis is not None:
            if self.dataset.partition_num != mesh.shape[self.data_axis]:
                raise ValueError(
                    f"dataset has {self.dataset.partition_num} partitions "
                    f"but the '{self.data_axis}' axis has "
                    f"{mesh.shape[self.data_axis]} devices — they must "
                    "match")
            local = [mesh.coord(self.data_axis)]
        else:
            local = list(range(self.dataset.partition_num))
        missing = [p for p in local
                   if p not in self.dataset.local_partitions]
        if missing:
            raise ValueError(
                f"this rank's mesh position owns data partitions {missing} "
                "but the dataset does not hold them locally — construct "
                f"ShardedDataSet(..., local_partitions={local}) on this "
                "rank")
        return local

    def _optimize(self) -> torch.nn.Module:
        from bigdl_tpu_torch.parallel.distri_optimizer import (
            _block, _global_batch, _rank_seed, _split_penalty)
        from bigdl_tpu_torch.parallel.tensor_parallel import (
            local_slice, named_specs, split_dim)
        mesh, om = self._mesh, self.optim_method
        local = self._check_run()
        s = mesh.coord("stage")
        block = self.blocks[s]
        tp = self.model_axis
        self.model.train()
        if tp:
            for b in self.blocks:
                wire_model_parallel(b, tp, mesh)
        n_d = mesh.shape[self.data_axis] if self.data_axis else 1
        c_d = mesh.coord(self.data_axis) if self.data_axis else 0
        g_d = mesh.group(self.data_axis) if self.data_axis else None
        names = [k for k, _ in block.named_parameters()]
        full = [p for _, p in block.named_parameters()]
        specs = named_specs(block, tp, mesh) if tp else None
        split = [split_dim(specs[k], tp) if tp else None for k in names]
        kept, self._kept = self._kept, None
        if kept is not None and kept[0] is om and kept[1] is om._slots:
            stage_live, slots = kept[2], kept[3]
        else:
            stage_live = [p if d is None else local_slice(
                p.detach(), specs[k], tp, mesh.shape[tp],
                mesh.coord(tp)).clone().requires_grad_()
                for k, p, d in zip(names, full, split)]
            slots = None
        embed_p = list(self.embed.parameters()) if self.embed else []
        head_p = list(self.head.parameters()) if self.head else []
        params = embed_p + stage_live + head_p
        arp = AllReduceParameter(params, n_d, group=g_d)
        flat = arp.bind(params)
        row = arp.local_shard(flat, c_d)
        if slots is None:
            slots = self._slot_shards(arp, names, split, specs, c_d)
        self._live = (arp, slots, stage_live, names, split)
        has_reg = any(regularization_penalty(b) is not None
                      for b in self.blocks)
        split_names = {k for k, d in zip(names, split) if d is not None}
        g_m = mesh.group(tp) if tp else None
        tp_specs = stage_tp_specs(block, tp) if tp else None
        stochastic = is_stochastic(self.model)
        guard = config.get_bool("bigdl.divergence.guard", True)
        om.state.setdefault("epoch", 1)
        it = {"data": None}

        def reset_epoch():
            self.dataset.shuffle()
            if local is None:
                it["data"] = self.dataset.data(train=True)
            else:
                it["data"] = {p: self.dataset.shard_data(p, train=True)
                              for p in local}

        def fetch_batch():
            if local is not None:
                return _global_batch(it["data"], self.dataset.partition_num)
            batch = next(it["data"])
            inputs, targets = batch.get_input(), batch.get_target()
            if n_d > 1:
                inputs, targets = (_block(x, c_d, n_d)
                                   for x in (inputs, targets))
            return inputs, targets, batch.size()

        def stream(module, seed, part):
            if not stochastic or module is None:
                return contextlib.nullcontext()
            g = torch.Generator(device=self.device)
            g.manual_seed(_fold(_rank_seed(seed, c_d), part))
            return random_stream(module, g)

        def objective(inputs, targets, seed):
            h = inputs
            if self.embed is not None:
                with stream(self.embed, seed, _EMBED):
                    h = self.embed(h)
            h, aux = pipeline_apply(
                block, StageShard(dict(zip(names, stage_live)),
                                  len(self.blocks)),
                h, self.n_micro, mesh, training=True,
                rng=_fold(_rank_seed(seed, c_d), _STAGES) if stochastic
                else None, return_aux=True,
                param_specs=tp_specs)
            if self.head is not None:
                with stream(self.head, seed, _HEAD):
                    h = self.head(h)
            loss = self.criterion.apply(h, targets)
            if self.moe_aux_weight:
                loss = loss + self.moe_aux_weight * aux
            for m in (self.embed, self.head):
                pen = regularization_penalty(m) if m is not None else None
                if pen is not None:
                    loss = loss + pen
            if has_reg:
                own = _split_penalty(block, dict(zip(names, stage_live)),
                                     split_names, g_m)
                own = (own if own is not None else
                       torch.zeros((), device=self.device))
                total = own.detach().clone()
                if mesh.shape["stage"] > 1:
                    axis_sum(total, mesh.group("stage"))
                loss = loss + own + (total - own.detach())
            return loss

        def run_step(inputs, targets, hyper, seed):
            loss = objective(inputs, targets, seed)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            with torch.no_grad():
                loss = loss.detach()
                grads = [torch.zeros_like(p) if g is None else g
                         for g, p in zip(grads, params)]
                flat_g = arp.flatten(grads)
                del grads
                with telemetry.span("parallel/reduce_scatter"):
                    g_row = (arp.reduce_scatter_gradients(flat_g) / n_d
                             if n_d > 1 else flat_g)
                with telemetry.span("parallel/update"):
                    new_p, new_s = om.pure_update(
                        [g_row], [row], {k: [v] for k, v in slots.items()},
                        hyper)
                ok = True
                if guard:
                    ok = all_finite(loss, g_row)
                    if dist.is_initialized() and dist.get_world_size() > 1:
                        ok = axis_min(ok.to(torch.int32)).bool()
                self._torn = True
                select_tree(ok, new_p, [row])
                select_tree(ok, new_s, {k: [v] for k, v in slots.items()})
                with telemetry.span("parallel/all_gather"):
                    if n_d > 1:
                        arp.all_gather_weights(row, flat)
                self._torn = False
                if guard:
                    loss = torch.where(ok, loss,
                                       torch.full_like(loss, math.nan))
                if n_d > 1:
                    dist.all_reduce(loss, group=g_d)
                    loss = loss / n_d
            return loss

        self._sync_dataset_epoch()
        reset_epoch()
        try:
            self._drive(fetch_batch, run_step, reset_epoch,
                        epoch_size=self.dataset.size(), publish=self._publish)
        except BaseException:
            self._kept = (om, om._slots, stage_live, slots)
            raise
        finally:
            close_iterators(self.prefetcher,
                            it["data"].values() if isinstance(
                                it["data"], dict) else [it["data"]])
        self._publish()
        return self.model

    def _slot_shards(self, arp, names, split, specs, c_d
                     ) -> Dict[str, torch.Tensor]:
        """This rank's 1/data shard of each slot family's flat vector: the
        method's canonical per-parameter slots (a restore, an earlier run)
        cut to this rank's stage and ``model`` blocks, else fresh ones."""
        from bigdl_tpu_torch.parallel.tensor_parallel import local_slice
        om, mesh, tp = self.optim_method, self._mesh, self.model_axis
        if om._slots is None:
            zeros = torch.zeros(arp.shard_size, dtype=arp.dtype,
                                device=self.device)
            return {k: v[0] for k, v in om.init_slots([zeros]).items()}
        n_embed = len(list(self.embed.parameters())) if self.embed else 0
        sizes = [len(list(b.parameters())) for b in self.blocks]
        s = mesh.coord("stage")
        start = n_embed + sum(sizes[:s])
        out = {}
        for fam, per in om._slots.items():
            per = [t.to(self.device) for t in per]
            mine = per[start:start + sizes[s]]
            mine = [t if d is None else local_slice(
                t, specs[k], tp, mesh.shape[tp], mesh.coord(tp))
                for t, k, d in zip(mine, names, split)]
            tail = per[n_embed + sum(sizes):]
            vec = arp.flatten(per[:n_embed] + mine + tail)
            out[fam] = arp.local_shard(vec, c_d).clone()
        return out

    def _publish(self) -> None:
        """Gather the whole model into its own parameters on every rank and
        the canonical slots into the method: the slot shards over
        ``data``, the stage's blocks over ``model``, then each stage's
        weights and slots broadcast from its stage rank."""
        from bigdl_tpu_torch.parallel.distri_optimizer import _gather_dim
        arp, slots, stage_live, names, split = self._live
        mesh, tp = self._mesh, self.model_axis
        s, n_s = mesh.coord("stage"), mesh.shape["stage"]
        g_s = mesh.group("stage")
        n_embed = len(list(self.embed.parameters())) if self.embed else 0
        n_stage = len(stage_live)
        with torch.no_grad():
            fam_params = {}
            for fam, shard in slots.items():
                flat = (arp.all_gather_weights(
                    shard, shard.new_empty(arp.padded_size))
                    if arp.n_shards > 1 else shard)
                fam_params[fam] = [t.clone() for t in arp.unflatten(flat)]
            if tp:
                g_m, n_m = mesh.group(tp), mesh.shape[tp]
                own = list(self.blocks[s].parameters())
                for p, t, d in zip(own, stage_live, split):
                    if d is not None:
                        p.copy_(_gather_dim(t.detach(), d, g_m, n_m))
                for fam, per in fam_params.items():
                    for i, d in enumerate(split):
                        if d is not None:
                            per[n_embed + i] = _gather_dim(
                                per[n_embed + i], d, g_m, n_m)
            canon = {fam: [] for fam in fam_params}
            for fam, per in fam_params.items():
                canon[fam].extend(per[:n_embed])
            for j, b in enumerate(self.blocks):
                src = dist.get_global_rank(g_s, j) if n_s > 1 else None
                for i, p in enumerate(b.parameters()):
                    if n_s > 1:
                        dist.broadcast(p.data, src, group=g_s)
                    for fam, per in fam_params.items():
                        t = (per[n_embed + i].contiguous() if j == s
                             else torch.empty_like(p))
                        if n_s > 1:
                            dist.broadcast(t, src, group=g_s)
                        canon[fam].append(t)
            for fam, per in fam_params.items():
                canon[fam].extend(per[n_embed + n_stage:])
        self.optim_method.set_slots(canon)
