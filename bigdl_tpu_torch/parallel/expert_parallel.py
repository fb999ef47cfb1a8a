"""Expert parallelism: MoE dispatch over a mesh's ``expert`` axis
(``bigdl_tpu/parallel/expert_parallel.py``: ``ep_shard_params`` :26,
``expert_parallel_apply`` :37; ``nn/moe.py`` ``_apply_expert_parallel``
:320).

The experts are split ``1/n`` over the axis and so are the tokens.  Each
rank routes its own tokens against the whole gate, sends every expert's
queue to the rank that holds the expert with one ``all_to_all``, runs its
own experts as one batched product over the queues every rank sent it, and
sends the outputs back with a second ``all_to_all``.  Capacity is per
rank (each routes its own tokens; the layer's class docstring).  The
balance diagnostic is the mean over the axis.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from bigdl_tpu_torch.engine import Mesh, bind_axes


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal blocks along dim 0 (block i to rank
    i of ``group``); it is its own transpose, so the backward runs it on
    the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        out = torch.empty_like(grad)
        dist.all_to_all_single(out, grad, group=ctx.group)
        return out, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block i of ``x``'s dim 0 goes to rank i of ``group``; block j of
    the result came from rank j.  Differentiable."""
    return _AllToAll.apply(x, group)


def apply_expert_parallel(moe, flat: torch.Tensor, group, n: int,
                          coord: int):
    """``moe``'s forward of this rank's (tokens, d) ``flat`` with the
    experts split over ``group`` (``n`` ranks, this one at ``coord``):
    (output, aux), aux the mean over the group (its value; its gradient
    is this rank's own term, as the JAX package's ``pmean`` transposes)."""
    grouped = moe._impl() == "grouped"
    if grouped:
        eid, slot, wgt, keep, aux = moe.route_compact(flat)
        cap = moe.capacity(flat.shape[0])
        expert_in = moe.grouped_dispatch(flat, eid, slot, keep, cap)
    else:
        dispatch, combine, aux = moe.route(flat)
        expert_in = torch.einsum("tec,td->ecd", dispatch, flat)
    e, c, d = expert_in.shape
    e_per = e // n
    # (E, C, d) -> (E/n, n*C, d): every rank's queues for this rank's
    # experts, in rank order
    x = all_to_all(expert_in.reshape(n, e_per, c, d), group)
    x = x.permute(1, 0, 2, 3).reshape(e_per, n * c, d)
    mine = {k: v[coord * e_per:(coord + 1) * e_per]
            for k, v in moe.stacked_parameters().items()}
    out = moe.expert_forward(x, experts=mine)
    out = out.reshape(e_per, n, c, d).permute(1, 0, 2, 3)
    out = all_to_all(out, group).reshape(e, c, d)
    if grouped:
        y = moe.grouped_combine(out, eid, slot, wgt, keep, cap)
    else:
        y = torch.einsum("tec,ecd->td", combine, out)
    mean = aux.detach().clone()
    dist.all_reduce(mean, group=group)
    return y, aux + (mean / n - aux).detach()


def ep_shard_params(moe, mesh: Mesh, axis: str = "expert"
                    ) -> Dict[str, object]:
    """The gate whole and this rank's block of the stacked experts
    (``n_experts / n`` of them), as the JAX package places them."""
    n, coord = mesh.shape[axis], mesh.coord(axis)
    if moe.n_experts % n != 0:
        raise ValueError(f"n_experts {moe.n_experts} must divide by the "
                         f"'{axis}' axis size {n}")
    e_per = moe.n_experts // n
    return {"gate": moe.gate,
            "experts": {k: v[coord * e_per:(coord + 1) * e_per]
                        for k, v in moe.stacked_parameters().items()}}


def expert_parallel_apply(moe, x: torch.Tensor, mesh: Mesh,
                          axis: str = "expert", return_aux: bool = False):
    """``moe``'s forward of the global batch ``x`` (the same on every rank
    of the axis) with experts and tokens split over ``axis``: this rank
    routes its ``1/n`` of the batch rows, and the outputs are gathered
    back into the global batch.  Differentiable.  ``return_aux=True``
    also returns the balance diagnostic averaged over the axis."""
    n, coord = mesh.shape[axis], mesh.coord(axis)
    if moe.n_experts % n != 0:
        raise ValueError(f"n_experts {moe.n_experts} must divide by the "
                         f"'{axis}' axis size {n}")
    if x.shape[0] % n != 0:
        raise ValueError(f"batch {x.shape[0]} must divide by the "
                         f"'{axis}' axis size {n} (tokens are co-sharded)")
    rows = x.shape[0] // n
    prev = moe.expert_parallel, moe._ep_shards
    moe.set_expert_parallel(axis, n)
    try:
        with bind_axes(mesh, [axis]):
            y = moe(x[coord * rows:(coord + 1) * rows])
    finally:
        moe.expert_parallel, moe._ep_shards = prev
    from torch.distributed.nn.functional import all_gather
    y = torch.cat(all_gather(y.contiguous(), group=mesh.group(axis)), 0)
    if return_aux:
        return y, moe._diagnostics["aux_loss"]
    return y
