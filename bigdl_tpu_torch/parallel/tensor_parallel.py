"""Tensor parallelism, Megatron-style (``bigdl_tpu/parallel/tensor_parallel.py``:
``tp_specs`` :43, ``_specs`` :76, ``column_parallel``/``row_parallel``
:110-122, ``zero1_slot_spec(s)`` :124-152, ``tp_shard_params`` :155,
``_reject_flash`` :162, ``head_count_divisible`` :169).

The JAX package annotates parameters with ``PartitionSpec``s over a
``model`` mesh axis and lets XLA's partitioner insert the collectives.
PyTorch has no partitioner, so here the Megatron pair is explicit: a
column-parallel ``Linear`` holds ``out / n`` output features, a row-parallel
one ``in / n`` input features and all-reduces its output over the ``model``
subgroup.  :class:`~bigdl_tpu_torch.nn.MultiHeadAttention` splits over
heads: wq/wk/wv and their biases are column-split, wo row-split.  The
column half's input passes :func:`copy_to_model` (the identity forward, an
all-reduce of its gradient: Megatron's "f"), the row half's output
:func:`reduce_from_model` (an all-reduce forward, the identity backward:
"g").  A module splits only while the trainer binds the ``model`` axis
(:func:`bigdl_tpu_torch.engine.bind_axes`); outside it the module runs
whole.

Specs are written in the port's parameter layout: ``Linear`` keeps
PyTorch's (out, in) weight, so its column split is ``P(axis, None)`` where
the JAX package's (in, out) weight has ``P(None, axis)``;
``MultiHeadAttention`` keeps the JAX package's (in, out) weights and
specs.  ``Bottle`` is a container of one child here, so the walk reaches
through it as the JAX package's ``_specs`` does (its ``[inner]`` entry).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from bigdl_tpu_torch.nn.attention import MultiHeadAttention
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Container


class P(tuple):
    """A partition spec: one entry per dimension, the mesh axis that dim
    is split over or None (``jax.sharding.PartitionSpec``); ``P()`` is
    replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _mha_specs(module: MultiHeadAttention, axis: str) -> Dict[str, P]:
    specs = {"wq": P(None, axis), "wk": P(None, axis),
             "wv": P(None, axis), "wo": P(axis, None)}
    if module.with_bias:
        specs.update({"bq": P(axis), "bk": P(axis), "bv": P(axis),
                      "bo": P()})
    return specs


def _linear_specs(module: Linear, axis: str) -> Optional[Dict[str, P]]:
    tp = getattr(module, "_tp", None)
    if tp == "column":
        s = {"weight": P(axis, None)}
        if module.with_bias:
            s["bias"] = P(axis)
        return s
    if tp == "row":
        s = {"weight": P(None, axis)}
        if module.with_bias:
            s["bias"] = P()
        return s
    return None


def _specs(module: nn.Module, axis: str, reached: List[nn.Module]):
    if isinstance(module, MultiHeadAttention):
        reached.append(module)
        _reject_flash(module)
        return _mha_specs(module, axis)
    if isinstance(module, Linear):
        s = _linear_specs(module, axis)
        if s is not None:
            reached.append(module)
            return s
    if isinstance(module, Container):
        return [_specs(c, axis, reached) for c in module.layers]
    # replicated leaf: one spec per parameter
    return {name: P() for name, _ in module.named_parameters()}


def tp_specs(module: nn.Module, axis: str = "model", mesh=None):
    """The spec tree of ``module``'s parameters (a container's entry is
    the list of its children's, as in ``params_from_jax``).
    ``MultiHeadAttention`` gets the head split, a ``Linear`` tagged by
    :func:`column_parallel`/:func:`row_parallel` its half of the pair,
    every other parameter ``P()``.  A split module that the walk cannot
    reach (inside a composite that is not a ``Container``) raises
    :class:`ValueError` rather than stay silently replicated; a flash
    attention raises too.  ``mesh`` also checks the head counts
    (:func:`head_count_divisible`)."""
    reached: List[nn.Module] = []
    specs = _specs(module, axis, reached)
    participants = [m for m in module.modules()
                    if isinstance(m, MultiHeadAttention)
                    or (isinstance(m, Linear) and getattr(m, "_tp", None))]
    missed = [m for m in participants if not any(m is r for r in reached)]
    if missed:
        raise ValueError(
            "tensor-parallel modules are nested inside composites the "
            "spec walk cannot see through: "
            f"{sorted(type(m).__name__ for m in missed)} — restructure "
            "with Sequential/Container")
    if mesh is not None:
        head_count_divisible(module, mesh, axis)
    return specs


def named_specs(module: nn.Module, axis: str = "model",
                mesh=None) -> Dict[str, P]:
    """:func:`tp_specs` keyed by ``named_parameters()`` names (it checks
    what :func:`tp_specs` checks)."""
    tp_specs(module, axis, mesh)
    out = {}
    for mname, m in module.named_modules():
        own = None
        if isinstance(m, MultiHeadAttention):
            own = _mha_specs(m, axis)
        elif isinstance(m, Linear):
            own = _linear_specs(m, axis)
        for pname, p in m.named_parameters(recurse=False):
            full = f"{mname}.{pname}" if mname else pname
            out[full] = (own or {}).get(pname, P())
    return out


def column_parallel(linear: Linear) -> Linear:
    """Tag a ``Linear`` as the column half of a Megatron pair: it holds
    ``out / n`` output features, its output stays split."""
    linear._tp = "column"
    return linear


def row_parallel(linear: Linear) -> Linear:
    """Tag a ``Linear`` as the row half: it takes the split activation and
    all-reduces its output, the pair's one collective."""
    linear._tp = "row"
    return linear


def zero1_slot_spec(shape, spec: P, dp: int, axis: str = "data") -> P:
    """The optimizer-slot spec of a parameter with tensor-parallel
    ``spec``: also split over the data axis (ZeRO-1) along the first dim
    that ``spec`` leaves whole and ``dp`` divides; a parameter without
    one (a split bias) keeps ``spec``."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, e) in enumerate(zip(shape, entries)):
        if e is None and dim % dp == 0 and dim >= dp:
            entries[i] = axis
            return P(*entries)
    return spec


def zero1_slot_specs(shapes: Dict[str, tuple], specs: Dict[str, P],
                     dp: int, axis: str = "data") -> Dict[str, P]:
    """:func:`zero1_slot_spec` of every parameter (by name)."""
    if dp <= 1:
        return dict(specs)
    return {k: zero1_slot_spec(shapes[k], specs[k], dp, axis)
            for k in specs}


def split_dim(spec: P, axis: str) -> Optional[int]:
    """The dim ``spec`` splits over ``axis`` (None: not split)."""
    return next((i for i, e in enumerate(spec) if e == axis), None)


def local_slice(x: torch.Tensor, spec: P, axis: str, n: int,
                coord: int) -> torch.Tensor:
    """Coordinate ``coord``'s block of ``x`` along the dim ``spec``
    splits over ``axis`` (``x`` itself where it is not split)."""
    d = split_dim(spec, axis)
    if d is None:
        return x
    size = x.shape[d] // n
    return x.narrow(d, coord * size, size)


def tp_shard_params(module: nn.Module, mesh, specs: Dict[str, P],
                    axis: str = "model") -> Dict[str, torch.Tensor]:
    """This rank's block of every parameter split over ``axis`` (fresh
    tensors, by parameter name): a weight is physically ``1/n`` here."""
    n, coord = mesh.shape[axis], mesh.coord(axis)
    return {name: local_slice(p.detach(), specs[name], axis, n,
                              coord).clone()
            for name, p in module.named_parameters()
            if split_dim(specs[name], axis) is not None}


def _reject_flash(mha: MultiHeadAttention) -> None:
    if mha.flash:
        raise ValueError("flash kernel is incompatible with the "
                         "GSPMD head split (pallas kernels do not "
                         "partition); use the default attention path")


def head_count_divisible(module: nn.Module, mesh,
                         axis: str = "model") -> None:
    """Each rank computes whole heads: every attention's head count must
    divide by the ``axis`` size; a flash attention raises."""
    n = mesh.shape[axis]
    for m in module.modules():
        if isinstance(m, MultiHeadAttention):
            if m.n_head % n != 0:
                raise ValueError(
                    f"tensor parallelism needs n_head divisible by the "
                    f"'{axis}' axis size: {m.n_head} % {n} != 0")
            _reject_flash(m)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's "f": the identity forward, the gradient all-reduced over
    the ``model`` subgroup (each rank's split half contributes to the
    replicated input's gradient)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's "g": the partial sums all-reduced over the ``model``
    subgroup, the identity backward."""
    return _ReduceFromModel.apply(x, group)


def linear_forward(module: Linear, x: torch.Tensor, tp) -> torch.Tensor:
    """A tagged ``Linear``'s forward.  Under the bound ``model`` axis
    ``tp`` (``(group, size, coordinate)``) its weight and bias are its
    rank's blocks: a column half's input passes :func:`copy_to_model`, a
    row half's product :func:`reduce_from_model`.  A row half adds its
    bias after the product, bound or not (the JAX package's ``x @ W +
    b``), so the whole layer and its split run the same ops."""
    import torch.nn.functional as F
    if module._tp == "column":
        if tp is not None:
            x = copy_to_model(x, tp[0])
        return F.linear(x, module.weight, module.bias)
    y = F.linear(x, module.weight)
    if tp is not None:
        y = reduce_from_model(y, tp[0])
    return y if module.bias is None else y + module.bias
