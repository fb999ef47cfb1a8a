"""Structural layers (``bigdl_tpu/nn/structural.py``: ``Identity`` :37,
``Echo`` :46, ``Contiguous`` :57, ``Reshape`` :66, ``View`` :88,
``InferReshape`` :116, ``Squeeze`` :135, ``Unsqueeze`` :153,
``Transpose`` :167, ``Narrow`` :181, ``Select`` :202, ``Index`` :217,
``MaskedSelect`` :231, ``Max`` :248, ``Min`` :263, ``Mean`` :278, ``Sum``
:294, ``Replicate`` :315, ``Padding`` :334, ``SpatialZeroPadding`` :352,
``GradientReversal`` :371, ``Scale`` :391, ``Bottle`` :419, ``Remat``
:449, ``MM`` :526, ``MV`` :542, ``DotProduct`` :556, ``Pack`` :559,
``Reverse`` :571, ``MulConstant`` :582, ``ChannelNormalize`` :595,
``DeviceAugment`` :635, ``AddConstant`` :672).

Dimension arguments are 1-based (Torch convention), as in the reference;
:func:`_axis` maps them to 0-based axes.  Each layer keeps the JAX
package's convention exactly: some count a negative dim from the end
through :func:`_axis`, others shift every dim down by one (``Unsqueeze``,
``Index``, ``Pack``, ``Reverse``, ``Replicate``: -1 is then the
second-to-last axis), and those with ``n_input_dims`` (or
``num_input_dims``, ``n_dim``, ``n_input_dim``) move right by one over a
batch dim in front.

Shapes are logical (NCHW for image maps) whatever the memory format: a
channels-last tensor (:mod:`bigdl_tpu_torch.nn.layout`) is not contiguous in
NCHW order, so ``Reshape`` and ``View`` use ``reshape``, which copies where
``view`` would refuse.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Container, Module


def _axis(dim_1based: int, ndim: int, n_input_dims: int = -1) -> int:
    """A 1-based dim as a 0-based axis (``bigdl_tpu/nn/structural.py:26``):
    a negative dim counts from the end; with ``n_input_dims`` (the dims
    of one sample), an input of one dim more has a batch dim in front and
    the axis moves right by one."""
    d = dim_1based
    if d < 0:
        return ndim + d
    ax = d - 1
    if n_input_dims > 0 and ndim == n_input_dims + 1:
        ax += 1
    return ax


class Identity(Module):
    """Pass input through unchanged (reference ``nn/Identity.scala``)."""

    layout_role = "agnostic"

    def forward(self, input):
        return input


class Echo(Module):
    """The identity that prints its input's shape (debug aid, reference
    ``nn/Echo.scala``)."""

    layout_role = "agnostic"

    def forward(self, input):
        print(f"Echo {type(self).__name__}: shape {list(input.shape)}")
        return input


class Contiguous(Module):
    """The input in contiguous memory (reference ``nn/Contiguous.scala``);
    a tensor contiguous in either memory format passes as it is, as the
    JAX package's no-op."""

    layout_role = "agnostic"

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        if input.is_contiguous() or \
                input.is_contiguous(memory_format=torch.channels_last):
            return input
        return input.contiguous()


class Reshape(Module):
    """Reshape non-batch dims to ``size`` (reference ``nn/Reshape.scala``).

    ``batch_mode`` None (default): the first dim is a batch dim when the
    element count of the input is a multiple, not equal, of prod(size)."""

    def __init__(self, size: Sequence[int], batch_mode: Optional[bool] = None):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self.batch_mode = batch_mode

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        n = math.prod(self.size)
        total = input.numel()
        if self.batch_mode is True or (
                self.batch_mode is None and total != n and input.dim() and
                total == n * input.shape[0]):
            return input.reshape((input.shape[0],) + self.size)
        return input.reshape(self.size)


class View(Module):
    """Reshape with -1 inference (reference ``nn/View.scala``);
    :meth:`set_num_input_dims` marks the trailing dims that one sample has,
    so that any leading dims are kept as batch dims."""

    def __init__(self, *sizes):
        super().__init__()
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
            sizes = tuple(sizes[0])
        self.sizes = tuple(int(s) for s in sizes)
        self.num_input_dims = 0

    def set_num_input_dims(self, n: int) -> "View":
        self.num_input_dims = n
        return self

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        sizes = self.sizes
        if self.num_input_dims > 0 and input.dim() > self.num_input_dims:
            batch = tuple(input.shape[:input.dim() - self.num_input_dims])
            return input.reshape(batch + sizes)
        n = math.prod(s for s in sizes if s != -1)
        if (-1 not in sizes and input.dim() > len(sizes)
                and math.prod(input.shape[1:]) == n):
            return input.reshape((input.shape[0],) + sizes)
        return input.reshape(sizes)


class InferReshape(Module):
    """Reshape where a 0 copies the input's dim and -1 is inferred; with
    ``batch_mode`` the first dim is kept in front (reference
    ``nn/InferReshape.scala``)."""

    def __init__(self, size: Sequence[int], batch_mode: bool = False):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self.batch_mode = batch_mode

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        in_shape = input.shape[1:] if self.batch_mode else input.shape
        out = [in_shape[i] if s == 0 else s for i, s in enumerate(self.size)]
        if self.batch_mode:
            out = [input.shape[0]] + out
        return input.reshape(tuple(out))


class Squeeze(Module):
    """Drop size-1 dims: all of them, or the 1-based ``dim`` when it is 1
    (reference ``nn/Squeeze.scala``)."""

    def __init__(self, dim: Optional[int] = None, num_input_dims: int = -1):
        super().__init__()
        self.dim = dim
        self.num_input_dims = num_input_dims

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        if self.dim is None:
            return input.squeeze()
        ax = _axis(self.dim, input.dim(), self.num_input_dims)
        return input.squeeze(ax) if input.shape[ax] == 1 else input


class Unsqueeze(Module):
    """Insert a size-1 dim at the 1-based ``pos`` (reference
    ``nn/Unsqueeze.scala``)."""

    def __init__(self, pos: int, num_input_dims: int = -1):
        super().__init__()
        self.pos = pos
        self.num_input_dims = num_input_dims

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        ax = self.pos - 1
        if self.num_input_dims > 0 and input.dim() == self.num_input_dims + 1:
            ax += 1
        return input.unsqueeze(ax)


class Transpose(Module):
    """Swap the listed 1-based dim pairs, in order (reference
    ``nn/Transpose.scala``).  Every dim is shifted down by one, as the JAX
    package's ``jnp.swapaxes(x, d1 - 1, d2 - 1)`` shifts it: 0 is the last
    dim and -1 the second-to-last.  The result is a view."""

    def __init__(self, permutations: Sequence[Sequence[int]]):
        super().__init__()
        self.permutations = [tuple(p) for p in permutations]

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        x = input
        for d1, d2 in self.permutations:
            x = x.transpose(d1 - 1, d2 - 1)
        return x


class Select(Module):
    """The 1-based ``index`` along the 1-based ``dimension``, which is
    dropped (reference ``nn/Select.scala``); a negative index counts from
    the end (``Select(2, -1)``: the last row of dim 2).  The result is a
    view."""

    def __init__(self, dimension: int, index: int):
        super().__init__()
        self.dimension = dimension
        self.index = index

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        ax = _axis(self.dimension, input.dim())
        i = self.index - 1 if self.index > 0 else \
            input.shape[ax] + self.index
        return input.select(ax, i)


class Narrow(Module):
    """``length`` entries from the 1-based ``offset`` along the 1-based
    ``dimension``; a negative length counts back from the end (reference
    ``nn/Narrow.scala``)."""

    def __init__(self, dimension: int, offset: int, length: int = 1):
        super().__init__()
        self.dimension = dimension
        self.offset = offset
        self.length = length

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        ax = _axis(self.dimension, input.dim())
        length = self.length
        if length < 0:
            length = input.shape[ax] - self.offset + 1 + length + 1
        start = self.offset - 1
        idx = [slice(None)] * input.dim()
        idx[ax] = slice(start, start + length)
        return input[tuple(idx)]


class Index(Module):
    """A table [tensor, indices]: the tensor gathered at the 1-based
    indices along the 1-based ``dimension`` (reference ``nn/Index.scala``);
    the indices' shape takes that dim's place."""

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def forward(self, input) -> torch.Tensor:
        x, idx = input[0], input[1]
        ax = (self.dimension - 1) % x.dim()
        i = idx.to(torch.int64).to(x.device) - 1
        out = torch.index_select(x, ax, i.reshape(-1))
        return out.reshape(tuple(x.shape[:ax]) + tuple(i.shape) +
                           tuple(x.shape[ax + 1:]))


class MaskedSelect(Module):
    """A table [tensor, mask]: the elements under the mask, packed to the
    front of a vector as long as the input and zero after them (the JAX
    package's static-shape output; the reference's ``nn/MaskedSelect.scala``
    returns only the selected elements)."""

    def forward(self, input) -> torch.Tensor:
        x, mask = input[0], input[1]
        flat = x.reshape(-1)
        m = mask.reshape(-1).to(torch.bool).to(x.device)
        order = torch.argsort((~m).to(torch.uint8), stable=True)
        return torch.where(m[order], flat[order], torch.zeros_like(flat))


class _Reduce(Module):
    def __init__(self, dim: int = 1, num_input_dims: int = -1):
        super().__init__()
        self.dim = dim
        self.num_input_dims = num_input_dims

    def _ax(self, input: torch.Tensor) -> int:
        return _axis(self.dim, input.dim(), self.num_input_dims)


class Max(_Reduce):
    """The maximum over the 1-based ``dim`` (reference ``nn/Max.scala``)."""

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return torch.amax(input, dim=self._ax(input))


class Min(_Reduce):
    """The minimum over the 1-based ``dim`` (reference ``nn/Min.scala``)."""

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return torch.amin(input, dim=self._ax(input))


class Mean(Module):
    """The mean over the 1-based ``dimension``, the dim kept unless
    ``squeeze`` (reference ``nn/Mean.scala``)."""

    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 squeeze: bool = True):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims
        self.squeeze = squeeze

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        ax = _axis(self.dimension, input.dim(), self.n_input_dims)
        return input.mean(dim=ax, keepdim=not self.squeeze)


class Sum(Module):
    """The sum (the mean with ``size_average``) over the 1-based
    ``dimension`` (reference ``nn/Sum.scala``)."""

    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 size_average: bool = False, squeeze: bool = True):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims
        self.size_average = size_average
        self.squeeze = squeeze

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        ax = _axis(self.dimension, input.dim(), self.n_input_dims)
        if self.size_average:
            return input.mean(dim=ax, keepdim=not self.squeeze)
        return input.sum(dim=ax, keepdim=not self.squeeze)


class Replicate(Module):
    """``n_features`` copies along a new dim at the 1-based ``dim``
    (reference ``nn/Replicate.scala``)."""

    def __init__(self, n_features: int, dim: int = 1, n_dim: int = -1):
        super().__init__()
        self.n_features = n_features
        self.dim = dim
        self.n_dim = n_dim

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        ax = self.dim - 1
        if self.n_dim > 0 and input.dim() == self.n_dim + 1:
            ax += 1
        x = input.unsqueeze(ax)
        reps = [1] * x.dim()
        reps[ax] = self.n_features
        return x.repeat(reps)


class Padding(Module):
    """``|pad|`` entries of ``value`` before (``pad`` < 0) or after the
    1-based ``dim`` (reference ``nn/Padding.scala``)."""

    def __init__(self, dim: int, pad: int, n_input_dim: int,
                 value: float = 0.0, n_index: int = 1):
        super().__init__()
        self.dim = dim
        self.pad = pad
        self.n_input_dim = n_input_dim
        self.value = value

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        ax = _axis(self.dim, input.dim(), self.n_input_dim)
        shape = list(input.shape)
        shape[ax] = abs(self.pad)
        fill = torch.full(shape, self.value, dtype=input.dtype,
                          device=input.device)
        parts = (fill, input) if self.pad < 0 else (input, fill)
        return torch.cat(parts, dim=ax)


class SpatialZeroPadding(Module):
    """Zero-pad the last two dims of an NCHW map, or crop where a pad is
    negative (reference ``nn/SpatialZeroPadding.scala``); the pads default
    to ``pad_left``."""

    def __init__(self, pad_left: int, pad_right: Optional[int] = None,
                 pad_top: Optional[int] = None,
                 pad_bottom: Optional[int] = None):
        super().__init__()
        self.pl = pad_left
        self.pr = pad_right if pad_right is not None else pad_left
        self.pt = pad_top if pad_top is not None else pad_left
        self.pb = pad_bottom if pad_bottom is not None else pad_left

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        if (input.shape[-1] + self.pl + self.pr < 1 or
                input.shape[-2] + self.pt + self.pb < 1):
            raise ValueError("input is too small")
        return F.pad(input, (self.pl, self.pr, self.pt, self.pb))


class _ReverseGradFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lam):
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lam * g, None


class GradientReversal(Module):
    """The identity forward whose backward multiplies the gradient by
    ``-the_lambda`` (reference ``nn/GradientReversal.scala``; the JAX
    package's custom VJP)."""

    layout_role = "agnostic"

    def __init__(self, the_lambda: float = 1.0):
        super().__init__()
        self.the_lambda = the_lambda

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return _ReverseGradFn.apply(input, self.the_lambda)


class Scale(Module):
    """x * weight + bias with learnable ``size``-shaped weight (ones) and
    bias (zeros), ``size`` aligned to the dims from dim 1 (reference
    ``nn/Scale.scala``)."""

    def __init__(self, size: Sequence[int], init_weight=None, init_bias=None,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.size = tuple(size)
        w = (torch.as_tensor(init_weight, dtype=torch.float32)
             .reshape(self.size).clone() if init_weight is not None
             else torch.ones(self.size))
        b = (torch.as_tensor(init_bias, dtype=torch.float32)
             .reshape(self.size).clone() if init_bias is not None
             else torch.zeros(self.size))
        self.weight = torch.nn.Parameter(w.to(device))
        self.bias = torch.nn.Parameter(b.to(device))

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        shape = [1] * input.dim()
        for i, s in enumerate(self.size):
            shape[min(i + 1, input.dim() - 1)] = s
        return input * self.weight.reshape(shape) + self.bias.reshape(shape)


class Bottle(Container):
    """Flatten the leading dims, apply the inner module, restore them
    (reference ``nn/Bottle.scala``): the input's last ``n_input_dim - 1``
    dims are one sample's, every dim before them a batch dim.  A container
    of one child, so its parameter tree is ``[inner]`` and the
    tensor-parallel spec walk sees through it, as in the JAX package."""

    def __init__(self, module: torch.nn.Module, n_input_dim: int = 2,
                 n_output_dim: int = 2):
        super().__init__()
        self.add(module)
        self.n_input_dim = n_input_dim
        self.n_output_dim = n_output_dim

    @property
    def module(self) -> torch.nn.Module:
        return self.layers[0]

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        split = input.dim() - self.n_input_dim + 1
        lead, rest = tuple(input.shape[:split]), tuple(input.shape[split:])
        out = self.layers[0](input.reshape((-1,) + rest))
        return out.reshape(lead + tuple(out.shape[1:]))


class Remat(Container):
    """Activation checkpointing (rematerialisation) around one module:
    ``torch.utils.checkpoint`` (non-reentrant) of the wrapped module's
    forward, so that the backward recomputes its activations from its
    input instead of keeping them (the JAX package's ``jax.checkpoint``
    of the child's ``apply``).  The numerics are the unwrapped module's.

    ``policy`` says what may be kept anyway
    (``torch.utils.checkpoint.create_selective_checkpoint_contexts``):

    - ``None`` / ``"nothing"``: nothing, the whole forward recomputes;
    - ``"dots"``: the outputs of the matrix products without batch dims
      (``aten.mm``, ``aten.addmm``; the JAX package's
      ``dots_with_no_batch_dims_saveable``): the batched attention and
      expert products, the norms and elementwise ops recompute;
    - ``"save_attn"``: only the attention context that
      :class:`~bigdl_tpu_torch.nn.attention.MultiHeadAttention` names
      (:func:`~bigdl_tpu_torch.nn.attention.attn_ctx`), one (B, T, d)
      tensor per block; the flash forward is launched again in the
      recompute, since the backward needs its log-sum-exp;
    - a callable: a selective-checkpoint policy function
      ``(ctx, op, *args, **kwargs) -> CheckpointPolicy``.

    An unknown policy raises :class:`ValueError` here, at construction.
    A ``Dropout`` inside draws the same mask in the recompute as in the
    forward: the random streams of the wrapped module's stochastic layers
    are wound back for the recompute and put forward again after it.
    A container of one child, so that ``params_from_jax``, ``tp_specs``
    and the trainers see through it."""

    def __init__(self, inner: torch.nn.Module, policy=None):
        super().__init__()
        self.add(inner)
        self.policy = policy
        self.checkpoint_policy()   # a typo'd policy fails here

    def add(self, module: torch.nn.Module) -> "Container":
        if len(self.layers):
            raise ValueError("Remat wraps exactly one module; compose a "
                             "Sequential inside it instead")
        return super().add(module)

    def checkpoint_policy(self):
        """The selective-checkpoint policy: a list of ops to save, a
        policy function, or None (save nothing)."""
        if callable(self.policy):
            return self.policy
        if self.policy in (None, "nothing"):
            return None
        if self.policy == "dots":
            return [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]
        if self.policy == "save_attn":
            from bigdl_tpu_torch.nn.attention import attn_ctx  # noqa: F401
            return [torch.ops.bigdl_tpu_torch.attn_ctx.default]
        raise ValueError(
            f"unknown remat policy {self.policy!r}: expected None, "
            "'nothing', 'dots', 'save_attn', or a selective-checkpoint "
            "policy callable")

    def forward(self, input):
        inner = self.layers[0]
        if not torch.is_grad_enabled():
            return self._run(inner, input)
        from torch.utils.checkpoint import (
            checkpoint, create_selective_checkpoint_contexts)
        policy = self.checkpoint_policy()
        kwargs = {}
        if policy is not None:
            kwargs["context_fn"] = (
                lambda: create_selective_checkpoint_contexts(policy))
        # the parameters in effect now (a trainer's bf16 casts or its
        # tensor-parallel blocks, put in by torch.func.functional_call):
        # the recompute runs after that call has put the module's own back
        params = dict(inner.named_parameters())
        streams = [(m, m.generator) for m in inner.modules()
                   if getattr(m, "stochastic", False)
                   and getattr(m, "generator", None) is not None]
        gens = {id(g): g for _, g in streams}
        wound = {k: g.get_state() for k, g in gens.items()}
        calls = {"n": 0}

        def fn(x):
            calls["n"] += 1
            if calls["n"] == 1:
                return self._run(inner, x, params)
            # the recompute: replay the forward's draws from the same
            # streams, then put the streams back where they were
            saved = [(m, m.generator) for m, _ in streams]
            now = {k: g.get_state() for k, g in gens.items()}
            for m, g in streams:
                m.generator = g
            for k, g in gens.items():
                g.set_state(wound[k])
            try:
                return self._run(inner, x, params)
            finally:
                for k, g in gens.items():
                    g.set_state(now[k])
                for m, g in saved:
                    m.generator = g

        return checkpoint(fn, input, use_reentrant=False, **kwargs)

    def _run(self, inner, x, params=None):
        from torch.func import functional_call
        run = (lambda: inner(x)) if params is None else \
            (lambda: functional_call(inner, params, (x,)))
        if self.policy == "save_attn":
            from bigdl_tpu_torch.nn.attention import naming_attn_ctx
            with naming_attn_ctx():
                return run()
        return run()


class MM(Module):
    """The matrix product of a table [a, b], either transposed first
    (reference ``nn/MM.scala``)."""

    def __init__(self, trans_a: bool = False, trans_b: bool = False):
        super().__init__()
        self.trans_a, self.trans_b = trans_a, trans_b

    def forward(self, input) -> torch.Tensor:
        a, b = input[0], input[1]
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)


class MV(Module):
    """The matrix-vector product of a table [m, v] (reference
    ``nn/MV.scala``)."""

    def __init__(self, trans: bool = False):
        super().__init__()
        self.trans = trans

    def forward(self, input) -> torch.Tensor:
        m, v = input[0], input[1]
        if self.trans:
            m = m.transpose(-1, -2)
        return torch.einsum("...ij,...j->...i", m, v)


class DotProduct(Module):
    """The row-wise dot product of a table [a, b] over the last dim
    (reference ``nn/DotProduct.scala``)."""

    def forward(self, input) -> torch.Tensor:
        return (input[0] * input[1]).sum(dim=-1)


class Pack(Module):
    """Stack a table of tensors along a new 1-based ``dimension``
    (reference ``nn/Pack.scala``)."""

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def forward(self, input) -> torch.Tensor:
        xs = input if isinstance(input, (list, tuple)) else [input]
        return torch.stack(list(xs), dim=self.dimension - 1)


class Reverse(Module):
    """Reverse along the 1-based ``dimension`` (reference
    ``nn/Reverse.scala``)."""

    def __init__(self, dimension: int = 1):
        super().__init__()
        self.dimension = dimension

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return torch.flip(input, dims=(self.dimension - 1,))


class MulConstant(Module):
    """Multiply by a scalar constant (reference ``nn/MulConstant.scala``)."""

    layout_role = "agnostic"

    def __init__(self, constant_scalar: float, inplace: bool = False):
        super().__init__()
        self.constant = constant_scalar

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return input * self.constant


class ChannelNormalize(Module):
    """Per-channel input normalisation on the device:
    ``(x.float() - mean[c]) / std[c]``, cast to ``dtype`` when given (a
    ``torch.dtype`` or its name, e.g. ``"bfloat16"``).  Placed first, it
    lets the ingest path ship uint8 pixels, a quarter of the float32
    bytes.  ``format="NCHW"`` normalises dim 1, ``"NHWC"`` the last dim.
    Elementwise, so a channels-last input gives a channels-last output.
    The host-side twin is :class:`bigdl_tpu_torch.dataset.image.
    ChannelNormalize`."""

    layout_role = "agnostic"

    def __init__(self, mean, std, dtype=None, format: str = "NCHW"):
        super().__init__()
        if format not in ("NCHW", "NHWC"):
            raise ValueError(f"unknown format {format!r}")
        self.mean = tuple(float(m) for m in mean)
        self.std = tuple(float(v) for v in std)
        self.dtype = (getattr(torch, dtype) if isinstance(dtype, str)
                      else dtype)
        self.format = format
        # per device, made once: a host-to-device copy in every forward
        # would wait for the stream's queued work
        self._consts: Dict[torch.device, tuple] = {}

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        consts = self._consts.get(input.device)
        if consts is None:
            # filled on the device, not copied from the host: a pageable
            # copy would synchronize in the step (the host-sync guard's
            # "synchronizing CUDA call")
            consts = tuple(
                torch.stack([torch.full((), x, dtype=torch.float32,
                                        device=input.device) for x in v])
                for v in (self.mean, self.std))
            self._consts[input.device] = consts
        c = len(self.mean)
        if self.format == "NCHW":
            shape = (1, c) + (1,) * (input.dim() - 2)
        else:
            shape = (1,) * (input.dim() - 1) + (c,)
        mean, std = (t.view(shape) for t in consts)
        out = (input.to(torch.float32) - mean) / std
        return out if self.dtype is None else out.to(self.dtype)


class DeviceAugment(Module):
    """The on-device crop and flip head of device-augment ingest: takes the
    ``[frames (N, H, W, C) uint8, offsets (N, 2), flips (N,)]`` list that
    ``StreamingIngest(device_augment=True)`` packs and gives the uint8 NCHW
    crop batch the host assembler would have made, bit for bit
    (:func:`bigdl_tpu_torch.dataset.device_augment.crop_flip_transpose`:
    channels-last in memory).  An assembled batch (a tensor) passes through
    unchanged, so one model serves both ingest modes.  Place it first,
    before :class:`ChannelNormalize`.  ``color_jitter``, a dict of
    ``brightness``/``contrast``/``saturation`` strengths, jitters each
    record with the seed that ``StreamingIngest(device_jitter=True)`` packs
    as a fourth input (:func:`bigdl_tpu_torch.dataset.device_augment.
    color_jitter`); without that input the crop passes unjittered, as in
    the JAX package."""

    def __init__(self, crop_h: int, crop_w: int, color_jitter=None):
        super().__init__()
        self.crop_h = int(crop_h)
        self.crop_w = int(crop_w)
        self.color_jitter = dict(color_jitter) if color_jitter else None

    def forward(self, input):
        from bigdl_tpu_torch.dataset import device_augment
        if not isinstance(input, (list, tuple)) or len(input) < 3:
            return input
        out = device_augment.crop_flip_transpose(
            input[0], input[1], input[2], self.crop_h, self.crop_w)
        if self.color_jitter and len(input) > 3:
            out = device_augment.color_jitter(out, input[3],
                                              **self.color_jitter)
        return out


class AddConstant(Module):
    """Add a scalar constant (reference ``nn/AddConstant.scala``)."""

    layout_role = "agnostic"

    def __init__(self, constant_scalar: float, inplace: bool = False):
        super().__init__()
        self.constant = constant_scalar

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return input + self.constant
