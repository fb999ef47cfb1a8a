"""Structural layers (``bigdl_tpu/nn/structural.py``: ``Identity`` :37,
``Reshape`` :66, ``View`` :88, ``Transpose`` :167, ``Select`` :202,
``Bottle`` :419, ``Remat`` :449, ``MulConstant`` :582,
``ChannelNormalize`` :595, ``DeviceAugment`` :635).

Dimension arguments are 1-based (Torch convention), as in the reference;
:func:`_axis` maps them to 0-based axes.

Shapes are logical (NCHW for image maps) whatever the memory format: a
channels-last tensor (:mod:`bigdl_tpu_torch.nn.layout`) is not contiguous in
NCHW order, so ``Reshape`` and ``View`` use ``reshape``, which copies where
``view`` would refuse.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

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
            consts = tuple(torch.tensor(v, dtype=torch.float32,
                                        device=input.device)
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
    before :class:`ChannelNormalize`.  ``color_jitter`` (the JAX package's
    per-record jitter, keyed by JAX's threefry) is not ported and
    raises."""

    def __init__(self, crop_h: int, crop_w: int, color_jitter=None):
        super().__init__()
        if color_jitter:
            raise NotImplementedError(
                "DeviceAugment(color_jitter=...): its factors come from "
                "JAX's threefry PRNG, which is not ported yet")
        self.crop_h = int(crop_h)
        self.crop_w = int(crop_w)

    def forward(self, input):
        from bigdl_tpu_torch.dataset.device_augment import \
            crop_flip_transpose
        if not isinstance(input, (list, tuple)) or len(input) < 3:
            return input
        return crop_flip_transpose(input[0], input[1], input[2],
                                   self.crop_h, self.crop_w)
