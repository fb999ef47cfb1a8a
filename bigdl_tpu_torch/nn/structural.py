"""Structural layers (``bigdl_tpu/nn/structural.py``: ``Identity`` :37,
``Reshape`` :66, ``View`` :88, ``MulConstant`` :582, ``ChannelNormalize``
:595, ``DeviceAugment`` :635).

Shapes are logical (NCHW for image maps) whatever the memory format: a
channels-last tensor (:mod:`bigdl_tpu_torch.nn.layout`) is not contiguous in
NCHW order, so ``Reshape`` and ``View`` use ``reshape``, which copies where
``view`` would refuse.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from bigdl_tpu_torch.nn.module import Module


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
