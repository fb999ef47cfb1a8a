"""Structural layers (``bigdl_tpu/nn/structural.py``: ``Identity`` :37,
``Reshape`` :66, ``View`` :88, ``MulConstant`` :582).

Shapes are logical (NCHW for image maps) whatever the memory format: a
channels-last tensor (:mod:`bigdl_tpu_torch.nn.layout`) is not contiguous in
NCHW order, so ``Reshape`` and ``View`` use ``reshape``, which copies where
``view`` would refuse.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

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
