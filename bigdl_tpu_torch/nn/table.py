"""Branch containers and table layers (``bigdl_tpu/nn/table.py``: ``Concat``
:22, ``ConcatTable`` :38, ``CAddTable`` :195).  A table is a Python list of
activations, as in the JAX package."""

from __future__ import annotations

from typing import List

import torch

from bigdl_tpu_torch.nn.module import Container, Module


def _axis(dim_1based: int, ndim: int) -> int:
    """A 1-based (or negative) Torch dimension as a 0-based axis."""
    return ndim + dim_1based if dim_1based < 0 else dim_1based - 1


class Concat(Container):
    """Apply each child to the same input and concatenate the outputs along
    the 1-based ``dimension`` (reference ``nn/Concat.scala``).  Shapes are
    logical, so ``Concat(2)`` joins channels in either memory format."""

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        outs = [child(input) for child in self.layers]
        return torch.cat(outs, dim=_axis(self.dimension, outs[0].dim()))


class ConcatTable(Container):
    """Apply each child to the same input; the output is the list of their
    results (reference ``nn/ConcatTable.scala``)."""

    def forward(self, input) -> List:
        return [child(input) for child in self.layers]


class CAddTable(Module):
    """Elementwise sum of a table (reference ``nn/CAddTable.scala``)."""

    layout_role = "agnostic"

    def __init__(self, inplace: bool = False):
        super().__init__()

    def forward(self, input: List[torch.Tensor]) -> torch.Tensor:
        out = input[0]
        for x in input[1:]:
            out = out + x
        return out
