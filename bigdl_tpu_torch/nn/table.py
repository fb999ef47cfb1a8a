"""Branch containers and table layers (``bigdl_tpu/nn/table.py``: ``Concat``
:22, ``ConcatTable`` :38, ``ParallelTable`` :52, ``MapTable`` :65,
``JoinTable`` :87, ``SplitTable`` :102, ``SelectTable`` :118,
``NarrowTable`` :131, ``FlattenTable`` :147, ``MixtureTable`` :164,
``CAddTable`` :195 and its siblings, ``PairwiseDistance`` :237,
``CosineDistance`` :251).  A table is a Python list of activations, as in
the JAX package; dims are 1-based (negative from the end), as there."""

from __future__ import annotations

from typing import List, Optional

import torch

from bigdl_tpu_torch.nn.module import Container, Module
from bigdl_tpu_torch.nn.structural import _axis


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


class ParallelTable(Container):
    """Child i applied to element i of the table (reference
    ``nn/ParallelTable.scala``)."""

    def forward(self, input) -> List:
        return [child(x) for child, x in zip(self.layers, input)]


class MapTable(Container):
    """One child applied to every element of the table, its parameters
    shared (reference ``nn/MapTable.scala``)."""

    def __init__(self, module: Optional[torch.nn.Module] = None):
        super().__init__()
        if module is not None:
            self.add(module)

    def forward(self, input) -> List:
        child = self.layers[0]
        return [child(x) for x in input]


class JoinTable(Module):
    """Concatenate a table of tensors along the 1-based ``dimension``; with
    ``n_input_dims``, an input of one dim more has a batch dim in front
    (reference ``nn/JoinTable.scala``)."""

    def __init__(self, dimension: int, n_input_dims: int = -1):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def forward(self, input) -> torch.Tensor:
        ax = _axis(self.dimension, input[0].dim(), self.n_input_dims)
        return torch.cat(list(input), dim=ax)


class SplitTable(Module):
    """Split a tensor into the table of its slices along the 1-based
    ``dimension`` (reference ``nn/SplitTable.scala``)."""

    def __init__(self, dimension: int, n_input_dims: int = -1):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def forward(self, input: torch.Tensor) -> List:
        ax = _axis(self.dimension, input.dim(), self.n_input_dims)
        return list(torch.unbind(input, dim=ax))


class SelectTable(Module):
    """Element ``index`` (1-based; negative from the end) of a table
    (reference ``nn/SelectTable.scala``)."""

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def forward(self, input):
        i = self.index - 1 if self.index > 0 else len(input) + self.index
        return input[i]


class NarrowTable(Module):
    """``length`` elements of a table from the 1-based ``offset``; a
    negative length counts back from the end (reference
    ``nn/NarrowTable.scala``)."""

    def __init__(self, offset: int, length: int = 1):
        super().__init__()
        self.offset = offset
        self.length = length

    def forward(self, input) -> List:
        length = self.length
        if length < 0:
            length = len(input) - self.offset + 2 + length
        return list(input)[self.offset - 1: self.offset - 1 + length]


class FlattenTable(Module):
    """Nested tables as one flat table, depth first (reference
    ``nn/FlattenTable.scala``)."""

    def forward(self, input) -> List:
        out: List = []

        def rec(x):
            if isinstance(x, (list, tuple)):
                for v in x:
                    rec(v)
            else:
                out.append(x)

        rec(input)
        return out


class MixtureTable(Module):
    """A gated blend of experts (reference ``nn/MixtureTable.scala``): the
    input is [gates (N, E), experts], the experts a table of E (N, ...)
    tensors or one (N, E, ...) tensor; the output is the sum over E of
    gate times expert."""

    def __init__(self, dim: int = -1):
        super().__init__()
        self.dim = dim

    def forward(self, input) -> torch.Tensor:
        gates, experts = input[0], input[1]
        stacked = (torch.stack(list(experts), dim=1)
                   if isinstance(experts, (list, tuple)) else experts)
        g = gates.reshape(tuple(gates.shape) +
                          (1,) * (stacked.dim() - gates.dim()))
        return (stacked * g).sum(dim=1)


class _BinaryTableOp(Module):
    """A left fold of an elementwise op over the table."""

    layout_role = "agnostic"

    def forward(self, input: List[torch.Tensor]) -> torch.Tensor:
        out = input[0]
        for x in input[1:]:
            out = self._op(out, x)
        return out


class CAddTable(_BinaryTableOp):
    """Elementwise sum of a table (reference ``nn/CAddTable.scala``)."""

    def __init__(self, inplace: bool = False):
        super().__init__()

    def _op(self, a, b):
        return a + b


class CSubTable(_BinaryTableOp):
    """a - b of a table [a, b] (reference ``nn/CSubTable.scala``)."""

    def _op(self, a, b):
        return a - b


class CMulTable(_BinaryTableOp):
    """Elementwise product of a table (reference ``nn/CMulTable.scala``)."""

    def _op(self, a, b):
        return a * b


class CDivTable(_BinaryTableOp):
    """a / b of a table [a, b] (reference ``nn/CDivTable.scala``)."""

    def _op(self, a, b):
        return a / b


class CMaxTable(_BinaryTableOp):
    """Elementwise maximum of a table (reference ``nn/CMaxTable.scala``)."""

    def _op(self, a, b):
        return torch.maximum(a, b)


class CMinTable(_BinaryTableOp):
    """Elementwise minimum of a table (reference ``nn/CMinTable.scala``)."""

    def _op(self, a, b):
        return torch.minimum(a, b)


class PairwiseDistance(Module):
    """The L-``norm`` distance between the rows of a table [a, b] over the
    last dim (reference ``nn/PairwiseDistance.scala``)."""

    def __init__(self, norm: int = 2):
        super().__init__()
        self.norm = norm

    def forward(self, input) -> torch.Tensor:
        d = torch.abs(input[0] - input[1]) ** self.norm
        return d.sum(dim=-1) ** (1.0 / self.norm)


class CosineDistance(Module):
    """Cosine similarity of the rows of a table [a, b] over the last dim,
    each norm floored at 1e-12 (reference ``nn/CosineDistance.scala``)."""

    def forward(self, input) -> torch.Tensor:
        a, b = input[0], input[1]
        an = torch.clamp(torch.linalg.vector_norm(a, dim=-1), min=1e-12)
        bn = torch.clamp(torch.linalg.vector_norm(b, dim=-1), min=1e-12)
        return (a * b).sum(dim=-1) / (an * bn)
