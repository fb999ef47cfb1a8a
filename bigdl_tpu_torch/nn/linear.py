"""Linear and embedding layers (``bigdl_tpu/nn/linear.py``: ``Linear`` :25,
``LookupTable`` :160).

``Linear`` keeps PyTorch's (out, in) weight; the JAX package stores (in, out),
so :func:`bigdl_tpu_torch.utils.convert.params_from_jax` transposes it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.module import Module, make_generator


class Linear(Module):
    """y = x W^T + b (reference ``nn/Linear.scala``), initialised
    U(-1/sqrt(in), 1/sqrt(in)) like the JAX package's ``RandomUniform``."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        g = make_generator(generator)
        bound = 1.0 / math.sqrt(max(1, input_size))
        w = torch.empty(output_size, input_size).uniform_(-bound, bound,
                                                          generator=g)
        self.weight = nn.Parameter(w.to(device))
        if with_bias:
            b = torch.empty(output_size).uniform_(-bound, bound, generator=g)
            self.bias = nn.Parameter(b.to(device))
        else:
            self.register_parameter("bias", None)

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return F.linear(input, self.weight, self.bias)


class LookupTable(Module):
    """Embedding lookup (reference ``nn/LookupTable.scala:44``).

    Input indices are 1-based float ids (Torch convention): they are cast
    to integers (truncating), shifted to 0-based and clipped into the
    table, as in the JAX package.  ``max_norm`` renormalisation is not in
    this slice."""

    def __init__(self, n_index: int, n_output: int,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_index = n_index
        self.n_output = n_output
        w = torch.randn(n_index, n_output, generator=make_generator(generator))
        self.weight = nn.Parameter(w.to(device))

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        idx = (input.to(torch.int64) - 1).clamp(0, self.n_index - 1)
        return F.embedding(idx, self.weight)
