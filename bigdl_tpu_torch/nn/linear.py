"""Linear and embedding layers (``bigdl_tpu/nn/linear.py``: ``Linear`` :25,
``LookupTable`` :160).

``Linear`` keeps PyTorch's (out, in) weight; the JAX package stores (in, out),
so :func:`bigdl_tpu_torch.utils.convert.params_from_jax` transposes it.
``w_regularizer``/``b_regularizer`` (:mod:`bigdl_tpu_torch.optim.regularizer`)
add their penalties to the training loss
(:func:`bigdl_tpu_torch.optim.optimizer.regularization_penalty`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.init import RandomUniform, redraw as _redraw
from bigdl_tpu_torch.nn.module import Module, make_generator


class Linear(Module):
    """y = x W^T + b (reference ``nn/Linear.scala``), initialised
    U(-1/sqrt(in), 1/sqrt(in)) by
    :class:`~bigdl_tpu_torch.nn.init.RandomUniform`."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        g = make_generator(generator)
        draw = RandomUniform()
        w = draw((output_size, input_size), input_size, generator=g)
        self.weight = nn.Parameter(w.to(device))
        if with_bias:
            b = draw((output_size,), input_size, generator=g)
            self.bias = nn.Parameter(b.to(device))
        else:
            self.register_parameter("bias", None)

    @torch.no_grad()
    def set_init_method(self, weight_init=None, bias_init=None,
                        generator: Optional[torch.Generator] = None
                        ) -> "Linear":
        """Redraw the weight and bias as
        :meth:`SpatialConvolution.set_init_method
        <bigdl_tpu_torch.nn.conv.SpatialConvolution.set_init_method>`
        does, with fan_in = ``input_size`` and fan_out = ``output_size``."""
        _redraw(self, weight_init, bias_init, generator,
                (self.input_size, self.output_size))
        return self

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return F.linear(input, self.weight, self.bias)


class LookupTable(Module):
    """Embedding lookup (reference ``nn/LookupTable.scala:44``).

    Input indices are 1-based float ids (Torch convention): they are cast
    to integers (truncating), shifted to 0-based and clipped into the
    table, as in the JAX package.  ``max_norm`` renormalisation is not in
    this slice."""

    def __init__(self, n_index: int, n_output: int, w_regularizer=None,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_index = n_index
        self.n_output = n_output
        self.w_regularizer = w_regularizer
        w = torch.randn(n_index, n_output, generator=make_generator(generator))
        self.weight = nn.Parameter(w.to(device))

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        idx = (input.to(torch.int64) - 1).clamp(0, self.n_index - 1)
        return F.embedding(idx, self.weight)
