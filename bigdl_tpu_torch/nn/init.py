"""Parameter initialisation methods (``bigdl_tpu/nn/init.py``; reference
``nn/InitializationMethod.scala``): the two the ported layers and
``model_init`` draw from.

Each method is a callable ``(shape, fan_in, fan_out, generator) -> tensor``
that draws a float32 tensor on the CPU from the caller's
:class:`torch.Generator` (:func:`bigdl_tpu_torch.nn.module.make_generator`);
the layer moves it to its device.  Layers compute their own fans from their
geometry, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


class InitializationMethod:
    def __call__(self, shape: Sequence[int], fan_in: Optional[int] = None,
                 fan_out: Optional[int] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        raise NotImplementedError(type(self).__name__)


class RandomUniform(InitializationMethod):
    """Uniform in [lower, upper]; with no bounds, the Torch default
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""

    def __init__(self, lower: Optional[float] = None,
                 upper: Optional[float] = None):
        self.lower, self.upper = lower, upper

    def __call__(self, shape, fan_in=None, fan_out=None, generator=None):
        if self.lower is None:
            bound = 1.0 / math.sqrt(max(1, fan_in or 1))
            lo, hi = -bound, bound
        else:
            lo, hi = self.lower, self.upper
        return torch.empty(tuple(shape)).uniform_(lo, hi, generator=generator)


class RandomNormal(InitializationMethod):
    def __init__(self, mean: float = 0.0, stdv: float = 1.0):
        self.mean, self.stdv = mean, stdv

    def __call__(self, shape, fan_in=None, fan_out=None, generator=None):
        return self.mean + self.stdv * torch.randn(tuple(shape),
                                                   generator=generator)
