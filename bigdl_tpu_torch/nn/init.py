"""Parameter initialisation methods (``bigdl_tpu/nn/init.py``; reference
``nn/InitializationMethod.scala``): the ones the ported layers,
``model_init`` and the Inception builders draw from.

Each method is a callable ``(shape, fan_in, fan_out, generator) -> tensor``
that draws a float32 tensor on the CPU from the caller's
:class:`torch.Generator` (:func:`bigdl_tpu_torch.nn.module.make_generator`);
the layer moves it to its device.  Layers compute their own fans from their
geometry and pass them, as in the JAX package: the port's weight layouts
differ from the JAX package's (a convolution's is (out, in/groups, kh, kw)
here, HWIO there), so a method never infers a fan from the shape.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from bigdl_tpu_torch.nn.module import make_generator


class InitializationMethod:
    def __call__(self, shape: Sequence[int], fan_in: Optional[int] = None,
                 fan_out: Optional[int] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        raise NotImplementedError(type(self).__name__)


class Zeros(InitializationMethod):
    def __call__(self, shape, fan_in=None, fan_out=None, generator=None):
        return torch.zeros(tuple(shape))


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


class Xavier(InitializationMethod):
    """Glorot uniform: U(-sqrt(6/(fan_in+fan_out)), +...), with the fans
    the layer passes (``bigdl_tpu/nn/init.py:72``)."""

    def __call__(self, shape, fan_in=None, fan_out=None, generator=None):
        if fan_in is None or fan_out is None:
            raise ValueError("Xavier needs the layer's fan_in and fan_out")
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        return torch.empty(tuple(shape)).uniform_(-bound, bound,
                                                  generator=generator)


def redraw(layer, weight_init: Optional[InitializationMethod],
           bias_init: Optional[InitializationMethod],
           generator: Optional[torch.Generator], fans,
           given=(False, False)) -> None:
    """Draw ``layer.weight`` with ``weight_init`` and ``layer.bias`` with
    ``bias_init`` again, in place, the weight first (the layers'
    ``set_init_method``).  A method that is None, a bias the layer lacks,
    and a tensor the layer was given at construction (``given``: weight,
    bias) are left as they are."""
    g = make_generator(generator)
    for t, method, fixed in ((layer.weight, weight_init, given[0]),
                             (layer.bias, bias_init, given[1])):
        if method is not None and t is not None and not fixed:
            t.copy_(method(t.shape, *fans, generator=g))
