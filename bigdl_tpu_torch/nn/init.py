"""Parameter initialisation methods (``bigdl_tpu/nn/init.py``; reference
``nn/InitializationMethod.scala``): every method of the JAX package.

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

import numpy as np
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


class Ones(InitializationMethod):
    def __call__(self, shape, fan_in=None, fan_out=None, generator=None):
        return torch.ones(tuple(shape))


class ConstInitMethod(InitializationMethod):
    def __init__(self, value: float):
        self.value = value

    def __call__(self, shape, fan_in=None, fan_out=None, generator=None):
        return torch.full(tuple(shape), float(self.value))


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


class MsraFiller(InitializationMethod):
    """He (Kaiming) normal: N(0, 2 / fan), the fan the layer passes,
    fan_in unless ``var_fan_in`` is False (``bigdl_tpu/nn/init.py:83``)."""

    def __init__(self, var_fan_in: bool = True):
        self.var_fan_in = var_fan_in

    def __call__(self, shape, fan_in=None, fan_out=None, generator=None):
        fan = (fan_in if self.var_fan_in else fan_out) or 1
        return math.sqrt(2.0 / fan) * torch.randn(tuple(shape),
                                                  generator=generator)


class BilinearFiller(InitializationMethod):
    """The bilinear upsampling kernel (``bigdl_tpu/nn/init.py:95``) over
    the last two dims, (kh, kw), broadcast over the leading ones: the
    port's (out, in, kh, kw) layout of the JAX package's (kh, kw, in,
    out)."""

    def __call__(self, shape, fan_in=None, fan_out=None, generator=None):
        shape = tuple(shape)
        kh, kw = shape[-2], shape[-1]
        f_h, f_w = math.ceil(kh / 2.0), math.ceil(kw / 2.0)
        c_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        c_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        ys = np.arange(kh)[:, None]
        xs = np.arange(kw)[None, :]
        kern = (1 - np.abs(ys / f_h - c_h)) * (1 - np.abs(xs / f_w - c_w))
        kern = torch.from_numpy(kern.astype(np.float32))
        return kern.expand(shape).clone()


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
