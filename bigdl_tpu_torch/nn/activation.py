"""Activation layers and stochastic regularisers
(``bigdl_tpu/nn/activation.py``: ``ReLU`` :30, ``Tanh`` :70, ``Sigmoid``
:84, ``LogSoftMax`` :116, ``Threshold`` :185, ``PReLU`` :251, ``RReLU``
:277, ``Dropout`` :298, ``GaussianDropout`` :328, ``GaussianNoise`` :348,
``L1Penalty`` :367; the rest of the elementwise maps between them).  Each
is a module and, like any module, callable on a tensor, so a recurrent cell
takes one as its activation.  Each elementwise map computes what the JAX
package's ``_fn`` computes, op for op (``exp(x) - 1``, not ``expm1``), so
that both agree to rounding.

The stochastic layers (``Dropout``, ``RReLU``, ``GaussianDropout``,
``GaussianNoise``) draw in training from the ``generator`` the trainer or
the shell sets (:func:`bigdl_tpu_torch.nn.module.random_stream`), never
from the global generator, and draw nothing without one; their bits are
torch's, not the JAX package's threefry ones."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.module import Module


class _Elementwise(Module):
    """A pointwise map: any memory format passes through."""

    layout_role = "agnostic"

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return self._fn(input)


class ReLU(Module):
    """Rectified linear max(x, 0) (reference ``nn/ReLU.scala``)."""

    layout_role = "agnostic"

    def __init__(self, ip: bool = False):
        super().__init__()
        self.inplace = ip   # no in-place here; kept for the signature

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return torch.relu(input)


class ReLU6(_Elementwise):
    """min(max(x, 0), 6) (reference ``nn/ReLU6.scala``)."""

    def __init__(self, inplace: bool = False):
        super().__init__()

    def _fn(self, x):
        return torch.clamp(x, 0.0, 6.0)


class LeakyReLU(_Elementwise):
    """x for x >= 0, else ``negval`` * x (reference ``nn/LeakyReLU.scala``)."""

    def __init__(self, negval: float = 0.01, inplace: bool = False):
        super().__init__()
        self.negval = negval

    def _fn(self, x):
        return torch.where(x >= 0, x, x * self.negval)


class ELU(_Elementwise):
    """x for x > 0, else alpha * (exp(x) - 1) (reference ``nn/ELU.scala``)."""

    def __init__(self, alpha: float = 1.0, inplace: bool = False):
        super().__init__()
        self.alpha = alpha

    def _fn(self, x):
        return torch.where(x > 0, x, self.alpha * (torch.exp(x) - 1.0))


class Tanh(Module):
    """Elementwise tanh (reference ``nn/Tanh.scala``)."""

    layout_role = "agnostic"

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return torch.tanh(input)


class TanhShrink(_Elementwise):
    """x - tanh(x) (reference ``nn/TanhShrink.scala``)."""

    def _fn(self, x):
        return x - torch.tanh(x)


class Sigmoid(Module):
    """Logistic sigmoid (reference ``nn/Sigmoid.scala``)."""

    layout_role = "agnostic"

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(input)


class LogSigmoid(_Elementwise):
    """log(sigmoid(x)), stable (reference ``nn/LogSigmoid.scala``)."""

    def _fn(self, x):
        return F.logsigmoid(x)


class SoftMax(Module):
    """Softmax over the last dim (torch semantics for 1-D/2-D input)."""

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return torch.softmax(input, dim=-1)


class SoftMin(Module):
    """Softmax of -x over the last dim (reference ``nn/SoftMin.scala``)."""

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return torch.softmax(-input, dim=-1)


class LogSoftMax(Module):
    """log-softmax over the last dim (reference ``nn/LogSoftMax.scala``)."""

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(input, dim=-1)


class SoftPlus(_Elementwise):
    """log(1 + exp(beta * x)) / beta (reference ``nn/SoftPlus.scala``), as
    ``logaddexp(beta * x, 0)``: no linear cut-off past a threshold, as in
    the JAX package."""

    def __init__(self, beta: float = 1.0):
        super().__init__()
        self.beta = beta

    def _fn(self, x):
        return torch.logaddexp(self.beta * x, torch.zeros_like(x)) / self.beta


class SoftSign(_Elementwise):
    """x / (1 + |x|) (reference ``nn/SoftSign.scala``)."""

    def _fn(self, x):
        return x / (1.0 + torch.abs(x))


class SoftShrink(_Elementwise):
    """x - lambd above lambd, x + lambd below -lambd, 0 between
    (reference ``nn/SoftShrinkage.scala``)."""

    def __init__(self, lambd: float = 0.5):
        super().__init__()
        self.lambd = lambd

    def _fn(self, x):
        zero = torch.zeros_like(x)
        return torch.where(x > self.lambd, x - self.lambd,
                           torch.where(x < -self.lambd, x + self.lambd,
                                       zero))


class HardShrink(_Elementwise):
    """0 inside [-lambd, lambd], x outside (reference
    ``nn/HardShrink.scala``)."""

    def __init__(self, lambd: float = 0.5):
        super().__init__()
        self.lambd = lambd

    def _fn(self, x):
        return torch.where(torch.abs(x) > self.lambd, x, torch.zeros_like(x))


class HardTanh(_Elementwise):
    """x clipped to [min_value, max_value] (reference ``nn/HardTanh.scala``)."""

    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 inplace: bool = False):
        super().__init__()
        self.min_value, self.max_value = min_value, max_value

    def _fn(self, x):
        return torch.clamp(x, self.min_value, self.max_value)


class Clamp(HardTanh):
    """HardTanh with bounds that must be given (reference ``nn/Clamp.scala``)."""

    def __init__(self, min_value: float, max_value: float):
        super().__init__(min_value, max_value)


class Threshold(Module):
    """x if x > th else v (reference ``nn/Threshold.scala``)."""

    layout_role = "agnostic"

    def __init__(self, th: float = 1e-6, v: float = 0.0, ip: bool = False):
        super().__init__()
        self.th, self.v = th, v

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return F.threshold(input, self.th, self.v)


class Power(_Elementwise):
    """(shift + scale * x) ** power (reference ``nn/Power.scala``)."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0):
        super().__init__()
        self.power, self.scale, self.shift = power, scale, shift

    def _fn(self, x):
        return torch.pow(self.shift + self.scale * x, self.power)


class Sqrt(_Elementwise):
    """Elementwise square root (reference ``nn/Sqrt.scala``)."""

    def _fn(self, x):
        return torch.sqrt(x)


class Square(_Elementwise):
    """Elementwise square (reference ``nn/Square.scala``)."""

    def _fn(self, x):
        return x * x


class Abs(_Elementwise):
    """Elementwise absolute value (reference ``nn/Abs.scala``)."""

    def _fn(self, x):
        return torch.abs(x)


class Log(_Elementwise):
    """Elementwise natural log (reference ``nn/Log.scala``)."""

    def _fn(self, x):
        return torch.log(x)


class Exp(_Elementwise):
    """Elementwise exponential (reference ``nn/Exp.scala``)."""

    def _fn(self, x):
        return torch.exp(x)


class Negative(_Elementwise):
    """Elementwise negation (reference ``nn/Negative.scala``)."""

    def _fn(self, x):
        return -x


class PReLU(Module):
    """ReLU with a learnable negative slope (reference ``nn/PReLU.scala``):
    ``n_output_plane`` 0 shares one slope, else one a channel (dim 1 of a
    2-D or a 4-D-or-more input, dim 0 otherwise, as in the JAX package).
    The slopes start at 0.25 unless ``init_weight`` is given."""

    def __init__(self, n_output_plane: int = 0, init_weight=None,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.n_output_plane = n_output_plane
        if init_weight is not None:
            w = torch.as_tensor(init_weight, dtype=torch.float32).reshape(-1)
        else:
            w = torch.full((max(1, n_output_plane),), 0.25)
        self.weight = nn.Parameter(w.clone().to(device))

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.n_output_plane > 0:
            ch = 1 if input.dim() > 3 or input.dim() == 2 else 0
            shape = [1] * input.dim()
            shape[ch] = w.shape[0]
            w = w.reshape(shape)
        return torch.where(input >= 0, input, input * w)


class _Stochastic(Module):
    """A layer that draws from the random stream in training."""

    stochastic = True

    def __init__(self):
        super().__init__()
        self.generator: Optional[torch.Generator] = None

    def _drawing(self) -> bool:
        return self.training and self.generator is not None


class RReLU(_Stochastic):
    """Randomised leaky ReLU (reference ``nn/RReLU.scala``): in training
    with a stream, each negative element's slope is drawn U(lower, upper);
    otherwise the slope is their mean."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 inplace: bool = False):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        if self._drawing():
            slope = torch.empty_like(input).uniform_(
                self.lower, self.upper, generator=self.generator)
        else:
            slope = (self.lower + self.upper) / 2.0
        return torch.where(input >= 0, input, input * slope)


class Dropout(Module):
    """Inverted dropout (reference ``nn/Dropout.scala:44``): in training,
    each element is kept with probability 1 - p and, with ``scale``,
    divided by 1 - p.  The identity in eval mode, at p = 0 and without a
    random stream.

    The mask is drawn from ``generator``, which the trainer sets for each
    step (:func:`bigdl_tpu_torch.nn.module.random_stream`), never from the
    global generator.  Its bits are torch's, not the JAX package's
    threefry ones."""

    layout_role = "agnostic"
    stochastic = True

    def __init__(self, init_p: float = 0.5, inplace: bool = False,
                 scale: bool = True):
        super().__init__()
        self.p = init_p
        self.scale = scale
        self.generator: Optional[torch.Generator] = None

    def set_p(self, p: float) -> "Dropout":
        self.p = p
        return self

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p <= 0.0 or self.generator is None:
            return input
        keep = 1.0 - self.p
        mask = torch.empty_like(input).bernoulli_(keep,
                                                  generator=self.generator)
        out = input * mask
        return out / keep if self.scale else out


class GaussianDropout(_Stochastic):
    """Multiplicative noise (reference ``nn/GaussianDropout.scala``): in
    training with a stream, x * (1 + sqrt(rate / (1 - rate)) * N(0, 1));
    the identity otherwise."""

    layout_role = "agnostic"

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        if not self._drawing():
            return input
        stddev = (self.rate / (1.0 - self.rate)) ** 0.5
        noise = torch.empty_like(input).normal_(generator=self.generator)
        return input * (1.0 + stddev * noise)


class GaussianNoise(_Stochastic):
    """Additive noise (reference ``nn/GaussianNoise.scala``): in training
    with a stream, x + stddev * N(0, 1); the identity otherwise."""

    layout_role = "agnostic"

    def __init__(self, stddev: float):
        super().__init__()
        self.stddev = stddev

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        if not self._drawing():
            return input
        noise = torch.empty_like(input).normal_(generator=self.generator)
        return input + self.stddev * noise


class _L1PenaltyFn(torch.autograd.Function):
    """The identity whose gradient gains ``m * sign(x)`` (the JAX
    package's custom VJP)."""

    @staticmethod
    def forward(ctx, x, m):
        ctx.save_for_backward(x)
        ctx.m = m
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g + ctx.m * torch.sign(x), None


class L1Penalty(Module):
    """The identity forward that adds an L1 sparsity gradient in training
    (reference ``nn/L1Penalty.scala``): the input's gradient gains
    ``l1weight * sign(x)`` (divided by the element count with
    ``size_average``)."""

    def __init__(self, l1weight: float, size_average: bool = False,
                 provide_output: bool = True):
        super().__init__()
        self.l1weight = l1weight
        self.size_average = size_average

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return input
        m = (self.l1weight / input.numel() if self.size_average
             else self.l1weight)
        return _L1PenaltyFn.apply(input, m)
