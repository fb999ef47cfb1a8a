"""Activation layers (``bigdl_tpu/nn/activation.py``: ``ReLU`` :30,
``Tanh`` :70, ``LogSoftMax`` :116, ``Threshold`` :185, ``Dropout`` :298)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module


class ReLU(Module):
    """Rectified linear max(x, 0) (reference ``nn/ReLU.scala``)."""

    layout_role = "agnostic"

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return torch.relu(input)


class Tanh(Module):
    """Elementwise tanh (reference ``nn/Tanh.scala``)."""

    layout_role = "agnostic"

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return torch.tanh(input)


class LogSoftMax(Module):
    """log-softmax over the last dim (reference ``nn/LogSoftMax.scala``)."""

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(input, dim=-1)


class Threshold(Module):
    """x if x > th else v (reference ``nn/Threshold.scala``)."""

    layout_role = "agnostic"

    def __init__(self, th: float = 1e-6, v: float = 0.0, ip: bool = False):
        super().__init__()
        self.th, self.v = th, v

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return F.threshold(input, self.th, self.v)


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
