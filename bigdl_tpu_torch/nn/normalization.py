"""Normalisation layers (``bigdl_tpu/nn/normalization.py``:
``BatchNormalization`` :27, ``SpatialBatchNormalization`` :106,
``SpatialCrossMapLRN`` :144; reference ``nn/BatchNormalization.scala:50``,
``nn/SpatialCrossMapLRN.scala``).

The JAX package threads the running statistics through ``apply`` as module
state.  Here they are registered buffers, ``running_mean`` and
``running_var`` (no ``num_batches_tracked``), that ``F.batch_norm`` updates
in place during a training-mode forward, with the reference's convention:
``running = (1 - momentum) * running + momentum * batch``, the variance
made unbiased by n / (n - 1); the batch is normalised with its biased
variance.  Eval mode normalises with the running statistics.

Precision: the statistics stay float32 under a bf16 forward, as the JAX
package keeps module state in fp32.  The affine weight and bias enter
``F.batch_norm`` in the statistics' dtype: under
:func:`bigdl_tpu_torch.optim.optimizer.mixed_precision_forward` they arrive
rounded to bf16 (as the JAX package casts them) and are widened back, since
torch's CUDA kernel takes a bf16 input only beside fp32 (or all-bf16)
weight and statistics.  The normalisation then runs in fp32 and its output
is rounded to the input's dtype once, where the JAX package computes it in
bf16.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.module import Module, make_generator


def _vector(value, default: torch.Tensor) -> torch.Tensor:
    return default if value is None else torch.as_tensor(
        value, dtype=torch.float32).reshape(default.shape).clone()


class BatchNormalization(Module):
    """BN over dim 1 of an (N, C) input.  The affine weight is drawn
    U(0, 1) from the generator and the bias is 0, as in the JAX package,
    unless ``init_weight``/``init_bias`` are given; ``init_running_mean``/
    ``init_running_var`` seed the statistics (default 0 and 1)."""

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 init_weight=None, init_bias=None,
                 init_running_mean=None, init_running_var=None,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        if affine:
            w = (torch.rand(n_output, generator=make_generator(generator))
                 if init_weight is None
                 else _vector(init_weight, torch.empty(n_output)))
            self.weight = nn.Parameter(w.to(device))
            self.bias = nn.Parameter(
                _vector(init_bias, torch.zeros(n_output)).to(device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", _vector(
            init_running_mean, torch.zeros(n_output)).to(device))
        self.register_buffer("running_var", _vector(
            init_running_var, torch.ones(n_output)).to(device))

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        dtype = self.running_mean.dtype
        weight = None if self.weight is None else self.weight.to(dtype)
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.batch_norm(input, self.running_mean, self.running_var,
                            weight, bias, self.training, self.momentum,
                            self.eps)


class SpatialBatchNormalization(BatchNormalization):
    """BN over the channels of (N, C, H, W) maps, in either memory format
    (``format`` records which, :mod:`bigdl_tpu_torch.nn.layout`)."""

    layout_role = "spatial"

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 init_weight=None, init_bias=None, init_running_mean=None,
                 init_running_var=None, format: str = "NCHW",
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(n_output, eps, momentum, affine, init_weight,
                         init_bias, init_running_mean, init_running_var,
                         device=device, generator=generator)
        self.format = format


class SpatialCrossMapLRN(Module):
    """AlexNet-style local response normalisation across channels
    (reference ``nn/SpatialCrossMapLRN.scala``): x / (k + alpha / size *
    window)^beta, where ``window`` sums x^2 over ``size`` neighbouring
    channels, ``(size - 1) // 2`` before and the rest after, zero past the
    edges (the JAX package's padding; torch's ``local_response_norm``
    puts ``size // 2`` before, which differs for an even size).  Computed
    in the input's dtype.  Shapes are logical, so the channels are dim 1
    (dim 0 of an unbatched map) in either memory format, and the output
    keeps the input's."""

    layout_role = "spatial"

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75,
                 k: float = 1.0, format: str = "NCHW"):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.format = format

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        ch = input.dim() - 3
        c = input.shape[ch]
        half = (self.size - 1) // 2
        # F.pad's last pair pads the channels of a (..., C, H, W) map
        padded = F.pad(input * input,
                       (0, 0, 0, 0, half, self.size - 1 - half))
        window = padded.narrow(ch, 0, c)
        for i in range(1, self.size):
            window = window + padded.narrow(ch, i, c)
        denom = (self.k + self.alpha / self.size * window) ** self.beta
        return input / denom
