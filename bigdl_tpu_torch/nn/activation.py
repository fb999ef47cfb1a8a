"""Activation layers (``bigdl_tpu/nn/activation.py``: ``ReLU`` :30,
``Tanh`` :70, ``LogSoftMax`` :116)."""

from __future__ import annotations

import torch

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
