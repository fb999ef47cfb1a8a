"""The Torch-style module shell of the port (``bigdl_tpu/nn/module.py``:
``Module`` :119, ``Criterion`` :515, ``Container`` :546, ``Sequential``
:645).

In the JAX package a module is a pure ``apply`` over a parameter pytree that
the shell keeps beside it.  Here a module is a ``torch.nn.Module`` that owns
its parameters; ``forward`` takes the input.  A container keeps its children
in an ordered list, ``layers`` (``torch.nn.Module.children`` is a method, so
the JAX package's ``children`` attribute takes this name); the JAX parameter
pytree of a container is the list of its children's, in the same order, which
is what :func:`bigdl_tpu_torch.utils.convert.params_from_jax` walks.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def make_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """The CPU generator a module draws its initial parameters from: the
    caller's, or a fresh one seeded with 0.  Parameters are drawn on the
    CPU and then moved, so a seed gives the same weights on every device,
    and the global RNG is never touched."""
    return generator if generator is not None else \
        torch.Generator().manual_seed(0)


class Module(nn.Module):
    """Base class of the port's layers: a ``torch.nn.Module`` with the
    reference's ``evaluate()`` switch."""

    def evaluate(self) -> "Module":
        """Inference mode (reference ``evaluate()``); ``train()`` undoes it."""
        return self.eval()


class Criterion:
    """Loss base class (reference ``nn/abstractnn/AbstractCriterion.scala:49``).

    ``apply(input, target)`` is the loss as a scalar tensor.  The shell
    mirrors the reference: ``forward`` caches ``output``; ``backward`` is the
    gradient of the loss with respect to the input, taken with
    ``torch.autograd.grad``, cached as ``grad_input``."""

    def __init__(self):
        self.output = None
        self.grad_input = None
        self.size_average = True

    def apply(self, input, target) -> torch.Tensor:
        raise NotImplementedError(type(self).__name__)

    def forward(self, input, target) -> torch.Tensor:
        self.output = self.apply(input, target)
        return self.output

    def backward(self, input: torch.Tensor, target) -> torch.Tensor:
        x = input.detach().requires_grad_(True)
        with torch.enable_grad():
            (self.grad_input,) = torch.autograd.grad(self.apply(x, target), x)
        return self.grad_input

    def __call__(self, input, target) -> torch.Tensor:
        return self.forward(input, target)


class Container(Module):
    """Module with an ordered list of children (reference
    ``nn/Container.scala:40``)."""

    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleList()

    def add(self, module: nn.Module) -> "Container":
        self.layers.append(module)
        return self

    def __len__(self) -> int:
        return len(self.layers)


class Sequential(Container):
    """Ordered pipeline (reference ``nn/Sequential.scala:30``)."""

    def forward(self, input):
        x = input
        for layer in self.layers:
            x = layer(x)
        return x
