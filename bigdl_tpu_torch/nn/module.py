"""The Torch-style module shell of the port (``bigdl_tpu/nn/module.py``:
``Module`` :119, ``Container`` :546, ``Sequential`` :645).

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
