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

import contextlib
from typing import Dict, List, Optional

import torch
from torch import nn


def make_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """The CPU generator a module draws its initial parameters from: the
    caller's, or a fresh one seeded with 0.  Parameters are drawn on the
    CPU and then moved, so a seed gives the same weights on every device,
    and the global RNG is never touched."""
    return generator if generator is not None else \
        torch.Generator().manual_seed(0)


def state_buffers(module: nn.Module) -> Dict[str, torch.Tensor]:
    """A module's own state, the twin of the JAX package's module state
    (BatchNorm's running statistics): its persistent buffers.  A
    non-persistent buffer, such as a positional-encoding table, is a
    constant."""
    return {k: b for k, b in module.named_buffers(recurse=False)
            if k not in module._non_persistent_buffers_set}


def semantic_state_leaves(module: nn.Module) -> List[torch.Tensor]:
    """The state tensors of ``module`` that must thread across steps: every
    module's :func:`state_buffers` but the per-forward diagnostics it
    declares in ``diagnostic_state_keys`` (``bigdl_tpu/nn/module.py:58``).
    The exclusion is the declaring module's alone: another module keeping
    real state under the same name still counts."""
    return [b for m in module.modules()
            for k, b in state_buffers(m).items()
            if k not in (getattr(m, "diagnostic_state_keys", ()) or ())]


def collect_diagnostics(module: nn.Module, key: str) -> List[torch.Tensor]:
    """The per-forward diagnostic ``key`` of every module of ``module``
    that declares it (``bigdl_tpu/nn/module.py:92``), as the last forward
    left it, still in the autograd graph: the trainers fold MoE's
    ``aux_loss`` into the loss with it.  A module keeps its live values
    in ``_diagnostics``."""
    return [m._diagnostics[key] for m in module.modules()
            if key in (getattr(m, "diagnostic_state_keys", ()) or ())
            and key in (getattr(m, "_diagnostics", None) or {})]


def is_stochastic(model: nn.Module) -> bool:
    """Some module of ``model`` draws from the random stream in training."""
    return any(getattr(m, "stochastic", False) for m in model.modules())


@contextlib.contextmanager
def random_stream(model: nn.Module, generator: torch.Generator):
    """For the block, every stochastic module of ``model`` draws from
    ``generator``, in the order the forward reaches them; after it, they
    have no stream again.  The trainer's per-step stream (the JAX
    package passes ``rng`` down ``apply`` instead): a module without one
    draws nothing, as the JAX package's ``Dropout`` with ``rng=None``."""
    mods = [m for m in model.modules() if getattr(m, "stochastic", False)]
    for m in mods:
        m.generator = generator
    try:
        yield
    finally:
        for m in mods:
            m.generator = None


class Module(nn.Module):
    """Base class of the port's layers: a ``torch.nn.Module`` with the
    reference's ``evaluate()`` switch and data-layout contract.

    ``layout_role`` says how a layer relates to the layout of image
    activations (:mod:`bigdl_tpu_torch.nn.layout`): ``"opaque"`` (the
    default: it must see NCHW-ordered memory), ``"agnostic"`` (elementwise:
    any memory format passes through) or ``"spatial"`` (it consumes image
    maps in ``self.format`` and is re-pointed by :meth:`set_format`)."""

    layout_role = "opaque"
    #: gradient scales of this layer's weights and of its bias (reference
    #: ``setScaleW``/``setScaleB``): the trainers multiply the layer's
    #: parameter gradients by them before the update
    scale_w = 1.0
    scale_b = 1.0
    #: a training-mode forward draws from the random stream
    #: (:func:`random_stream`); the twin of the JAX package's
    #: ``is_stochastic`` layers (``Dropout``)
    stochastic = False

    def is_stochastic(self) -> bool:
        """True if this module or one inside it draws from the random
        stream in training (reference ``Module.is_stochastic``)."""
        return is_stochastic(self)

    def set_format(self, format: str) -> "Module":
        """Re-point a spatial layer between ``"NCHW"`` and ``"NHWC"``."""
        if self.layout_role != "spatial":
            raise TypeError(f"{type(self).__name__} has no data format "
                            f"(layout_role={self.layout_role!r})")
        if format not in ("NCHW", "NHWC"):
            raise ValueError(f"unknown data format {format!r}: expected "
                             "'NCHW' or 'NHWC'")
        self.format = format
        return self

    def set_scale_w(self, w: float) -> "Module":
        self.scale_w = float(w)
        return self

    def set_scale_b(self, b: float) -> "Module":
        self.scale_b = float(b)
        return self

    def evaluate(self) -> "Module":
        """Inference mode (reference ``evaluate()``); ``train()`` undoes it."""
        return self.eval()


def grad_scales(model: nn.Module, params) -> Optional[list]:
    """Each of ``params``' gradient scale (its layer's ``scale_b`` for a
    parameter named ``bias``, else ``scale_w``; the twin of the JAX
    package's ``Module._scale_grads``, ``nn/module.py:312``), or None when
    every scale is 1."""
    by_id = {}
    for m in model.modules():
        for name, p in m.named_parameters(recurse=False):
            by_id[id(p)] = float(getattr(m, "scale_b" if name == "bias"
                                         else "scale_w", 1.0))
    scales = [by_id.get(id(p), 1.0) for p in params]
    return None if all(s == 1.0 for s in scales) else scales


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
