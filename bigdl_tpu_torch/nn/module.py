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

The imperative shell (reference ``AbstractModule.scala:54``; the JAX
package's ``nn/module.py:236-470``) drives one module by hand:
``update_output``, ``backward`` (updateGradInput and accGradParameters in
one pass), ``update_grad_input``, ``acc_grad_parameters``,
``zero_grad_parameters``, ``update_parameters``, ``get_parameters``,
``set_flat_parameters``, ``n_parameters``, ``get_parameters_table``,
``clone_module``, the forward/backward timing and ``inputs()``.  The
trainers never call it.  Where ``torch.nn.Module`` already owns a name, the
name keeps torch's meaning:

- ``forward`` is torch's, called by ``__call__``; ``update_output`` is the
  reference's stateful forward (it caches ``output``, times the call and,
  for a stochastic module in training without a random stream, draws from
  a fresh one, as the JAX shell draws a fresh key);
- ``parameters()``, ``modules()`` and ``apply(fn)`` are torch's; the
  reference's ``parameters()``, the pair (parameters, gradients), is
  :meth:`Module.params_and_grads`;
- ``training`` is torch's boolean; ``train()`` and ``evaluate()`` switch
  the mode.

A parameter's gradient lives in its ``.grad``.  ``backward`` recomputes the
forward from ``input`` (the JAX shell takes ``jax.vjp`` of ``apply``): the
recompute leaves the module's buffers as it found them (BatchNorm's running
statistics are updated once, by the forward, not again), and the
stochastic layers draw again what the last ``update_output`` drew, from its
stream wound back (:func:`random_stream`).  In training BatchNorm
normalises with the batch's statistics, so the recompute's output is the
forward's.  The flat vectors of ``get_parameters`` are in the JAX
package's order and layout: the leaves of its parameter pytree (a layer's
entries by sorted name, a container's children in order), each in the JAX
layout (:mod:`bigdl_tpu_torch.utils.convert`), so that a flat vector means
the same in both packages.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from bigdl_tpu_torch.engine import tree_leaves, tree_map


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
    #: the declared IO contract (:class:`~bigdl_tpu_torch.analysis.
    #: contracts.ModuleContract`) that :func:`~bigdl_tpu_torch.analysis.
    #: check_model` verifies at zero FLOPs: a class attribute for a layer
    #: kind, :meth:`set_contract` for one instance
    contract = None

    def set_contract(self, **kwargs) -> "Module":
        """Attach a per-instance IO contract, e.g.
        ``m.set_contract(input_ndim=(2, 3), dtypes="float")`` (the JAX
        package's ``declare_contract``)."""
        from bigdl_tpu_torch.analysis.contracts import ModuleContract
        self.contract = ModuleContract(**kwargs)
        return self

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

    # ---- the imperative shell --------------------------------------------

    #: the shell's caches (reference ``AbstractModule.output/gradInput``)
    output: Any = None
    grad_input: Any = None
    #: nanoseconds spent in ``update_output`` and in the shell's backward
    #: passes (reference ``AbstractModule:193-204``)
    forward_time: int = 0
    backward_time: int = 0
    #: the device and state of the stream the last ``update_output`` drew
    #: from, which the shell's recompute winds back to; None: it drew none
    _shell_stream: Optional[Tuple[torch.device, torch.Tensor]] = None
    _shell_draws = itertools.count(1)

    def update_output(self, input):
        """The reference's stateful forward (``AbstractModule.forward:213``):
        ``self(input)``, cached as ``output``, its wall time (the device
        synchronised) added to ``forward_time``.  A stochastic module in
        training whose layers have no random stream draws from a fresh
        one on the input's device, seeded from ``RandomGenerator``'s seed
        and a count of such calls; ``backward`` replays it.  The forward
        runs without autograd: ``backward`` recomputes it."""
        mods = [m for m in self.modules() if getattr(m, "stochastic", False)]
        stream = None
        self._shell_stream = None
        if self.training and mods and all(
                getattr(m, "generator", None) is None for m in mods):
            from bigdl_tpu_torch.utils.random_generator import \
                RandomGenerator
            seed = np.random.SeedSequence(
                [RandomGenerator.RNG().get_seed(), next(Module._shell_draws)]
            ).generate_state(1)[0]
            on = [t.device for t in tree_leaves(input)
                  if isinstance(t, torch.Tensor)]
            stream = torch.Generator(device=on[0] if on
                                     else _device_of(self))
            stream.manual_seed(int(seed))
            self._shell_stream = (stream.device, stream.get_state())
        t0 = time.perf_counter_ns()
        with torch.no_grad(), (contextlib.nullcontext() if stream is None
                               else random_stream(self, stream)):
            out = self(input)
        _sync(out)
        self.forward_time += time.perf_counter_ns() - t0
        self.output = out
        return out

    def backward(self, input, grad_output):
        """updateGradInput and accGradParameters in one pass (reference
        ``AbstractModule.backward:231``): the gradient of ``input`` is
        returned and cached as ``grad_input``; each parameter's gradient,
        times the scales (:meth:`_scale_grads`), is added to its
        ``.grad``."""
        t0 = time.perf_counter_ns()
        gin, pgrads = self._vjp(input, grad_output, True, True)
        self._accumulate(pgrads)
        _sync(gin)
        self.backward_time += time.perf_counter_ns() - t0
        self.grad_input = gin
        return gin

    def update_grad_input(self, input, grad_output):
        """The gradient of ``input`` only; every ``.grad`` is left as it
        is."""
        gin, _ = self._vjp(input, grad_output, True, False)
        self.grad_input = gin
        return gin

    def acc_grad_parameters(self, input, grad_output) -> None:
        """Add the parameters' gradients, times the scales, to their
        ``.grad`` (reference ``accGradParameters``)."""
        _, pgrads = self._vjp(input, grad_output, False, True)
        self._accumulate(pgrads)

    def _vjp(self, input, grad_output, wrt_input: bool, wrt_params: bool):
        """The forward recomputed from ``input`` under autograd
        (:meth:`_recompute`), then one ``torch.autograd.grad`` of its
        outputs against ``grad_output``: (the input's gradient, a tree
        like ``input`` with zeros for leaves it does not reach, or None;
        each parameter's gradient, or [])."""
        x = tree_map(lambda t: t.detach().requires_grad_(wrt_input)
                     if _is_float(t) else t, input)
        params = [p for p in self.parameters() if p.requires_grad] \
            if wrt_params else []
        xs = [t for t in tree_leaves(x) if _is_float(t)] if wrt_input else []
        wrt = xs + params
        grads = [None] * len(wrt)
        # the buffers go back after the gradient: a training-mode
        # BatchNorm's backward reads the statistics it saw
        with torch.enable_grad(), self._recompute():
            out = self(x)
            pairs = [(o, g) for o, g in zip(tree_leaves(out),
                                             tree_leaves(grad_output))
                     if isinstance(o, torch.Tensor) and o.requires_grad]
            if pairs and wrt:
                grads = list(torch.autograd.grad(
                    [o for o, _ in pairs], wrt, [g for _, g in pairs],
                    allow_unused=True))
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, wrt)]
        gin = None
        if wrt_input:
            by_id = {id(t): g for t, g in zip(xs, grads)}
            gin = tree_map(lambda t: by_id[id(t)] if id(t) in by_id
                           else _zeros_for(t), x)
        return gin, grads[len(xs):]

    @contextlib.contextmanager
    def _recompute(self):
        """The shell's recompute of the forward: every module's buffers
        are put back after it (a training-mode BatchNorm updates its
        running statistics in the forward, not again here), and the
        stochastic layers draw from the last ``update_output``'s stream
        wound back to where that forward started."""
        saved = [(b, b.clone()) for m in self.modules()
                 for b in state_buffers(m).values()]
        mods = [m for m in self.modules() if getattr(m, "stochastic", False)]
        streams = [(m, m.generator) for m in mods]
        if self._shell_stream is not None and self.training:
            device, state = self._shell_stream
            g = torch.Generator(device=device)
            g.set_state(state)
            for m in mods:
                m.generator = g
        try:
            yield
        finally:
            with torch.no_grad():
                for b, kept in saved:
                    b.copy_(kept)
            for m, g in streams:
                m.generator = g

    def _scale_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The reference's ``_scale_grads`` (``nn/module.py:312``): this
        module's ``scale_b`` for a parameter named ``bias``, its
        ``scale_w`` for every other, over the whole tree it owns (the
        trainers scale each layer's parameters by that layer's own,
        :func:`grad_scales`)."""
        if self.scale_w == 1.0 and self.scale_b == 1.0:
            return grads
        names = [n for n, p in self.named_parameters() if p.requires_grad]
        return [g * (self.scale_b if n.rsplit(".", 1)[-1] == "bias"
                     else self.scale_w) for n, g in zip(names, grads)]

    @torch.no_grad()
    def _accumulate(self, grads: List[torch.Tensor]) -> None:
        params = [p for p in self.parameters() if p.requires_grad]
        for p, g in zip(params, self._scale_grads(grads), strict=True):
            if p.grad is None:
                p.grad = g.detach().clone()
            else:
                p.grad.add_(g)

    @torch.no_grad()
    def zero_grad_parameters(self) -> None:
        """Every parameter's ``.grad`` to zeros (allocated where it has
        none, so that ``get_parameters`` always has a gradient)."""
        for p in self.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()

    @torch.no_grad()
    def update_parameters(self, learning_rate: float) -> None:
        """Plain SGD in place, ``p -= learning_rate * grad`` (reference
        ``updateParameters``), as :class:`~bigdl_tpu_torch.optim.SGD`
        without momentum or decay computes it (``p + (-lr) * g``)."""
        pairs = [(p, p.grad) for p in self.parameters() if p.grad is not None]
        if pairs:
            torch._foreach_add_([p for p, _ in pairs], [g for _, g in pairs],
                                alpha=-learning_rate)

    def params_and_grads(self) -> Tuple[List[torch.Tensor],
                                        List[torch.Tensor]]:
        """The reference's ``parameters()``: (the parameters, their
        gradients, zeros where none), in ``parameters()`` order."""
        params = list(self.parameters())
        return params, [torch.zeros_like(p) if p.grad is None else p.grad
                        for p in params]

    def get_parameters(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat copies of the weights and of the gradients (reference
        ``getParameters()``), in the JAX package's leaf order and layout,
        on the module's device."""
        from bigdl_tpu_torch.utils import convert
        device = _device_of(self)
        return tuple(torch.from_numpy(_flatten(tree)).to(device)
                     for tree in (convert.params_to_jax(self),
                                  convert.grads_to_jax(self)))

    def set_flat_parameters(self, flat) -> None:
        """Write a flat vector in :meth:`get_parameters`' order and layout
        back into the parameters."""
        from bigdl_tpu_torch.utils import convert
        flat = (flat.detach().cpu().numpy() if isinstance(flat, torch.Tensor)
                else np.asarray(flat))
        tree = convert.params_to_jax(self)
        convert.params_from_jax(_unflatten(tree, flat), self)

    def n_parameters(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def get_parameters_table(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{layer: {parameter name: parameter}} for every layer with
        parameters of its own (reference ``getParametersTable()``), keyed by
        the layer's path in ``named_modules()`` (the root by its class
        name)."""
        out = {}
        for path, m in self.named_modules():
            own = dict(m.named_parameters(recurse=False))
            if own and not isinstance(m, Container):
                out[path or type(m).__name__] = own
        return out

    def get_times(self) -> List[Tuple[nn.Module, int, int]]:
        return [(m, getattr(m, "forward_time", 0),
                 getattr(m, "backward_time", 0)) for m in self.modules()]

    def reset_times(self) -> None:
        for m in self.modules():
            if isinstance(m, Module):
                m.forward_time = 0
                m.backward_time = 0

    def clone_module(self) -> "Module":
        """A deep copy (reference ``cloneModule:353``)."""
        return copy.deepcopy(self)

    def inputs(self, *nodes):
        """A graph node of this module fed by ``nodes`` (reference
        ``AbstractModule.inputs:539``)."""
        from bigdl_tpu_torch.nn.graph import ModuleNode
        return ModuleNode(self).inputs(*nodes)


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def _zeros_for(t):
    return torch.zeros_like(t) if isinstance(t, torch.Tensor) else t


def _jax_leaves(tree) -> list:
    """A parameter tree's leaves in ``jax.tree_util.tree_leaves`` order: a
    dict's by sorted key, a list's in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _jax_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _jax_leaves(v)]
    return [tree]


def _flatten(tree) -> np.ndarray:
    """A JAX-layout numpy tree as one vector, in :func:`_jax_leaves`
    order."""
    leaves = [np.ravel(np.asarray(x)) for x in _jax_leaves(tree)]
    return (np.concatenate(leaves) if leaves
            else np.zeros((0,), np.float32)).copy()


def _unflatten(tree, flat: np.ndarray):
    """The inverse of :func:`_flatten` on a tree of the same shapes."""
    off = [0]

    def take(x):
        x = np.asarray(x)
        n = x.size
        out = flat[off[0]:off[0] + n].reshape(x.shape).astype(x.dtype)
        off[0] += n
        return out

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return take(t)

    out = walk(tree)
    if off[0] != flat.size:
        raise ValueError(f"flat vector of {flat.size} values for "
                         f"{off[0]} parameters")
    return out


def _device_of(module: nn.Module) -> torch.device:
    for t in itertools.chain(module.parameters(), module.buffers()):
        return t.device
    return torch.device("cpu")


def _sync(out) -> None:
    """Wait for the device, for an honest shell timing (the JAX shell's
    ``block_until_ready``)."""
    if any(isinstance(t, torch.Tensor) and t.is_cuda
           for t in tree_leaves(out)):
        torch.cuda.synchronize()


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
    gradient of the loss with respect to the input (a tensor, or a table of
    them, whose non-floating leaves get zeros), taken with
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

    def backward(self, input, target):
        x = tree_map(lambda t: t.detach().requires_grad_(True)
                     if _is_float(t) else t, input)
        xs = [t for t in tree_leaves(x) if _is_float(t)]
        with torch.enable_grad():
            loss = self.apply(x, target)
            grads = (torch.autograd.grad(loss, xs, allow_unused=True)
                     if loss.requires_grad else [None] * len(xs))
        by_id = {id(t): torch.zeros_like(t) if g is None else g
                 for t, g in zip(xs, grads)}
        self.grad_input = tree_map(
            lambda t: by_id[id(t)] if id(t) in by_id else _zeros_for(t), x)
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
