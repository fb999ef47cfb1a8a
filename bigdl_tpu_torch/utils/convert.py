"""Carry parameters and module state between the JAX package's layout and
the port's model.

Initial weights cannot match across the two frameworks (``jax.random`` and
``torch.Generator`` draw different numbers), so every comparison of the port
with the JAX package builds both models and carries the JAX parameters over
(:func:`params_from_jax`) with the module state, BatchNorm's running
statistics (:func:`state_from_jax`); :func:`params_to_jax` and
:func:`state_to_jax` read the port's back in the JAX layout, to compare
trained models.

Two trees in the JAX package mirror the module tree: ``model.params`` and
``model.state``.  A container's entry is the list of its children's; a
leaf's is a dict keyed by the port's parameter (or buffer) names.  Two
layouts differ: ``Linear`` weights are (in, out) in the JAX package and
(out, in) here; ``SpatialConvolution`` weights are HWIO (kh, kw, in/groups,
out) there and (out, in/groups, kh, kw) here.  A JAX model built with
``layout="NCHW"`` has no channels-last boundary modules; its trees are also
accepted by a port model built with ``layout="NHWC"``, whose boundary
modules hold nothing (:mod:`bigdl_tpu_torch.nn.layout`).  A
``MixtureOfExperts`` entry is ``{"gate": ..., "experts": tree}``, the
expert template's tree with a leading expert dim on every leaf (the
layouts above apply behind it), and its state ``{"expert": tree,
"aux_loss": scalar}``.  ``Remat`` is a container of one child in both
packages, as are ``ParallelTable``, ``MapTable`` (its one shared child) and
``Graph`` (its nodes' modules in topological order, the order the JAX
``Graph`` indexes ``params[i]`` by).  The rest of the layer library keeps
the JAX package's layouts (``PReLU``, ``Bilinear``, ``Add``, ``Mul``,
``CMul``, ``CAdd``, ``Euclidean``, ``Cosine``, ``Scale``).  A pipeline's stacked stage tree (the JAX package's
``stack_stage_params``: every leaf with a leading stage dim) goes to and
from a list of the port's per-stage blocks.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch
from torch import nn

from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.layout import NCHWToNHWC, NHWCToNCHW
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Container, state_buffers

#: port layout <- JAX layout, per (layer type, parameter name)
_FROM_JAX = {(Linear, "weight"): (1, 0),
             (SpatialConvolution, "weight"): (3, 2, 0, 1)}
#: JAX layout <- port layout
_TO_JAX = {(Linear, "weight"): (1, 0),
           (SpatialConvolution, "weight"): (2, 3, 1, 0)}


def _axes(table, module: nn.Module, key: str):
    return next((axes for (cls, name), axes in table.items()
                 if isinstance(module, cls) and name == key), None)


def _children(container: Container, jax_tree, what: str) -> List[nn.Module]:
    """The port children that ``jax_tree``'s list entries belong to: all of
    them, or those but the boundary modules when the JAX model was built
    without them (``layout="NCHW"``)."""
    name = type(container).__name__
    if not isinstance(jax_tree, (list, tuple)):
        raise ValueError(f"{name}: expected a list of child {what} trees, "
                         f"got {type(jax_tree).__name__}")
    kids = list(container.layers)
    if len(jax_tree) != len(kids):
        kids = [c for c in kids
                if not isinstance(c, (NCHWToNHWC, NHWCToNCHW))]
    if len(jax_tree) != len(kids):
        raise ValueError(f"{name}: expected {len(container.layers)} child "
                         f"{what} trees, got {len(jax_tree)}")
    return kids


def _copy(dst: torch.Tensor, value, what: str) -> None:
    value = np.asarray(value)
    if tuple(value.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: JAX value of shape {value.shape} does "
                         f"not fit {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(value)))


def _moe_entries(module, own):
    """A ``MixtureOfExperts``' entries, keyed as the JAX package keys
    them: (own entries, expert template, the stacked tensors by the
    template's names); the gradients of those for :func:`_grads`."""
    if own is _params:
        return ({"gate": module.gate}, module.expert,
                module.stacked_parameters())
    if own is _grads:
        return ({"gate": _grad(module.gate)}, module.expert,
                {k: _grad(v) for k, v in
                 module.stacked_parameters().items()})
    return ({"aux_loss": module.aux_loss}, module.expert, {})


def _load_stacked(jax_tree, template, stacked, what, lead=1):
    """Fill the stacked expert tensors (by template name) from a JAX tree
    whose leaves carry ``lead`` leading dims."""
    def walk(tree, mod, prefix):
        if isinstance(mod, Container):
            for i, (sub, child) in enumerate(zip(
                    tree, _children(mod, tree, what))):
                walk(sub, child, f"{prefix}layers.{i}.")
            return
        for key, value in tree.items():
            axes = _axes(_FROM_JAX, mod, key)
            value = np.asarray(value)
            if axes is not None:
                value = np.transpose(value, tuple(range(lead)) +
                                     tuple(a + lead for a in axes))
            _copy(stacked[prefix + key], value, f"experts.{prefix}{key}")
    walk(jax_tree, template, "")


def _dump_stacked(template, stacked, lead=1):
    def walk(mod, prefix):
        if isinstance(mod, Container):
            return [walk(c, f"{prefix}layers.{i}.")
                    for i, c in enumerate(mod.layers)]
        out = {}
        for key, _ in mod.named_parameters(recurse=False):
            value = stacked[prefix + key].detach().cpu().numpy()
            axes = _axes(_TO_JAX, mod, key)
            if axes is not None:
                value = np.transpose(value, tuple(range(lead)) +
                                     tuple(a + lead for a in axes))
            out[key] = np.array(value)
        return out
    return walk(template, "")


def _load(jax_tree: Any, module: nn.Module, what: str,
          own: Callable[[nn.Module], Dict[str, torch.Tensor]]) -> nn.Module:
    from bigdl_tpu_torch.nn.moe import MixtureOfExperts
    if isinstance(module, MixtureOfExperts):
        mine, template, stacked = _moe_entries(module, own)
        sub = "experts" if own is _params else "expert"
        if set(jax_tree) != set(mine) | {sub}:
            raise ValueError(f"MixtureOfExperts: JAX {what} entries "
                             f"{sorted(jax_tree)} do not match "
                             f"{sorted(set(mine) | {sub})}")
        for key, t in mine.items():
            _copy(t, jax_tree[key], f"MixtureOfExperts.{key}")
        if own is _params:
            _load_stacked(jax_tree[sub], template, stacked, what)
        return module
    if isinstance(module, Container):
        for sub, child in zip(jax_tree, _children(module, jax_tree, what)):
            _load(sub, child, what, own)
        return module
    name = type(module).__name__
    if not isinstance(jax_tree, dict):
        raise ValueError(f"{name}: expected a dict of {what} entries, got "
                         f"{type(jax_tree).__name__}")
    mine = own(module)
    if set(jax_tree) != set(mine):
        raise ValueError(f"{name}: JAX {what} entries {sorted(jax_tree)} "
                         f"do not match {sorted(mine)}")
    for key, value in jax_tree.items():
        axes = _axes(_FROM_JAX, module, key)
        if axes is not None:
            value = np.transpose(np.asarray(value), axes)
        _copy(mine[key], value, f"{name}.{key}")
    return module


def _dump(module: nn.Module,
          own: Callable[[nn.Module], Dict[str, torch.Tensor]]) -> Any:
    from bigdl_tpu_torch.nn.moe import MixtureOfExperts
    if isinstance(module, MixtureOfExperts):
        mine, template, stacked = _moe_entries(module, own)
        out = {k: np.array(t.detach().cpu().numpy()) for k, t in mine.items()}
        if own in (_params, _grads):
            out["experts"] = _dump_stacked(template, stacked)
        else:
            out["expert"] = _dump(template, own)
        return out
    if isinstance(module, Container):
        return [_dump(child, own) for child in module.layers]
    out = {}
    for key, t in own(module).items():
        value = t.detach().cpu().numpy()
        axes = _axes(_TO_JAX, module, key)
        out[key] = np.array(value if axes is None
                            else np.transpose(value, axes))
    return out


def _params(module: nn.Module) -> Dict[str, torch.Tensor]:
    return dict(module.named_parameters(recurse=False))


def _grad(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p) if p.grad is None else p.grad


def _grads(module: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: _grad(p) for k, p in module.named_parameters(recurse=False)}


def _row(tree: Any, i: int) -> Any:
    """Row ``i`` of every leaf of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _row(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_row(v, i) for v in tree]
    return np.asarray(tree)[i]


def _stack(trees: List[Any]) -> Any:
    """Stack same-structured trees leaf-wise along a new leading dim."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack([t[j] for t in trees]) for j in range(len(first))]
    return np.stack(trees)


def params_from_jax(jax_params: Any, torch_model) -> Any:
    """Copy a JAX parameter tree, as numpy arrays
    (``jax.tree_util.tree_map(np.asarray, model.params)``), into the port's
    model of the same structure, in place; returns the model.  A list of
    per-stage blocks takes a stacked stage tree, row i into block i.
    Raises :class:`ValueError` where the trees differ."""
    if isinstance(torch_model, (list, tuple)):
        for i, block in enumerate(torch_model):
            _load(_row(jax_params, i), block, "parameter", _params)
        return torch_model
    return _load(jax_params, torch_model, "parameter", _params)


def params_to_jax(torch_model) -> Any:
    """The inverse of :func:`params_from_jax`: the port's parameters as a
    numpy tree in the JAX package's layout, of fresh host arrays (a list
    of per-stage blocks gives the stacked stage tree)."""
    if isinstance(torch_model, (list, tuple)):
        return _stack([_dump(b, _params) for b in torch_model])
    return _dump(torch_model, _params)


def grads_to_jax(torch_model: nn.Module) -> Any:
    """The parameters' gradients (``.grad``, zeros where none) as a numpy
    tree in the JAX package's layout, the twin of the JAX package's
    ``model.grads``."""
    return _dump(torch_model, _grads)


def state_from_jax(jax_state: Any, torch_model: nn.Module) -> nn.Module:
    """Copy a JAX module-state tree (``model.state`` as numpy arrays: each
    BatchNorm's ``running_mean`` and ``running_var``, ``{}`` for a layer
    without state) into the port model's buffers, in place; returns the
    model."""
    return _load(jax_state, torch_model, "state", state_buffers)


def state_to_jax(torch_model: nn.Module) -> Any:
    """The port's buffers as a JAX module-state tree of numpy arrays."""
    return _dump(torch_model, state_buffers)
