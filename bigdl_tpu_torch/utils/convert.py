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
modules hold nothing (:mod:`bigdl_tpu_torch.nn.layout`).
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


def _load(jax_tree: Any, module: nn.Module, what: str,
          own: Callable[[nn.Module], Dict[str, torch.Tensor]]) -> nn.Module:
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


def params_from_jax(jax_params: Any, torch_model: nn.Module) -> nn.Module:
    """Copy a JAX parameter tree, as numpy arrays
    (``jax.tree_util.tree_map(np.asarray, model.params)``), into the port's
    model of the same structure, in place; returns the model.  Raises
    :class:`ValueError` where the trees differ."""
    return _load(jax_params, torch_model, "parameter", _params)


def params_to_jax(torch_model: nn.Module) -> Any:
    """The inverse of :func:`params_from_jax`: the port's parameters as a
    numpy tree in the JAX package's layout, of fresh host arrays."""
    return _dump(torch_model, _params)


def state_from_jax(jax_state: Any, torch_model: nn.Module) -> nn.Module:
    """Copy a JAX module-state tree (``model.state`` as numpy arrays: each
    BatchNorm's ``running_mean`` and ``running_var``, ``{}`` for a layer
    without state) into the port model's buffers, in place; returns the
    model."""
    return _load(jax_state, torch_model, "state", state_buffers)


def state_to_jax(torch_model: nn.Module) -> Any:
    """The port's buffers as a JAX module-state tree of numpy arrays."""
    return _dump(torch_model, state_buffers)
