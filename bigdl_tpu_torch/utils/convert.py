"""Carry parameters between the JAX package's layout and the port's model.

Initial weights cannot match across the two frameworks (``jax.random`` and
``torch.Generator`` draw different numbers), so every comparison of the port
with the JAX package builds both models and carries the JAX parameters over
(:func:`params_from_jax`); :func:`params_to_jax` reads the port's weights
back in the JAX layout, to compare trained weights.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Container


def _copy(param: torch.Tensor, value, what: str) -> None:
    value = np.asarray(value)
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{what}: JAX parameter of shape {value.shape} does "
                         f"not fit {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(value)))


def params_from_jax(jax_params: Any, torch_model: nn.Module) -> nn.Module:
    """Copy a JAX parameter pytree, as numpy arrays
    (``jax.tree_util.tree_map(np.asarray, model.params)``), into the port's
    model of the same structure, in place; returns the model.

    A container's parameters are the list of its children's.  A leaf's are
    a dict whose keys name the port's parameters, with one layout change:
    ``Linear`` weights are stored (in, out) by the JAX package and
    (out, in) here.  Raises :class:`ValueError` where the trees differ."""
    name = type(torch_model).__name__
    if isinstance(torch_model, Container):
        if not isinstance(jax_params, (list, tuple)) or \
                len(jax_params) != len(torch_model):
            raise ValueError(f"{name}: expected a list of "
                             f"{len(torch_model)} child parameter trees")
        for child_params, child in zip(jax_params, torch_model.layers):
            params_from_jax(child_params, child)
        return torch_model
    if not isinstance(jax_params, dict):
        raise ValueError(f"{name}: expected a dict of parameters, got "
                         f"{type(jax_params).__name__}")
    own = dict(torch_model.named_parameters(recurse=False))
    if set(jax_params) != set(own):
        raise ValueError(f"{name}: JAX parameters {sorted(jax_params)} do not "
                         f"match {sorted(own)}")
    for key, value in jax_params.items():
        if isinstance(torch_model, Linear) and key == "weight":
            value = np.asarray(value).T
        _copy(own[key], value, f"{name}.{key}")
    return torch_model


def params_to_jax(torch_model: nn.Module) -> Any:
    """The inverse of :func:`params_from_jax`: the port's parameters as a
    numpy tree in the JAX package's layout (a container's is the list of its
    children's; a leaf's a dict of fresh host arrays, ``Linear`` weights
    transposed back to (in, out))."""
    if isinstance(torch_model, Container):
        return [params_to_jax(child) for child in torch_model.layers]
    out = {}
    for key, param in torch_model.named_parameters(recurse=False):
        value = param.detach().cpu().numpy()
        if isinstance(torch_model, Linear) and key == "weight":
            value = value.T
        out[key] = np.array(value)
    return out
