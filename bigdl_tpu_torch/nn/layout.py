"""The channels-last compute path of a convnet behind its NCHW facade
(``bigdl_tpu/nn/layout.py``: ``NCHWToNHWC`` :55, ``NHWCToNCHW`` :74,
``to_channels_last`` :305, ``apply_layout`` :332).

The JAX package moves a convnet's trunk to NHWC-shaped activations.  Here
activations keep their logical (N, C, H, W) shape and only their memory
format changes, to ``torch.channels_last``, which cuDNN's convolutions,
pooling and batch norm compute in without transposes.  So a channel
``Concat(2)`` and the flatten before the classifier need no remapping.

The walk is the JAX package's, over the same ``layout_role`` contract
(:class:`bigdl_tpu_torch.nn.module.Module`): one :class:`NCHWToNHWC` right
before the first spatial subtree of a ``Sequential``, one
:class:`NHWCToNCHW` right before the first layout-dependent ("opaque")
layer after it or at the end, branches of ``Concat``/``ConcatTable`` in the
layout they are given.  The boundary modules land where the JAX package
puts its transposes, so the port's module tree, and with it the parameter
list that :func:`bigdl_tpu_torch.utils.convert.params_from_jax` walks,
lines up one to one with a JAX model built with ``layout="NHWC"``.  Spatial
layers are re-pointed with ``set_format``, which keeps convolution weights
channels-last too.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Container, Module, Sequential
from bigdl_tpu_torch.nn.table import Concat, ConcatTable

__all__ = ["NCHWToNHWC", "NHWCToNCHW", "apply_layout", "to_channels_last"]


class NCHWToNHWC(Module):
    """Boundary into the channels-last trunk: a batch of maps moves to the
    ``torch.channels_last`` memory format (a copy, the twin of the JAX
    package's entry transpose); its shape stays (N, C, H, W).  An
    unbatched (C, H, W) map has no channels-last format and passes as is."""

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        if input.dim() != 4:
            return input
        return input.contiguous(memory_format=torch.channels_last)


class NHWCToNCHW(Module):
    """Boundary out of the channels-last trunk: NCHW-ordered memory again
    (free for a map of 1 x 1 pixels, which is contiguous in both)."""

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return input.contiguous()


def _wrapped(*modules: Module) -> Sequential:
    w = Sequential()
    for m in modules:
        w.add(m)
    return w


def _supported_container(m: Module) -> bool:
    return isinstance(m, (Sequential, Concat, ConcatTable))


def _contains_spatial(m: Module) -> bool:
    if m.layout_role == "spatial":
        return True
    return isinstance(m, Container) and any(_contains_spatial(c)
                                            for c in m.layers)


def _wants_nhwc(m: Module) -> bool:
    """The first layer along ``m``'s input edge that is not agnostic is a
    spatial one."""
    if m.layout_role == "spatial":
        return True
    if isinstance(m, Sequential):
        for c in m.layers:
            if c.layout_role != "agnostic":
                return _wants_nhwc(c)
        return False
    if isinstance(m, (Concat, ConcatTable)):
        return any(_wants_nhwc(c) for c in m.layers)
    return False


def _convert(m: Module, fmt: str) -> str:
    """Convert ``m`` in place to take activations in ``fmt``; returns the
    layout of its output."""
    if isinstance(m, NCHWToNHWC):
        return "NHWC"
    if isinstance(m, NHWCToNCHW):
        return "NCHW"
    if isinstance(m, Sequential):
        return _convert_sequential(m, fmt)
    if isinstance(m, (Concat, ConcatTable)):
        return _convert_branch(m, fmt)
    if m.layout_role == "agnostic":
        return fmt
    if m.layout_role == "spatial":
        m.set_format(fmt)
        return fmt
    return "NCHW"   # an opaque leaf: its caller restored NCHW before it


def _convert_sequential(seq: Sequential, fmt: str) -> str:
    cur, i = fmt, 0
    while i < len(seq.layers):
        c = seq.layers[i]
        if isinstance(c, NCHWToNHWC):
            cur = "NHWC"
        elif isinstance(c, NHWCToNCHW):
            cur = "NCHW"
        elif c.layout_role == "agnostic":
            pass
        elif c.layout_role == "spatial" or (_supported_container(c) and
                                            _wants_nhwc(c)):
            if cur == "NCHW":
                seq.layers.insert(i, NCHWToNHWC())
                i += 1
                cur = "NHWC"
            cur = _convert(c, cur)
        elif _supported_container(c):
            cur = _convert(c, cur)
        elif cur == "NHWC":
            seq.layers.insert(i, NHWCToNCHW())
            i += 1
            cur = "NCHW"
        i += 1
    return cur


def _convert_branch(cc: Container, fmt: str) -> str:
    outs = []
    for i, c in enumerate(cc.layers):
        if isinstance(c, (NCHWToNHWC, NHWCToNCHW)) or c.layout_role in (
                "agnostic", "spatial") or _supported_container(c):
            outs.append(_convert(c, fmt))
        else:
            if fmt == "NHWC":
                cc.layers[i] = _wrapped(NHWCToNCHW(), c)
            outs.append("NCHW")
    if len(set(outs)) > 1:
        raise ValueError(f"{type(cc).__name__}: branches disagree on output "
                         f"layout {outs}")
    return outs[0] if outs else fmt


def to_channels_last(model: Module) -> Module:
    """Rewrite ``model`` in place so that its convolutional trunk computes
    channels-last while it still takes and gives NCHW-ordered tensors.
    Idempotent.  Returns the model: the same object for a ``Sequential``,
    a ``Sequential`` around any other container whose output stays a map."""
    if not isinstance(model, Container) or not _contains_spatial(model):
        return model
    if not isinstance(model, Sequential):
        model = _wrapped(model)
    if _convert_sequential(model, "NCHW") == "NHWC":
        model.add(NHWCToNCHW())
    return model


def apply_layout(model: Module, layout: str) -> Module:
    """The zoo builders' switch: ``"NHWC"`` converts to the channels-last
    path (the default), ``"NCHW"`` keeps the classic one."""
    if layout == "NHWC":
        return to_channels_last(model)
    if layout == "NCHW":
        return model
    raise ValueError(f"unknown layout {layout!r}: expected 'NHWC' or 'NCHW'")
