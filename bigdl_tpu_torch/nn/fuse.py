"""Conv + BatchNorm folding for inference (``bigdl_tpu/nn/fuse.py``
``fold_conv_bn`` :59).

At inference a BatchNorm is a per-channel affine map of its running
statistics, so it folds into the convolution before it::

    s = gamma * rsqrt(running_var + eps)
    w' = w * s          (per output channel: torch's leading axis)
    b' = b * s + (beta - running_mean * s)

Training semantics are not kept (the batch statistics are gone), so fold a
copy for serving, as ``Predictor(model, fold_bn=True)`` does.
"""

from __future__ import annotations

import torch
from torch import nn

from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.module import Container, Module, Sequential
from bigdl_tpu_torch.nn.normalization import SpatialBatchNormalization
from bigdl_tpu_torch.nn.structural import Identity

__all__ = ["fold_conv_bn"]


def _bn_scale_shift(bn: SpatialBatchNormalization):
    # the arithmetic of the BN's eval forward (rsqrt of var + eps)
    inv = torch.rsqrt(bn.running_var + bn.eps)
    if bn.affine:
        scale = bn.weight * inv
        return scale, bn.bias - bn.running_mean * scale
    return inv, -bn.running_mean * inv


def _foldable(conv: Module, bn: Module) -> bool:
    return (isinstance(conv, SpatialConvolution) and
            isinstance(bn, SpatialBatchNormalization) and
            bn.n_output == conv.n_output_plane)


@torch.no_grad()
def fold_conv_bn(model: Module) -> Module:
    """Fold every ``SpatialConvolution -> SpatialBatchNormalization`` pair
    of adjacent layers, inside any ``Sequential``, into the convolution,
    replacing the BN with ``Identity`` and giving the convolution a bias
    where it had none.  In place; returns ``model``.  Only for eval and
    serving: the folded model has no batch statistics."""
    if not isinstance(model, Container):
        return model
    if isinstance(model, Sequential):
        for i in range(len(model.layers) - 1):
            conv, bn = model.layers[i], model.layers[i + 1]
            if not _foldable(conv, bn):
                continue
            scale, shift = _bn_scale_shift(bn)
            w = conv.weight
            scale, shift = scale.to(w.dtype), shift.to(w.dtype)
            w.mul_(scale.reshape(-1, 1, 1, 1))
            if conv.bias is not None:
                conv.bias.copy_(conv.bias * scale + shift)
            else:
                conv.bias = nn.Parameter(shift.clone())
                conv.with_bias = True
            model.layers[i + 1] = Identity()
    for child in model.layers:
        fold_conv_bn(child)
    return model
