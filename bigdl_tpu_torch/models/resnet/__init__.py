"""ResNet for CIFAR-10 and ImageNet (``bigdl_tpu/models/resnet/__init__.py``;
reference ``models/resnet/ResNet.scala:57,132,211-244``).

The builders keep the JAX package's module tree, layer for layer, so its
parameter and state trees carry over with
:func:`bigdl_tpu_torch.utils.convert.params_from_jax` and
:func:`~bigdl_tpu_torch.utils.convert.state_from_jax`.  They build
channels-last by default (``layout="NHWC"``,
:mod:`bigdl_tpu_torch.nn.layout`); the input stays an NCHW batch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.engine import DeviceLike, default_device


class DatasetType:
    CIFAR10 = "cifar10"
    IMAGENET = "imagenet"


class ShortcutType:
    A = "A"  # zero-padded identity on dim change
    B = "B"  # 1x1 conv on dim change, identity otherwise
    C = "C"  # 1x1 conv everywhere


class _Layers:
    """Layer constructors that share one device and one generator."""

    def __init__(self, device: torch.device, generator: torch.Generator):
        self.kw = dict(device=device, generator=generator)

    def conv(self, *args) -> nn.SpatialConvolution:
        return nn.SpatialConvolution(*args, **self.kw)

    def bn(self, n: int) -> nn.SpatialBatchNormalization:
        return nn.SpatialBatchNormalization(n, **self.kw)

    def linear(self, n_in: int, n_out: int) -> nn.Linear:
        return nn.Linear(n_in, n_out, **self.kw)


def _shortcut(L: _Layers, n_in, n_out, stride, shortcut_type):
    use_conv = shortcut_type == ShortcutType.C or (
        shortcut_type == ShortcutType.B and n_in != n_out)
    if use_conv:
        return (nn.Sequential()
                .add(L.conv(n_in, n_out, 1, 1, stride, stride))
                .add(L.bn(n_out)))
    if n_in != n_out:
        # type A: strided subsample, then the channels padded with zeros by
        # concatenating a zeroed copy (reference ResNet.scala:139-144)
        return (nn.Sequential()
                .add(nn.SpatialAveragePooling(1, 1, stride, stride))
                .add(nn.Concat(2).add(nn.Identity())
                     .add(nn.MulConstant(0.0))))
    return nn.Identity()


def _residual(L: _Layers, branch, n_in, n_out, stride, shortcut_type):
    return (nn.Sequential()
            .add(nn.ConcatTable().add(branch).add(
                _shortcut(L, n_in, n_out, stride, shortcut_type)))
            .add(nn.CAddTable())
            .add(nn.ReLU()))


def _basic_block(L: _Layers, n_in, n, stride, shortcut_type):
    s = (nn.Sequential()
         .add(L.conv(n_in, n, 3, 3, stride, stride, 1, 1)).add(L.bn(n))
         .add(nn.ReLU())
         .add(L.conv(n, n, 3, 3, 1, 1, 1, 1)).add(L.bn(n)))
    return _residual(L, s, n_in, n, stride, shortcut_type), n


def _bottleneck(L: _Layers, n_in, n, stride, shortcut_type):
    s = (nn.Sequential()
         .add(L.conv(n_in, n, 1, 1, 1, 1, 0, 0)).add(L.bn(n))
         .add(nn.ReLU())
         .add(L.conv(n, n, 3, 3, stride, stride, 1, 1)).add(L.bn(n))
         .add(nn.ReLU())
         .add(L.conv(n, n * 4, 1, 1, 1, 1, 0, 0)).add(L.bn(n * 4)))
    return _residual(L, s, n_in, n * 4, stride, shortcut_type), n * 4


def _layer(L: _Layers, block_fn, n_in, features, count, stride,
           shortcut_type):
    s = nn.Sequential()
    for i in range(count):
        b, n_in = block_fn(L, n_in, features, stride if i == 0 else 1,
                           shortcut_type)
        s.add(b)
    return s, n_in


# (block counts per stage, final feature width, block fn)
_IMAGENET_CFG = {
    18: ((2, 2, 2, 2), 512, _basic_block),
    34: ((3, 4, 6, 3), 512, _basic_block),
    50: ((3, 4, 6, 3), 2048, _bottleneck),
    101: ((3, 4, 23, 3), 2048, _bottleneck),
    152: ((3, 8, 36, 3), 2048, _bottleneck),
    200: ((3, 24, 36, 3), 2048, _bottleneck),
}


def resnet(class_num: int, depth: int = 18,
           shortcut_type: str = ShortcutType.B,
           dataset: str = DatasetType.CIFAR10, layout: str = "NHWC",
           device: DeviceLike = "cuda", seed: int = 0) -> nn.Sequential:
    """ResNet of ``depth`` for ``dataset``: ImageNet depths 18-200 on
    (N, 3, 224, 224), CIFAR-10 depths 6n+2 on (N, 3, 32, 32); returns
    logits (no LogSoftMax, as in the JAX package).  Initial weights come
    from one CPU generator seeded with ``seed``; :func:`model_init` then
    gives the reference's training initialisation."""
    dev = default_device(device)
    L = _Layers(dev, torch.Generator().manual_seed(seed))
    model = nn.Sequential()
    if dataset == DatasetType.IMAGENET:
        if depth not in _IMAGENET_CFG:
            raise ValueError(f"Invalid depth {depth}")
        counts, n_features, block = _IMAGENET_CFG[depth]
        (model.add(L.conv(3, 64, 7, 7, 2, 2, 3, 3)).add(L.bn(64))
         .add(nn.ReLU()).add(nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1)))
        ch = 64
        for i, (features, count) in enumerate(zip((64, 128, 256, 512),
                                                  counts)):
            stage, ch = _layer(L, block, ch, features, count,
                               1 if i == 0 else 2, shortcut_type)
            model.add(stage)
        model.add(nn.SpatialAveragePooling(7, 7, 1, 1))
        model.add(nn.View(n_features).set_num_input_dims(3))
        model.add(L.linear(n_features, class_num))
    elif dataset == DatasetType.CIFAR10:
        if (depth - 2) % 6 != 0:
            raise ValueError("depth should be one of 20, 32, 44, 56, 110, "
                             "1202")
        n = (depth - 2) // 6
        model.add(L.conv(3, 16, 3, 3, 1, 1, 1, 1)).add(L.bn(16))
        model.add(nn.ReLU())
        ch = 16
        for features, stride in ((16, 1), (32, 2), (64, 2)):
            stage, ch = _layer(L, _basic_block, ch, features, n, stride,
                               shortcut_type)
            model.add(stage)
        model.add(nn.SpatialAveragePooling(8, 8, 1, 1))
        model.add(nn.View(64).set_num_input_dims(3))
        model.add(L.linear(64, class_num))
    else:
        raise ValueError(f"Unknown dataset {dataset}")
    return nn.apply_layout(model, layout)


@torch.no_grad()
def model_init(model: nn.Module,
               generator: Optional[torch.Generator] = None) -> nn.Module:
    """He-normal convolutions (std sqrt(2 / (kw * kw * out)), the
    reference's fan), BatchNorm weight 1 and bias 0, zero Linear biases
    (reference ``ResNet.modelInit``, ``models/resnet/ResNet.scala:103-130``).
    The draws come from ``generator`` (default: a CPU generator seeded
    with 0) in module order; in place, returns ``model``."""
    g = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    for m in model.modules():
        if isinstance(m, nn.SpatialConvolution):
            n = m.kernel_w * m.kernel_w * m.n_output_plane
            draw = nn.RandomNormal(0.0, math.sqrt(2.0 / n))
            m.weight.copy_(draw(m.weight.shape, generator=g))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.SpatialBatchNormalization):
            if m.weight is not None:
                m.weight.fill_(1.0)
                m.bias.zero_()
        elif isinstance(m, nn.Linear) and m.bias is not None:
            m.bias.zero_()
    return model
