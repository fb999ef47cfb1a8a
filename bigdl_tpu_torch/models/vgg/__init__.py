"""The VGG family (``bigdl_tpu/models/vgg/__init__.py``: ``vgg_for_cifar10``
:12, ``_vgg_imagenet`` :51, ``vgg16`` :73, ``vgg19`` :77; reference
``models/vgg/VggForCifar10.scala:22,71,124``).

The builders keep the JAX package's module tree, so its parameter and state
trees carry over with :func:`bigdl_tpu_torch.utils.convert.params_from_jax`
and :func:`~bigdl_tpu_torch.utils.convert.state_from_jax`.  Channels-last by
default (``layout="NHWC"``, :mod:`bigdl_tpu_torch.nn.layout`).  Initial
weights come from one CPU generator seeded with ``seed``.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.engine import DeviceLike, default_device


def vgg_for_cifar10(class_num: int = 10, layout: str = "NHWC",
                    device: DeviceLike = "cuda",
                    seed: int = 0) -> nn.Sequential:
    """VGG-16-style BN + Dropout net for 32 x 32 CIFAR-10 images."""
    kw = dict(device=default_device(device),
              generator=torch.Generator().manual_seed(seed))
    m = nn.Sequential()

    def conv_bn_relu(n_in, n_out):
        m.add(nn.SpatialConvolution(n_in, n_out, 3, 3, 1, 1, 1, 1, **kw))
        m.add(nn.SpatialBatchNormalization(n_out, 1e-3, **kw))
        m.add(nn.ReLU())

    # (width, convs, dropout after each conv but the block's last)
    for n_in, width, n_convs, p in ((3, 64, 2, 0.3), (64, 128, 2, 0.4),
                                    (128, 256, 3, 0.4), (256, 512, 3, 0.4),
                                    (512, 512, 3, 0.4)):
        for i in range(n_convs):
            conv_bn_relu(n_in if i == 0 else width, width)
            if i < n_convs - 1:
                m.add(nn.Dropout(p))
        m.add(nn.SpatialMaxPooling(2, 2, 2, 2).ceil())
    m.add(nn.View(512))
    m.add(nn.Dropout(0.5))
    m.add(nn.Linear(512, 512, **kw))
    m.add(nn.BatchNormalization(512, **kw))
    m.add(nn.ReLU())
    m.add(nn.Dropout(0.5))
    m.add(nn.Linear(512, class_num, **kw))
    m.add(nn.LogSoftMax())
    return nn.apply_layout(m, layout)


def _vgg_imagenet(block_convs, class_num: int, layout: str,
                  device: DeviceLike, seed: int) -> nn.Sequential:
    kw = dict(device=default_device(device),
              generator=torch.Generator().manual_seed(seed))
    m = nn.Sequential()
    n_in = 3
    for width, n_convs in zip((64, 128, 256, 512, 512), block_convs):
        for _ in range(n_convs):
            m.add(nn.SpatialConvolution(n_in, width, 3, 3, 1, 1, 1, 1, **kw))
            m.add(nn.ReLU())
            n_in = width
        m.add(nn.SpatialMaxPooling(2, 2, 2, 2))
    m.add(nn.View(512 * 7 * 7))
    m.add(nn.Linear(512 * 7 * 7, 4096, **kw))
    m.add(nn.Threshold(0, 1e-6))
    m.add(nn.Dropout(0.5))
    m.add(nn.Linear(4096, 4096, **kw))
    m.add(nn.Threshold(0, 1e-6))
    m.add(nn.Dropout(0.5))
    m.add(nn.Linear(4096, class_num, **kw))
    m.add(nn.LogSoftMax())
    return nn.apply_layout(m, layout)


def vgg16(class_num: int = 1000, layout: str = "NHWC",
          device: DeviceLike = "cuda", seed: int = 0) -> nn.Sequential:
    """VGG-16 for 224 x 224 ImageNet images (138M parameters)."""
    return _vgg_imagenet((2, 2, 3, 3, 3), class_num, layout, device, seed)


def vgg19(class_num: int = 1000, layout: str = "NHWC",
          device: DeviceLike = "cuda", seed: int = 0) -> nn.Sequential:
    """VGG-19 for 224 x 224 ImageNet images."""
    return _vgg_imagenet((2, 2, 4, 4, 4), class_num, layout, device, seed)
