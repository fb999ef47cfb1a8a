"""AlexNet (``bigdl_tpu/models/alexnet.py``: ``alexnet_owt`` :11,
``alexnet`` :44; reference ``example/loadmodel/AlexNet.scala``).

The builders keep the JAX package's module tree, so its parameter tree
carries over with :func:`bigdl_tpu_torch.utils.convert.params_from_jax`.
Channels-last by default (``layout="NHWC"``,
:mod:`bigdl_tpu_torch.nn.layout`); the input stays an NCHW batch of
224 x 224 images.  Initial weights come from one CPU generator seeded with
``seed``.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.engine import DeviceLike, default_device


def _classifier(m: nn.Sequential, class_num: int, has_dropout: bool,
                kw: dict) -> nn.Sequential:
    m.add(nn.View(256 * 6 * 6))
    m.add(nn.Linear(256 * 6 * 6, 4096, **kw))
    m.add(nn.ReLU())
    if has_dropout:
        m.add(nn.Dropout(0.5))
    m.add(nn.Linear(4096, 4096, **kw))
    m.add(nn.ReLU())
    if has_dropout:
        m.add(nn.Dropout(0.5))
    m.add(nn.Linear(4096, class_num, **kw))
    m.add(nn.LogSoftMax())
    return m


def alexnet_owt(class_num: int = 1000, has_dropout: bool = True,
                first_layer_propagate_back: bool = False,
                layout: str = "NHWC", device: DeviceLike = "cuda",
                seed: int = 0) -> nn.Sequential:
    """One-weird-trick AlexNet (no LRN, no grouping)."""
    kw = dict(device=default_device(device),
              generator=torch.Generator().manual_seed(seed))
    m = nn.Sequential()
    m.add(nn.SpatialConvolution(3, 64, 11, 11, 4, 4, 2, 2, 1,
                                first_layer_propagate_back, **kw))
    m.add(nn.ReLU())
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2))
    m.add(nn.SpatialConvolution(64, 192, 5, 5, 1, 1, 2, 2, **kw))
    m.add(nn.ReLU())
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2))
    m.add(nn.SpatialConvolution(192, 384, 3, 3, 1, 1, 1, 1, **kw))
    m.add(nn.ReLU())
    m.add(nn.SpatialConvolution(384, 256, 3, 3, 1, 1, 1, 1, **kw))
    m.add(nn.ReLU())
    m.add(nn.SpatialConvolution(256, 256, 3, 3, 1, 1, 1, 1, **kw))
    m.add(nn.ReLU())
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2))
    return nn.apply_layout(_classifier(m, class_num, has_dropout, kw),
                           layout)


def alexnet(class_num: int = 1000, layout: str = "NHWC",
            device: DeviceLike = "cuda", seed: int = 0) -> nn.Sequential:
    """Original AlexNet: conv2, conv4 and conv5 in two groups, cross-map
    LRN after conv1 and conv2."""
    kw = dict(device=default_device(device),
              generator=torch.Generator().manual_seed(seed))
    m = nn.Sequential()
    m.add(nn.SpatialConvolution(3, 96, 11, 11, 4, 4, 0, 0, 1, False, **kw))
    m.add(nn.ReLU())
    m.add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2))
    m.add(nn.SpatialConvolution(96, 256, 5, 5, 1, 1, 2, 2, 2, **kw))
    m.add(nn.ReLU())
    m.add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2))
    m.add(nn.SpatialConvolution(256, 384, 3, 3, 1, 1, 1, 1, **kw))
    m.add(nn.ReLU())
    m.add(nn.SpatialConvolution(384, 384, 3, 3, 1, 1, 1, 1, 2, **kw))
    m.add(nn.ReLU())
    m.add(nn.SpatialConvolution(384, 256, 3, 3, 1, 1, 1, 1, 2, **kw))
    m.add(nn.ReLU())
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2))
    return nn.apply_layout(_classifier(m, class_num, True, kw), layout)
