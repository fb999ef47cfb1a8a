"""LeNet-5 for MNIST (``bigdl_tpu/models/lenet/__init__.py`` :10-25;
reference ``models/lenet/LeNet5.scala:25``).  Channels-last by default
(``layout="NHWC"``, :mod:`bigdl_tpu_torch.nn.layout`); the input stays the
flat or (N, 1, 28, 28) MNIST batch."""

from __future__ import annotations

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.engine import DeviceLike, default_device


def lenet5(class_num: int = 10, layout: str = "NHWC",
           device: DeviceLike = "cuda", seed: int = 0) -> nn.Sequential:
    """The classic 2-conv 2-fc LeNet: 28x28 grey image -> class_num
    log-probs.  Initial weights come from one CPU generator seeded with
    ``seed``."""
    dev = default_device(device)
    g = torch.Generator().manual_seed(seed)
    kw = dict(device=dev, generator=g)
    m = (nn.Sequential()
         .add(nn.Reshape((1, 28, 28)))
         .add(nn.SpatialConvolution(1, 6, 5, 5, **kw))
         .add(nn.Tanh())
         .add(nn.SpatialMaxPooling(2, 2, 2, 2))
         .add(nn.Tanh())
         .add(nn.SpatialConvolution(6, 12, 5, 5, **kw))
         .add(nn.SpatialMaxPooling(2, 2, 2, 2))
         .add(nn.Reshape((12 * 4 * 4,)))
         .add(nn.Linear(12 * 4 * 4, 100, **kw))
         .add(nn.Tanh())
         .add(nn.Linear(100, class_num, **kw))
         .add(nn.LogSoftMax()))
    return nn.apply_layout(m, layout)
