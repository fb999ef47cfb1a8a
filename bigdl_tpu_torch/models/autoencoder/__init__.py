"""The MNIST autoencoder (``bigdl_tpu/models/autoencoder/__init__.py``;
reference ``models/autoencoder/Autoencoder.scala``)."""

from __future__ import annotations

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.engine import DeviceLike, default_device

ROW_N = 28
COL_N = 28
FEATURE_SIZE = ROW_N * COL_N


def autoencoder(class_num: int = 32, device: DeviceLike = "cuda",
                seed: int = 0) -> nn.Sequential:
    """784 -> ``class_num`` -> 784, ReLU at the bottleneck and a sigmoid
    output.  Initial weights come from one CPU generator seeded with
    ``seed``."""
    dev = default_device(device)
    kw = dict(device=dev, generator=torch.Generator().manual_seed(seed))
    return (nn.Sequential()
            .add(nn.Reshape((FEATURE_SIZE,)))
            .add(nn.Linear(FEATURE_SIZE, class_num, **kw))
            .add(nn.ReLU())
            .add(nn.Linear(class_num, FEATURE_SIZE, **kw))
            .add(nn.Sigmoid()))
