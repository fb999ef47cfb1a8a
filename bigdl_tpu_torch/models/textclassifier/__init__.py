"""The text-classification CNN over word vectors
(``bigdl_tpu/models/textclassifier/__init__.py``; reference
``example/utils/TextClassifier.scala:171``; ``BASELINE.json`` #4).

Input: (B, sequence_length, embedding_dim) GloVe-embedded token sequences.
As in the reference, the sequence becomes an (embedding_dim, 1,
sequence_length) image, and ``SpatialConvolution`` with 5 x 1 kernels runs
as a temporal convolution.  Channels-last by default (``layout="NHWC"``,
:mod:`bigdl_tpu_torch.nn.layout`), where that image has the memory order
of the (B, sequence_length, embedding_dim) input."""

from __future__ import annotations

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.engine import DeviceLike, default_device


def text_classifier(class_num: int, embedding_dim: int = 200,
                    sequence_length: int = 1000, layout: str = "NHWC",
                    device: DeviceLike = "cuda",
                    seed: int = 0) -> nn.Sequential:
    """Three convolutions of 128 5-wide filters, each after a ReLU pooled
    by 5, 5 and 35 along the sequence, then Linear 128 -> 100 -> classes
    and ``LogSoftMax``.  ``sequence_length`` 1000 pools to one position
    (1000 -> 996 -> 199 -> 195 -> 39 -> 35 -> 1).  Initial weights come
    from one CPU generator seeded with ``seed``."""
    dev = default_device(device)
    kw = dict(device=dev, generator=torch.Generator().manual_seed(seed))
    m = (nn.Sequential()
         # (B, seq, embed) -> (B, embed, 1, seq) image
         .add(nn.Transpose([(2, 3)]))
         .add(nn.Reshape((embedding_dim, 1, sequence_length)))
         .add(nn.SpatialConvolution(embedding_dim, 128, 5, 1, **kw))
         .add(nn.ReLU())
         .add(nn.SpatialMaxPooling(5, 1, 5, 1))
         .add(nn.SpatialConvolution(128, 128, 5, 1, **kw))
         .add(nn.ReLU())
         .add(nn.SpatialMaxPooling(5, 1, 5, 1))
         .add(nn.SpatialConvolution(128, 128, 5, 1, **kw))
         .add(nn.ReLU())
         .add(nn.SpatialMaxPooling(35, 1, 35, 1))
         .add(nn.Reshape((128,)))
         .add(nn.Linear(128, 100, **kw))
         .add(nn.Linear(100, class_num, **kw))
         .add(nn.LogSoftMax()))
    return nn.apply_layout(m, layout)
