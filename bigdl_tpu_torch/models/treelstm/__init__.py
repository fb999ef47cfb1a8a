"""The TreeLSTM sentiment classifier (``bigdl_tpu/models/treelstm/
__init__.py``; reference ``example/treeLSTMSentiment``).

``BinaryTreeLSTM`` takes ``[leaf embeddings (B, L, D), tree (B, n, 2)]``
(child indices, children before parents) and gives the internal nodes'
hiddens in the tree's order; the root is the last internal node, so the
head selects it and projects it to the classes."""

from __future__ import annotations

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.engine import DeviceLike, default_device


def tree_lstm_sentiment(embed_dim: int, hidden_size: int,
                        class_num: int = 5, device: DeviceLike = "cuda",
                        seed: int = 0) -> nn.Sequential:
    """``BinaryTreeLSTM`` -> ``Select(2, -1)`` (the root) -> ``Linear`` ->
    ``LogSoftMax``.  Initial weights come from one CPU generator seeded
    with ``seed``."""
    dev = default_device(device)
    kw = dict(device=dev, generator=torch.Generator().manual_seed(seed))
    return (nn.Sequential()
            .add(nn.BinaryTreeLSTM(embed_dim, hidden_size, **kw))
            .add(nn.Select(2, -1))
            .add(nn.Linear(hidden_size, class_num, **kw))
            .add(nn.LogSoftMax()))
