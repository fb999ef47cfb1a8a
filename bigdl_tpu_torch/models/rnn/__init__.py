"""The recurrent language models (``bigdl_tpu/models/rnn/__init__.py``;
reference ``models/rnn/SimpleRNN.scala:22``): a simple RNN and the LSTM
language model of the PTB configuration (``BASELINE.json`` #5).  Input
(B, T, input_size), one-hot rows as ``dataset/text.py`` makes them."""

from __future__ import annotations

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.engine import DeviceLike, default_device


def simple_rnn(input_size: int, hidden_size: int, output_size: int,
               device: DeviceLike = "cuda", seed: int = 0) -> nn.Sequential:
    """``Recurrent(RnnCell(tanh))`` then ``TimeDistributed(Linear)``:
    (B, T, input_size) -> (B, T, output_size) scores.  Initial weights come
    from one CPU generator seeded with ``seed``."""
    dev = default_device(device)
    kw = dict(device=dev, generator=torch.Generator().manual_seed(seed))
    return (nn.Sequential()
            .add(nn.Recurrent().add(nn.RnnCell(input_size, hidden_size,
                                               nn.Tanh(), **kw)))
            .add(nn.TimeDistributed(nn.Linear(hidden_size, output_size,
                                              **kw))))


def lstm_lm(input_size: int, hidden_size: int, output_size: int,
            device: DeviceLike = "cuda", seed: int = 0) -> nn.Sequential:
    """One LSTM layer, then ``TimeDistributed(Linear)`` and
    ``TimeDistributed(LogSoftMax)``: (B, T, input_size) -> (B, T,
    output_size) log-probabilities."""
    dev = default_device(device)
    kw = dict(device=dev, generator=torch.Generator().manual_seed(seed))
    return (nn.Sequential()
            .add(nn.Recurrent().add(nn.LSTM(input_size, hidden_size, **kw)))
            .add(nn.TimeDistributed(nn.Linear(hidden_size, output_size,
                                              **kw)))
            .add(nn.TimeDistributed(nn.LogSoftMax())))
