"""Decoder-only transformer language model
(``bigdl_tpu/models/transformer/__init__.py``).

Causal multi-head attention blocks with pre-norm residuals, the same layer
order and parameter tree as the JAX package, so its parameters load with
:func:`bigdl_tpu_torch.utils.convert.params_from_jax`.  Tensor parallelism,
MoE feed-forward blocks, rematerialisation and sequence parallelism are not
in this slice and raise :class:`NotImplementedError`.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

import bigdl_tpu_torch.nn as bnn
from bigdl_tpu_torch.engine import DeviceLike, default_device
from bigdl_tpu_torch.nn.module import Container, Module


class PositionOutOfRange(ValueError):
    """A position past the sinusoidal table's capacity; names the
    offending position and the limit."""

    def __init__(self, position: int, max_len: int):
        self.position = int(position)
        self.max_len = int(max_len)
        super().__init__(
            f"position {self.position} is out of range for a "
            f"PositionalEncoding table of max_len {self.max_len} — build "
            f"the model with max_len > {self.position} or truncate the "
            "sequence")


class PositionalEncoding(Module):
    """Sinusoidal position signal added to (B, T, D) embeddings.

    ``forward(input, offset=k)`` reads table rows ``k .. k+T`` instead of
    ``0 .. T``, and :meth:`rows` reads the rows of explicit positions (the
    decode step's, one per slot).  A position past the table raises
    :class:`PositionOutOfRange`; a tensor of positions is left to the
    caller's admission checks, as the JAX package leaves a traced one."""

    def __init__(self, d_model: int, max_len: int = 4096,
                 device: Optional[torch.device] = None):
        super().__init__()
        pos = np.arange(max_len)[:, None]
        div = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
        pe = np.zeros((max_len, d_model), np.float32)
        pe[:, 0::2] = np.sin(pos * div)
        pe[:, 1::2] = np.cos(pos * div[: d_model // 2])
        self.register_buffer("pe", torch.from_numpy(pe).to(device),
                             persistent=False)

    @property
    def max_seq_len(self) -> int:
        return int(self.pe.shape[0])

    def rows(self, positions) -> torch.Tensor:
        """Table rows for explicit positions.  Host positions (ints,
        sequences, numpy arrays) are range-checked; a tensor is indexed
        as it is."""
        if isinstance(positions, torch.Tensor):
            return self.pe[positions]
        pos = np.asarray(positions)
        if pos.size and int(pos.max()) >= self.max_seq_len:
            raise PositionOutOfRange(int(pos.max()), self.max_seq_len)
        return self.pe[torch.as_tensor(pos, dtype=torch.int64,
                                       device=self.pe.device)]

    def forward(self, input: torch.Tensor, offset: int = 0) -> torch.Tensor:
        t = input.shape[1]
        if offset + t > self.max_seq_len:
            raise PositionOutOfRange(offset + t - 1, self.max_seq_len)
        return input + self.pe[offset:offset + t][None].to(input.dtype)


class LayerNorm(Module):
    """Feature-axis layer normalization with the biased variance, as the
    JAX package computes it."""

    def __init__(self, d_model: int, eps: float = 1e-5,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.d_model = d_model
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d_model, device=device))
        self.bias = nn.Parameter(torch.zeros(d_model, device=device))

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        mean = input.mean(dim=-1, keepdim=True)
        var = input.var(dim=-1, unbiased=False, keepdim=True)
        out = (input - mean) * torch.rsqrt(var + self.eps)
        return out * self.weight + self.bias


class _Residual(Container):
    """x + inner(norm(x)): pre-norm residual; layers = [norm, inner]."""

    def __init__(self, d_model: int, inner: nn.Module,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.add(LayerNorm(d_model, device=device)).add(inner)

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        norm, inner = self.layers
        return input + inner(norm(input))


def _not_in_slice(tp: bool, moe_experts: int, remat=False) -> None:
    for flag, what in ((tp, "tensor parallelism (tp=True)"),
                       (moe_experts, "MoE feed-forward blocks (moe_experts)"),
                       (remat, "rematerialisation (remat)")):
        if flag:
            raise NotImplementedError(f"{what} is not ported yet")


def _default_remat(remat):
    """Resolve :func:`transformer_lm`'s ``remat`` argument against the
    ``bigdl.remat.policy`` config preset, as the JAX package's
    ``_default_remat`` does: an explicit argument wins; with the default
    (``False``) the preset applies — ``None``, ``""``, ``"none"``,
    ``"off"`` and ``"false"`` keep remat off, ``"nothing"`` and ``"true"``
    resolve to ``True``, any other value (``"dots"``, ``"save_attn"``) is
    returned as the policy name."""
    if remat is not False:
        return remat
    from bigdl_tpu_torch.utils import config
    v = config.get_property("bigdl.remat.policy", None)
    if v in (None, False, ""):
        return False
    v = str(v).lower()
    if v in ("none", "off", "false"):
        return False
    if v in ("nothing", "true"):
        return True
    return v


def transformer_block(d_model: int, n_head: int, ff_mult: int = 4,
                      tp: bool = False, moe_experts: int = 0,
                      flash: bool = False, device: DeviceLike = "cuda",
                      generator: Optional[torch.Generator] = None
                      ) -> bnn.Sequential:
    """One pre-norm decoder block: causal MHA + ReLU MLP, both residual."""
    _not_in_slice(tp, moe_experts)
    dev = default_device(device)
    ffn = (bnn.Sequential()
           .add(bnn.Linear(d_model, ff_mult * d_model, device=dev,
                           generator=generator))
           .add(bnn.ReLU())
           .add(bnn.Linear(ff_mult * d_model, d_model, device=dev,
                           generator=generator)))
    attn = bnn.MultiHeadAttention(d_model, n_head, causal=True, flash=flash,
                                  device=dev, generator=generator)
    return (bnn.Sequential()
            .add(_Residual(d_model, attn, device=dev))
            .add(_Residual(d_model, ffn, device=dev)))


def transformer_lm(vocab_size: int, d_model: int = 128, n_head: int = 4,
                   n_layers: int = 2, max_len: int = 4096,
                   tp: bool = False, moe_experts: int = 0, remat=False,
                   flash: bool = False, device: DeviceLike = "cuda",
                   seed: int = 0) -> bnn.Sequential:
    """Token ids (B, T), 1-based floats -> log-probs (B, T, vocab).

    ``flash=True`` sets every block's attention on the flash kernel (the
    JAX package's bench sets ``m.flash = True`` on each
    ``MultiHeadAttention`` after building).  Initial weights are drawn from
    one CPU generator seeded with ``seed``.  A ``remat`` left at its default
    resolves against the ``bigdl.remat.policy`` preset
    (:func:`_default_remat`); wherever it resolves to remat this raises
    :class:`NotImplementedError`, since ``Remat`` is not ported."""
    _not_in_slice(tp, moe_experts, _default_remat(remat))
    dev = default_device(device)
    g = torch.Generator().manual_seed(seed)
    m = (bnn.Sequential()
         .add(bnn.LookupTable(vocab_size, d_model, device=dev, generator=g))
         .add(PositionalEncoding(d_model, max_len, device=dev)))
    for _ in range(n_layers):
        m.add(transformer_block(d_model, n_head, flash=flash, device=dev,
                                generator=g))
    m.add(LayerNorm(d_model, device=dev))
    m.add(bnn.Linear(d_model, vocab_size, device=dev, generator=g))
    m.add(bnn.LogSoftMax())
    return m
