"""Decoder-only transformer language model
(``bigdl_tpu/models/transformer/__init__.py``).

Causal multi-head attention blocks with pre-norm residuals, the same layer
order and parameter tree as the JAX package, so its parameters load with
:func:`bigdl_tpu_torch.utils.convert.params_from_jax`.  ``tp=True`` tags
the MLP pair for the Megatron split, ``moe_experts`` makes every block's
feed-forward a :class:`~bigdl_tpu_torch.nn.MixtureOfExperts`, ``remat``
wraps every block in :class:`~bigdl_tpu_torch.nn.Remat`.
``transformer_lm_pipeline`` splits the same model into ``(embed, blocks,
head)`` for the GPipe trainer.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

import bigdl_tpu_torch.nn as bnn
from bigdl_tpu_torch.engine import DeviceLike, bound_axis, default_device
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
    caller's admission checks, as the JAX package leaves a traced one.

    Under sequence parallelism (:meth:`set_sequence_parallel`, wired by the
    trainer) each time shard offsets into the table by its chunk's start,
    ``coord * T``, while the ``seq`` axis is bound; a shard past the table
    raises rather than clamp."""

    #: the mesh axis of sequence parallelism (None: off)
    sequence_parallel: Optional[str] = None

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
        """The table's capacity: a sequence-parallel trainer checks the
        global T against it."""
        return int(self.pe.shape[0])

    def set_sequence_parallel(self, axis_name: Optional[str]
                              ) -> "PositionalEncoding":
        self.sequence_parallel = axis_name
        return self

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
        sp = bound_axis(self.sequence_parallel)
        if sp is not None:
            offset = sp[2] * t + offset
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
                      moe_capacity_factor: float = 1.25,
                      moe_top_k: int = 1, flash: bool = False,
                      device: DeviceLike = "cuda",
                      generator: Optional[torch.Generator] = None
                      ) -> bnn.Sequential:
    """One pre-norm decoder block: causal MHA + ReLU MLP, both residual.

    ``tp=True`` tags the MLP pair column/row for the Megatron split (the
    attention's head split needs no tag).  ``moe_experts=E`` makes the MLP
    a :class:`~bigdl_tpu_torch.nn.MixtureOfExperts` of E such MLPs, with
    ``moe_capacity_factor`` and ``moe_top_k`` (1: Switch, 2: GShard).
    ``tp`` with ``moe_experts`` raises :class:`ValueError`, as in the JAX
    package."""
    from bigdl_tpu_torch.parallel.tensor_parallel import (column_parallel,
                                                          row_parallel)
    if moe_experts and tp:
        raise ValueError("pick one of tp / moe_experts per block")
    dev = default_device(device)
    up = bnn.Linear(d_model, ff_mult * d_model, device=dev,
                    generator=generator)
    down = bnn.Linear(ff_mult * d_model, d_model, device=dev,
                      generator=generator)
    if tp:
        column_parallel(up)
        row_parallel(down)
    ffn = bnn.Sequential().add(up).add(bnn.ReLU()).add(down)
    if moe_experts:
        ffn = bnn.MixtureOfExperts(d_model, ffn, moe_experts,
                                   capacity_factor=moe_capacity_factor,
                                   top_k=moe_top_k, device=dev,
                                   generator=generator)
    attn = bnn.MultiHeadAttention(d_model, n_head, causal=True, flash=flash,
                                  device=dev, generator=generator)
    return (bnn.Sequential()
            .add(_Residual(d_model, attn, device=dev))
            .add(_Residual(d_model, ffn, device=dev)))


def transformer_lm(vocab_size: int, d_model: int = 128, n_head: int = 4,
                   n_layers: int = 2, max_len: int = 4096,
                   tp: bool = False, moe_experts: int = 0,
                   moe_top_k: int = 1, remat=False, flash: bool = False,
                   device: DeviceLike = "cuda",
                   seed: int = 0) -> bnn.Sequential:
    """Token ids (B, T), 1-based floats -> log-probs (B, T, vocab).

    ``moe_experts=E`` gives every block an MoE feed-forward routed
    ``moe_top_k`` ways (train on a ``("data", "expert")`` mesh for expert
    parallelism); ``tp=True`` tags the Megatron splits (train on a
    ``("data", "model")`` mesh).  ``remat`` wraps every block in
    :class:`~bigdl_tpu_torch.nn.Remat`: ``True`` saves nothing,
    ``"dots"`` the matmul outputs, ``"save_attn"`` the attention context;
    left at its default it resolves against the ``bigdl.remat.policy``
    preset (:func:`_default_remat`).  ``flash=True`` sets every block's
    attention on the flash kernel (the JAX package's bench sets
    ``m.flash = True`` on each ``MultiHeadAttention`` after building).
    Initial weights are drawn from one CPU generator seeded with
    ``seed``."""
    remat = _default_remat(remat)
    dev = default_device(device)
    g = torch.Generator().manual_seed(seed)
    m = (bnn.Sequential()
         .add(bnn.LookupTable(vocab_size, d_model, device=dev, generator=g))
         .add(PositionalEncoding(d_model, max_len, device=dev)))
    for _ in range(n_layers):
        block = transformer_block(d_model, n_head, tp=tp,
                                  moe_experts=moe_experts,
                                  moe_top_k=moe_top_k, flash=flash,
                                  device=dev, generator=g)
        if remat:
            block = bnn.Remat(block, policy=None if remat is True else remat)
        m.add(block)
    m.add(LayerNorm(d_model, device=dev))
    m.add(bnn.Linear(d_model, vocab_size, device=dev, generator=g))
    m.add(bnn.LogSoftMax())
    return m


def transformer_lm_pipeline(vocab_size: int, d_model: int = 128,
                            n_head: int = 4, n_layers: int = 2,
                            max_len: int = 4096, moe_experts: int = 0,
                            moe_top_k: int = 1, remat=False,
                            tp: bool = False, device: DeviceLike = "cuda",
                            seed: int = 0):
    """``(embed, blocks, head)`` for
    :class:`~bigdl_tpu_torch.parallel.pipeline.PipelineOptimizer`: the
    embedding and the LM head run replicated, the ``n_layers`` homogeneous
    decoder blocks pipeline over a ``stage`` mesh axis, one block a stage
    rank (the driver's ``--pipeline``).  ``moe_experts=E`` gives every
    block an MoE feed-forward, whose ``aux_loss`` the trainer folds into
    its objective; ``tp=True`` Megatron-tags each block for the ``("data",
    "stage", "model")`` composition; ``remat`` wraps each block in
    :class:`~bigdl_tpu_torch.nn.Remat`.  The parameters are
    :func:`transformer_lm`'s (same ``seed``, same draws in the same order):
    ``embed`` holds its first two layers, ``blocks`` its decoder blocks,
    ``head`` its last three."""
    remat = _default_remat(remat)
    dev = default_device(device)
    g = torch.Generator().manual_seed(seed)
    embed = (bnn.Sequential()
             .add(bnn.LookupTable(vocab_size, d_model, device=dev,
                                  generator=g))
             .add(PositionalEncoding(d_model, max_len, device=dev)))
    blocks = [transformer_block(d_model, n_head, tp=tp,
                                moe_experts=moe_experts,
                                moe_top_k=moe_top_k, device=dev, generator=g)
              for _ in range(n_layers)]
    if remat:
        policy = None if remat is True else remat
        blocks = [bnn.Remat(b, policy=policy) for b in blocks]
    head = (bnn.Sequential()
            .add(LayerNorm(d_model, device=dev))
            .add(bnn.Linear(d_model, vocab_size, device=dev, generator=g))
            .add(bnn.LogSoftMax()))
    return embed, blocks, head
