"""Ring attention: sequence parallelism over a mesh's ``seq`` axis
(``bigdl_tpu/parallel/ring_attention.py``: ``_ring_attention_shard`` :32,
``ring_attention`` :71, ``ring_self_attention`` :87).

Each rank of the ``seq`` subgroup holds a T/N slice of q, k and v.  N steps
of a ring: the local queries attend the k/v block in hand with an online
softmax (the flash triple: running max ``m``, normaliser ``l``, unnormalised
output ``o``, all in q's dtype as in the JAX package), then the k/v block
moves one rank on by :func:`~bigdl_tpu_torch.parallel.all_reduce.
ring_permute`.  Rank ``my`` starts on its own diagonal block and at step i
holds the block that started on rank ``(my - i) % n``, so under the causal
mask its running max is finite from the first step and masked scores,
``finfo(dtype).min``, underflow to exact zeros.  The JAX package computes
the ring in XLA, not in Pallas, so the port's ring is torch ops: no flash
kernel runs on it.  The backward flows through ``ring_permute``'s autograd.
The k and v blocks travel as one stacked tensor, one send and one receive
a step.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from bigdl_tpu_torch.parallel.all_reduce import ring_permute


def _ring_attention_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          group=None, causal: bool = False) -> torch.Tensor:
    """The per-rank body: ``q``, ``k``, ``v`` are this rank's (B, T_local, H,
    Dh) slices of the sequence, which ``group``'s members hold in rank
    order; returns this rank's (B, T_local, H, Dh) slice of the output."""
    on = dist.is_initialized()
    n = dist.get_world_size(group) if on else 1
    my = dist.get_rank(group) if on else 0
    bsz, t, h, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    q_pos = my * t + torch.arange(t, device=q.device)
    neg_big = torch.finfo(q.dtype).min
    m = torch.full((bsz, h, t), neg_big, dtype=q.dtype, device=q.device)
    l = torch.zeros((bsz, h, t), dtype=q.dtype, device=q.device)
    o = torch.zeros((bsz, h, t, dh), dtype=q.dtype, device=q.device)
    kv = torch.stack([k, v])
    for i in range(n):
        # the block that started on rank (my - i) is now here
        src = (my - i) % n
        scores = torch.einsum("bqhd,bkhd->bhqk", q, kv[0]) * scale
        if causal:
            k_pos = src * t + torch.arange(t, device=q.device)
            allowed = q_pos[:, None] >= k_pos[None, :]
            scores = scores.masked_fill(~allowed, neg_big)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, kv[1])
        m = m_new
        if i + 1 < n:
            kv = ring_permute(kv, group)
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2)                  # -> (B, T_local, H, Dh)


def _local(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of ``x`` along dim 1."""
    if not dist.is_initialized():
        return x
    n, i = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[1] // n
    return x.narrow(1, i * size, size)


def _check_split(x: torch.Tensor, group) -> None:
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    if x.shape[1] % n:
        raise ValueError(f"sequence length {x.shape[1]} does not split "
                         f"over the {n} ranks of the seq axis")


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis: str = "seq", causal: bool = False
                   ) -> torch.Tensor:
    """Full-sequence attention of global (B, T, H, Dh) ``q``/``k``/``v``
    (the same on every rank) with T split over ``mesh``'s ``axis``: each
    rank runs the ring on its T/N slice and returns its (B, T/N, H, Dh)
    slice of the output, the JAX package's output sharding.  Numerically
    :func:`~bigdl_tpu_torch.nn.attention.scaled_dot_product_attention`'s
    (its causal mask for Tq = Tk)."""
    group = mesh.group(axis)
    for x in (q, k, v):
        _check_split(x, group)
    return _ring_attention_shard(_local(q, group), _local(k, group),
                                 _local(v, group), group, causal)


def ring_self_attention(mha, params: Optional[dict], x: torch.Tensor, mesh,
                        axis: str = "seq") -> torch.Tensor:
    """A :class:`~bigdl_tpu_torch.nn.MultiHeadAttention`'s forward over the
    global (B, T, D) ``x`` with T split over ``mesh``'s ``axis``; returns
    this rank's (B, T/N, D) slice.  The projections are per position (local
    to the slice); only the attention communicates, through the ring.
    ``params`` (by parameter name; None: the module's own) are the
    weights."""
    group = mesh.group(axis)
    _check_split(x, group)
    p = dict(mha.named_parameters()) if params is None else params
    xs = _local(x, group)

    def project(w, b):
        y = xs @ p[w]
        if mha.with_bias:
            y = y + p[b]
        return y.reshape(y.shape[0], y.shape[1], -1, mha.head_dim)

    out = _ring_attention_shard(project("wq", "bq"), project("wk", "bk"),
                                project("wv", "bv"), group, mha.causal)
    out = out.reshape(out.shape[0], out.shape[1], mha.hidden_size) @ p["wo"]
    if mha.with_bias:
        out = out + p["bo"]
    return out
