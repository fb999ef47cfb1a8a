"""Attention (``bigdl_tpu/nn/attention.py``: ``scaled_dot_product_attention``
:37, ``MultiHeadAttention`` :158).

Shapes follow the JAX package: (B, T, D) activations, per-head (B, T, H, Dh)
q/k/v.  ``flash=True`` runs :func:`bigdl_tpu_torch.kernels.flash_attention.
flash_attention`, which launches the hand-written Hopper kernels on CUDA
tensors (the forward, and under autograd the dK/dV and dQ backward) and
their plain versions on CPU tensors.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from bigdl_tpu_torch.kernels.flash_attention import flash_attention
from bigdl_tpu_torch.nn.module import Module, make_generator


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, causal: bool = False
                                 ) -> torch.Tensor:
    """(B, T, H, Dh) q/k/v -> (B, T, H, Dh); softmax over the key axis.
    The causal mask is bottom-right aligned (query i attends keys up to
    i + Tk - Tq), and masked scores take the dtype's finite minimum, so a
    fully masked row softmaxes to uniform values instead of NaN."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    neg_big = torch.finfo(scores.dtype).min
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        cm = torch.ones(tq, tk, dtype=torch.bool,
                        device=scores.device).tril(diagonal=tk - tq)
        scores = scores.masked_fill(~cm, neg_big)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


class MultiHeadAttention(Module):
    """Self-attention over (B, T, D) input; a (q_src, kv_src) pair gives
    cross-attention.  The weights keep the JAX package's (in, out) layout
    (``x @ wq``) and names.

    ``flash=True`` keeps the JAX package's constraints: equal q/kv sequence
    lengths divisible by 128 and head_dim divisible by 128, else
    :class:`ValueError`.  ``chunk`` attention, ring sequence parallelism and
    the Megatron head split are not in this slice."""

    def __init__(self, hidden_size: int, n_head: int, causal: bool = False,
                 with_bias: bool = True, flash: bool = False,
                 chunk: Optional[int] = None,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if hidden_size % n_head != 0:
            raise ValueError(f"hidden {hidden_size} % heads {n_head} != 0")
        if flash and chunk:
            raise ValueError("flash and chunk are alternative long-context "
                             "paths; pick one")
        if chunk:
            raise NotImplementedError("chunked attention is not ported yet")
        self.hidden_size = hidden_size
        self.n_head = n_head
        self.head_dim = hidden_size // n_head
        self.causal = causal
        self.with_bias = with_bias
        self.flash = flash
        g = make_generator(generator)
        d = hidden_size
        bound = math.sqrt(6.0 / (d + d))   # Xavier, as the JAX package
        for w in ("wq", "wk", "wv", "wo"):
            t = torch.empty(d, d).uniform_(-bound, bound, generator=g)
            self.register_parameter(w, nn.Parameter(t.to(device)))
        for b in ("bq", "bk", "bv", "bo"):
            self.register_parameter(
                b, nn.Parameter(torch.zeros(d, device=device))
                if with_bias else None)

    def _flash_check(self, q: torch.Tensor, k: torch.Tensor) -> None:
        if not (q.shape[1] == k.shape[1] and q.shape[1] % 128 == 0 and
                self.head_dim % 128 == 0):
            raise ValueError(
                "flash=True needs equal q/kv sequence lengths divisible by "
                "128, and head_dim divisible by 128 "
                f"(got q {tuple(q.shape)}, k {tuple(k.shape)}, head_dim "
                f"{self.head_dim})")

    def _project(self, x: torch.Tensor, w: str, b: str) -> torch.Tensor:
        y = x @ getattr(self, w)
        if self.with_bias:
            y = y + getattr(self, b)
        bsz, t, _ = y.shape
        return y.reshape(bsz, t, self.n_head, self.head_dim)

    def forward(self, input):
        if isinstance(input, (list, tuple)):
            q_src, kv_src = input[0], input[1]
        else:
            q_src = kv_src = input
        q = self._project(q_src, "wq", "bq")
        k = self._project(kv_src, "wk", "bk")
        v = self._project(kv_src, "wv", "bv")
        if self.flash:
            self._flash_check(q, k)
            out = flash_attention(q, k, v, causal=self.causal,
                                  sm_scale=1.0 / math.sqrt(self.head_dim))
        else:
            out = scaled_dot_product_attention(q, k, v, causal=self.causal)
        bsz, t = out.shape[0], out.shape[1]
        out = out.reshape(bsz, t, -1) @ self.wo
        if self.with_bias:
            out = out + self.bo
        return out
