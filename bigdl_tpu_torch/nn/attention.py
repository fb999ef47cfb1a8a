"""Attention (``bigdl_tpu/nn/attention.py``: ``scaled_dot_product_attention``
:37, ``paged_attention`` :58, ``MultiHeadAttention`` :158).

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
                                 v: torch.Tensor, causal: bool = False,
                                 mask: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """(B, T, H, Dh) q/k/v -> (B, T, H, Dh); softmax over the key axis.
    The causal mask is bottom-right aligned (query i attends keys up to
    i + Tk - Tq); ``mask`` (broadcast to (B, H, Tq, Tk), True = keep)
    masks further.  Masked scores take the dtype's finite minimum, so a
    fully masked row softmaxes to uniform values instead of NaN."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    neg_big = torch.finfo(scores.dtype).min
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        cm = torch.ones(tq, tk, dtype=torch.bool,
                        device=scores.device).tril(diagonal=tk - tq)
        scores = scores.masked_fill(~cm, neg_big)
    if mask is not None:
        scores = scores.masked_fill(~mask, neg_big)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def paged_attention(q: torch.Tensor, k_ctx: torch.Tensor,
                    v_ctx: torch.Tensor, valid: torch.Tensor
                    ) -> torch.Tensor:
    """Decode-step attention over a context gathered from the paged KV
    cache: (B, T, H, Dh) ``q`` (T = 1 on the decode path) against the
    (B, S, H, Dh) ``k_ctx``/``v_ctx`` rows of each sequence's block table,
    under the (B, S) mask ``valid`` of real context positions.  The
    numerics of :func:`scaled_dot_product_attention` with an explicit
    mask: an invalid key's probability underflows to 0.0, and a fully
    masked row (an inactive decode slot) gives finite junk that the host
    discards."""
    return scaled_dot_product_attention(q, k_ctx, v_ctx, causal=False,
                                        mask=valid[:, None, None, :])


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

    # -- the decode-cache path (serving/lm.py) ----------------------------

    def project_step(self, x: torch.Tensor):
        """Per-head q, k, v of one decode or prefill span, each
        (B, T, H, Dh): the serving path scatters k and v into the paged
        pool between projection and attention, so the current token is in
        the cache before the gather and attends to itself."""
        return (self._project(x, "wq", "bq"), self._project(x, "wk", "bk"),
                self._project(x, "wv", "bv"))

    def attend_cached(self, q: torch.Tensor, k_ctx: torch.Tensor,
                      v_ctx: torch.Tensor, valid: torch.Tensor
                      ) -> torch.Tensor:
        """:func:`paged_attention` of (B, T, H, Dh) ``q`` over the gathered
        (B, S, H, Dh) context under the (B, S) mask ``valid``, then the
        output projection: (B, T, D)."""
        out = paged_attention(q, k_ctx, v_ctx, valid)
        return self._output(out)

    def _output(self, out: torch.Tensor) -> torch.Tensor:
        bsz, t = out.shape[0], out.shape[1]
        out = out.reshape(bsz, t, -1) @ self.wo
        if self.with_bias:
            out = out + self.bo
        return out

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
        return self._output(out)
