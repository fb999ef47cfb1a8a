"""Attention (``bigdl_tpu/nn/attention.py``: ``scaled_dot_product_attention``
:37, ``paged_attention`` :58, ``chunked_attention`` :77,
``MultiHeadAttention`` :158).

Shapes follow the JAX package: (B, T, D) activations, per-head (B, T, H, Dh)
q/k/v.  ``flash=True`` runs :func:`bigdl_tpu_torch.kernels.flash_attention.
flash_attention`, which launches the hand-written Hopper kernels on CUDA
tensors (the forward, and under autograd the dK/dV and dQ backward) and
their plain versions on CPU tensors.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from bigdl_tpu_torch.engine import bound_axis
from bigdl_tpu_torch.kernels.flash_attention import flash_attention
from bigdl_tpu_torch.nn.module import Module, make_generator


@torch.library.custom_op("bigdl_tpu_torch::attn_ctx", mutates_args=())
def attn_ctx(x: torch.Tensor) -> torch.Tensor:
    """The attention context, named for selective rematerialisation (the
    JAX package's ``checkpoint_name(out, "attn_ctx")``): an identity op
    that ``Remat(policy="save_attn")`` saves
    (:mod:`bigdl_tpu_torch.nn.structural`)."""
    return x.clone()


@attn_ctx.register_fake
def _(x):
    return torch.empty_like(x)


attn_ctx.register_autograd(lambda ctx, grad: grad)

#: how many ``save_attn`` Remat regions are live: only inside one does the
#: attention context pass through :func:`attn_ctx` (a copy elsewhere)
_NAMING = {"depth": 0}


@contextlib.contextmanager
def naming_attn_ctx():
    """Route every attention context through :func:`attn_ctx` for the
    block."""
    _NAMING["depth"] += 1
    try:
        yield
    finally:
        _NAMING["depth"] -= 1


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


def _chunk_step(qc: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q_start: int, causal: bool, scale: float) -> torch.Tensor:
    scores = torch.einsum("bqhd,bkhd->bhqk", qc, k) * scale
    if causal:
        q_pos = q_start + torch.arange(qc.shape[1], device=qc.device)
        k_pos = torch.arange(k.shape[1], device=qc.device)
        allowed = q_pos[:, None] >= k_pos[None, :]
        scores = scores.masked_fill(~allowed, torch.finfo(qc.dtype).min)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = False, chunk: int = 1024
                      ) -> torch.Tensor:
    """Query-chunked attention: the numerics of
    :func:`scaled_dot_product_attention` (the scores scaled by
    1/sqrt(Dh) as a product, as the JAX package's ``chunked_attention``
    does), with O(T * chunk) score memory instead of O(T^2).

    Each block of ``chunk`` query rows attends the whole K/V, under
    ``torch.utils.checkpoint`` when autograd records, so that the
    backward recomputes each block's (B, H, chunk, Tk) probabilities
    instead of keeping them all (the JAX package's ``jax.checkpoint`` of
    its ``lax.scan`` body).  The causal mask is bottom-right aligned: query
    row i of block b attends keys up to ``b * chunk + i + (Tk - T)``.  The
    fully masked upper blocks are computed all the same.  Raises
    :class:`ValueError` unless ``chunk`` divides T."""
    bsz, t, h, dh = q.shape
    tk = k.shape[1]
    if t % chunk != 0:
        raise ValueError(f"chunked attention needs T divisible by the "
                         f"chunk size: T={t}, chunk={chunk}")
    scale = 1.0 / math.sqrt(dh)
    record = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    outs = []
    for i in range(t // chunk):
        qc = q[:, i * chunk:(i + 1) * chunk]
        args = (qc, k, v, i * chunk + (tk - t), causal, scale)
        outs.append(checkpoint(_chunk_step, *args, use_reentrant=False)
                    if record else _chunk_step(*args))
    return torch.cat(outs, dim=1)


class MultiHeadAttention(Module):
    """Self-attention over (B, T, D) input; a (q_src, kv_src) pair gives
    cross-attention.  The weights keep the JAX package's (in, out) layout
    (``x @ wq``) and names.

    ``flash=True`` keeps the JAX package's constraints: equal q/kv sequence
    lengths divisible by 128 and head_dim divisible by 128, else
    :class:`ValueError`.  ``chunk=N`` runs :func:`chunked_attention`, the
    second long-context path (``flash`` with ``chunk`` raises).

    ``model_parallel`` names the mesh axis of the Megatron head split
    (:meth:`set_model_parallel`; the tensor-parallel trainer sets it).
    While that axis is bound (:func:`bigdl_tpu_torch.engine.bind_axes`) the
    module holds its rank's heads: wq/wk/wv and their biases the columns of
    ``n_head / n`` heads, wo the matching rows; its input passes the
    backward's all-reduce, its output the forward's, then ``bo``.

    ``sequence_parallel`` names the mesh axis of ring attention
    (:meth:`set_sequence_parallel`; the trainer of a ``seq`` mesh sets it).
    While that axis is bound the input is this rank's slice of the
    sequence and the attention runs as the ring
    (:mod:`bigdl_tpu_torch.parallel.ring_attention`); a plain forward is
    unaffected.  The ring is self-attention only, and excludes ``flash``
    and the head split, as in the JAX package."""

    #: the mesh axis of the Megatron head split (None: no split)
    model_parallel: Optional[str] = None
    #: the mesh axis of ring sequence parallelism (None: off)
    sequence_parallel: Optional[str] = None

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
        self.chunk = chunk
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

    def set_model_parallel(self, axis_name: Optional[str]
                           ) -> "MultiHeadAttention":
        """The Megatron head split over the mesh axis ``axis_name`` (None:
        off).  The flash kernel does not split: raises
        :class:`ValueError` with ``flash=True``, as the JAX package
        does."""
        if axis_name and self.flash:
            raise ValueError("flash kernel is incompatible with the "
                             "Megatron head split (pallas kernels do not "
                             "partition)")
        if axis_name and self.sequence_parallel:
            raise ValueError("pick one of model_parallel / "
                             "sequence_parallel per attention layer")
        self.model_parallel = axis_name
        return self

    def set_sequence_parallel(self, axis_name: Optional[str]
                              ) -> "MultiHeadAttention":
        """Ring attention over the mesh axis ``axis_name`` (None: off),
        engaged only while the axis is bound.  Raises :class:`ValueError`
        with ``flash=True`` or a head split, as the JAX package does."""
        if axis_name and self.flash:
            raise ValueError("flash kernel and ring sequence parallelism "
                             "are mutually exclusive")
        if axis_name and self.model_parallel:
            raise ValueError("pick one of model_parallel / "
                             "sequence_parallel per attention layer")
        self.sequence_parallel = axis_name
        return self

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
        # -1 heads: under the head split the weights hold the local heads
        return y.reshape(bsz, t, -1, self.head_dim)

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

    def _output(self, out: torch.Tensor, tp=None) -> torch.Tensor:
        bsz, t = out.shape[0], out.shape[1]
        out = out.reshape(bsz, t, -1) @ self.wo
        if tp is not None:
            from bigdl_tpu_torch.parallel.tensor_parallel import \
                reduce_from_model
            out = reduce_from_model(out, tp[0])   # the pair's one reduce
        if self.with_bias:
            out = out + self.bo
        return out

    def forward(self, input):
        if isinstance(input, (list, tuple)):
            q_src, kv_src = input[0], input[1]
        else:
            q_src = kv_src = input
        tp = bound_axis(self.model_parallel)
        if tp is not None:
            from bigdl_tpu_torch.parallel.tensor_parallel import \
                copy_to_model
            same = q_src is kv_src
            q_src = copy_to_model(q_src, tp[0])
            kv_src = q_src if same else copy_to_model(kv_src, tp[0])
        q = self._project(q_src, "wq", "bq")
        k = self._project(kv_src, "wk", "bk")
        v = self._project(kv_src, "wv", "bv")
        sp = bound_axis(self.sequence_parallel)
        if sp is not None:
            if q_src is not kv_src:
                raise ValueError("sequence-parallel MHA is self-attention "
                                 "only (q and kv must be the same source)")
            from bigdl_tpu_torch.parallel.ring_attention import \
                _ring_attention_shard
            out = _ring_attention_shard(q, k, v, sp[0], self.causal)
        elif self.chunk:
            out = chunked_attention(q, k, v, causal=self.causal,
                                    chunk=self.chunk)
        elif self.flash:
            self._flash_check(q, k)
            out = flash_attention(q, k, v, causal=self.causal,
                                  sm_scale=1.0 / math.sqrt(self.head_dim))
        else:
            out = scaled_dot_product_attention(q, k, v, causal=self.causal)
        if _NAMING["depth"]:
            out = attn_ctx(out)
        return self._output(out, tp)
