"""The numerical design of the port's fp32 flash-attention forward kernel
(``flash_fwd_tf32x3_kernel`` in ``bigdl_tpu_torch/csrc/flash_attention_fwd.cu``)
held against the JAX package, on the CPU.

The kernel runs every fp32 product as split TF32 on the tensor cores:
with ``x_hi = tf32_rna(x)`` and ``x_lo = tf32_rna(x - x_hi)``,
``a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi``.  Here ``tf32_rna`` is emulated
exactly as the kernel computes it, with integer operations on the fp32 bit
pattern, and the forward is built from it with both products (``Q K^T`` and
``P V``) split, its softmax in exp2 on unnormalised probabilities as the
kernel runs it.  (The kernel's online softmax rescales per key tile; that
changes only the rounding of the running sums, not the split products.)
A TF32 product of two tf32 values is exact in fp32, so fp32 matmuls of the
split operands give the tensor cores' products; only the order of the sums
differs.

Inputs come from a numpy seed at (1, 2048, 1, 128), the main path's
sequence length, causal and not.  Tolerances:

* against ``bigdl_tpu.nn.attention.scaled_dot_product_attention`` in fp32:
  atol 1e-4, the fp32 forward gate that ``chip_smoke.py`` holds the kernel
  to on the card;
* against the same attention in fp64: atol 1e-5, ten times tighter.  The
  split keeps about 2^-21 of each product; what remains is fp32 rounding
  of the sums (measured here below 1e-6).

Single-pass TF32 (``a_hi b_hi`` alone) is printed beside them, not
asserted: its error against fp64 (measured here 1.0e-3 causal, 9.1e-5 not)
is why the kernel splits.

The fp32 dQ kernel (``flash_bwd_dq_tf32x3_kernel`` in
``bigdl_tpu_torch/csrc/flash_attention_bwd.cu``) splits all three of its
products the same way: ``S = Q K^T`` and ``dP = dO V^T`` with Q, K, dO and
V split, ``P = exp2(S s log2e - lse log2e)`` from the forward's ``lse``,
``dS = P (dP - di)``, and ``dQ = s dS K`` with dS and K split.  Its
emulation here takes ``lse`` and ``o`` (for ``di``) from the emulated
3xTF32 forward, as the kernel takes them from the forward kernel, and is
held against ``jax.vjp`` of the same attention, max|diff| / max|ref|:
within 1e-4 in fp32 (the card's fp32 backward gate) and 1e-5 in fp64.

The fp32 dK/dV kernel (``flash_bwd_dkv_tf32x3_kernel``, same source) splits
all four of its products, ``S^T = K Q^T``, ``dP^T = V dO^T``,
``dV = P^T dO`` and ``dK = s dS^T Q``, from the same P and dS; one
emulation gives dq, dk and dv, and dk and dv are held against ``jax.vjp``
with respect to k and v with the same limits as dQ.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.nn.attention import \
    scaled_dot_product_attention as jax_sdpa

B, T, H, DH = 1, 2048, 1, 128
ATOL_FP32 = 1e-4     # the card's fp32 forward gate
ATOL_FP64 = 1e-5     # against fp64: ten times tighter
RTOL_DQ_FP32 = 1e-4  # the card's fp32 backward gate, max|diff| / max|ref|
RTOL_DQ_FP64 = 1e-5  # against fp64: ten times tighter
LOG2E = 1.4426950408889634


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to tf32 (10 explicit significand bits), to nearest with
    ties away from zero: add half a tf32 ulp to the bit pattern (the sign
    is apart, so this rounds the magnitude) and clear the 13 low bits — the
    kernel's ``tf32_rna``.  int64 keeps the add from overflowing int32."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms
    first as the kernel adds them."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32_rna(a) @ tf32_rna(b)


def attention(q, k, v, causal: bool, mm) -> torch.Tensor:
    """The kernel's forward on (T, Dh) fp32 operands with products by
    ``mm``: exp2 softmax of the scaled scores on unnormalised P, then
    (P V) / l."""
    scale_log2 = (1.0 / math.sqrt(q.shape[-1])) * 1.4426950408889634
    s = mm(q, k.T)
    if causal:
        keep = torch.ones(s.shape, dtype=torch.bool).tril()
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True) * scale_log2
    p = torch.exp2(s * scale_log2 - m)
    return mm(p, v) / p.sum(dim=-1, keepdim=True)


def forward_lse(q, k, v, causal: bool, mm):
    """The emulated forward's output and natural-log log-sum-exp, as the
    kernel writes them: m and l in the exp2 domain, lse = (m + log2 l) ln 2."""
    scale_log2 = (1.0 / math.sqrt(q.shape[-1])) * LOG2E
    s = mm(q, k.T)
    if causal:
        keep = torch.ones(s.shape, dtype=torch.bool).tril()
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True) * scale_log2
    p = torch.exp2(s * scale_log2 - m)
    l = p.sum(dim=-1, keepdim=True)
    return mm(p, v) / l, ((m + torch.log2(l)) / LOG2E)[:, 0]


def bwd_3xtf32(q, k, v, do, causal: bool):
    """The fp32 backward kernels' arithmetic on (T, Dh) fp32 operands:
    (dq, dk, dv), every product split."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = forward_lse(q, k, v, causal, mm_3xtf32)
    di = (o * do).sum(dim=-1, keepdim=True)
    s = mm_3xtf32(q, k.T)
    p = torch.exp2(s * (scale * LOG2E) - lse[:, None] * LOG2E)
    if causal:
        p = p * torch.ones(p.shape, dtype=torch.bool).tril()
    ds = p * (mm_3xtf32(do, v.T) - di)
    return (mm_3xtf32(ds, k) * scale, mm_3xtf32(ds.T, q) * scale,
            mm_3xtf32(p.T, do))


def _qkv(seed: int):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, DH)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_forward_holds_the_fp32_gate(causal):
    q, k, v = _qkv(40 + causal)
    ref32 = np.asarray(jax_sdpa(*(jnp.asarray(x) for x in (q, k, v)),
                                causal=causal))
    ref64 = attention(*(torch.from_numpy(x[0, :, 0]).double()
                        for x in (q, k, v)), causal,
                      lambda a, b: a @ b).numpy()
    q2, k2, v2 = (torch.from_numpy(x[0, :, 0]) for x in (q, k, v))
    out = attention(q2, k2, v2, causal, mm_3xtf32).numpy()
    single = attention(q2, k2, v2, causal, mm_tf32).numpy()
    err32 = np.abs(out - ref32[0, :, 0]).max()
    err64 = np.abs(out - ref64).max()
    print(f"causal={causal}: 3xTF32 max abs err {err32:.3e} vs the JAX "
          f"fp32 attention (atol {ATOL_FP32}), {err64:.3e} vs fp64 (atol "
          f"{ATOL_FP64}); single-pass TF32 {np.abs(single - ref64).max():.3e}"
          " vs fp64 (not asserted)")
    assert err32 <= ATOL_FP32
    assert err64 <= ATOL_FP64


def test_tf32_rna_rounds_to_nearest_with_ties_away():
    ulp = 2.0 ** -10                  # tf32's spacing in [1, 2)
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2),       # ties: away
                      1 + ulp / 2 - 2.0 ** -23,          # just below: down
                      1 + 3 * ulp / 4, 1.0, -0.0, 3.0],
                     dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 1.0, -0.0, 3.0],
                        dtype=torch.float32)
    got = tf32_rna(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_split_keeps_22_bits_and_low_bits_clear():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(4096)
                         .astype(np.float32) * 100)
    hi, lo = split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max().item()
    assert rel <= 2.0 ** -21


@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_dq_holds_the_fp32_backward_gate(causal):
    q, k, v, do = _qkv(50 + causal) + _qkv(60 + causal)[:1]

    def vjp_dq(*xs):
        _, vjp = jax.vjp(lambda a: jax_sdpa(a, xs[1], xs[2], causal=causal),
                         xs[0])
        return vjp(xs[3])[0]

    ref32 = np.asarray(jax.jit(vjp_dq)(*(jnp.asarray(x)
                                          for x in (q, k, v, do))))[0, :, 0]
    with jax.enable_x64(True):
        ref64 = np.asarray(jax.jit(vjp_dq)(
            *(jnp.asarray(x.astype(np.float64))
              for x in (q, k, v, do))))[0, :, 0]
    out = bwd_3xtf32(*(torch.from_numpy(x[0, :, 0]) for x in (q, k, v, do)),
                     causal)[0].numpy()
    err32 = np.abs(out - ref32).max() / np.abs(ref32).max()
    err64 = np.abs(out - ref64).max() / np.abs(ref64).max()
    print(f"causal={causal}: 3xTF32 dQ max|diff|/max|ref| {err32:.3e} vs "
          f"the JAX fp32 vjp (limit {RTOL_DQ_FP32}), {err64:.3e} vs fp64 "
          f"(limit {RTOL_DQ_FP64})")
    assert err32 <= RTOL_DQ_FP32
    assert err64 <= RTOL_DQ_FP64


@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_dkv_holds_the_fp32_backward_gate(causal):
    q, k, v, do = _qkv(70 + causal) + _qkv(80 + causal)[:1]

    def vjp_kv(*xs):
        _, vjp = jax.vjp(lambda b, c: jax_sdpa(xs[0], b, c, causal=causal),
                         xs[1], xs[2])
        return vjp(xs[3])

    refs32 = jax.jit(vjp_kv)(*(jnp.asarray(x) for x in (q, k, v, do)))
    with jax.enable_x64(True):
        refs64 = [np.asarray(r)[0, :, 0] for r in jax.jit(vjp_kv)(
            *(jnp.asarray(x.astype(np.float64)) for x in (q, k, v, do)))]
    outs = bwd_3xtf32(*(torch.from_numpy(x[0, :, 0]) for x in (q, k, v, do)),
                      causal)[1:]
    for name, out, r32, r64 in zip(("dk", "dv"), outs, refs32, refs64):
        out, r32 = out.numpy(), np.asarray(r32)[0, :, 0]
        err32 = np.abs(out - r32).max() / np.abs(r32).max()
        err64 = np.abs(out - r64).max() / np.abs(r64).max()
        print(f"causal={causal} {name}: 3xTF32 max|diff|/max|ref| "
              f"{err32:.3e} vs the JAX fp32 vjp (limit {RTOL_DQ_FP32}), "
              f"{err64:.3e} vs fp64 (limit {RTOL_DQ_FP64})")
        assert err32 <= RTOL_DQ_FP32
        assert err64 <= RTOL_DQ_FP64
