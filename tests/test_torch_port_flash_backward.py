"""The port's flash-attention backward held against the JAX package, on the
CPU.

The port's ``flash_attention`` under autograd runs its
``FlashAttentionFunction``; on CPU tensors that is the plain forward (with
the log-sum-exp) and the plain backward, ``flash_attention_bwd_reference``,
written out as the TPU module's ``mha_reference_bwd``.  Their dq, dk and dv
are held against two oracles from the same numpy inputs:

* ``jax.vjp`` of ``bigdl_tpu.nn.attention.scaled_dot_product_attention``;
* the installed Pallas module's ``mha_reference_bwd`` (it takes only
  ``sm_scale == 1``, so the scale is folded into q and the chain rule
  applied to dq), fed the JAX reference's own residuals.

The plain forward's ``lse`` is held against ``m + log(l)`` of
``mha_reference_no_custom_vjp(..., save_residuals=True)``, and
``MultiHeadAttention(flash=True)``'s parameter gradients against the JAX
``MultiHeadAttention``'s.  The hand kernels themselves run only on a card,
where ``chip_smoke.py`` holds them against the same plain backward.

Tolerance: fp32 atol 1e-5 / rtol 1e-5 (two fp32 computations of the same
sums in other orders).

The bf16 dK/dV kernel's numerical design (``flash_bwd_dkv_wgmma_bf16_kernel``
in ``bigdl_tpu_torch/csrc/flash_attention_bwd.cu``) is emulated too: bf16
inputs, S and dP summed in fp32, P from the forward's fp32 ``lse`` and dS in
fp32, both rounded to bf16 before ``dV = P^T dO`` and ``dK = s dS^T Q``
(fp32 sums), the outputs rounded to bf16.  It is held against ``jax.vjp``
of the attention on the same bf16 values in fp32 within max|diff| /
max|ref| 2e-2, the card's bf16 backward gate.  So is the bf16 dQ kernel's
(``flash_bwd_dq_wgmma_bf16_kernel``), which rounds the same dS to bf16
before ``dQ = s dS K`` (fp32 sums), dQ rounded to bf16.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as pallas_fa

from bigdl_tpu.nn.attention import MultiHeadAttention as JaxMHA
from bigdl_tpu.nn.attention import \
    scaled_dot_product_attention as jax_sdpa
from bigdl_tpu_torch.kernels import flash_attention as fa
from bigdl_tpu_torch.nn import MultiHeadAttention
from bigdl_tpu_torch.utils.convert import params_from_jax

ATOL = RTOL = 1e-5
RTOL_BF16 = 2e-2   # the card's bf16 backward gate, max|diff| / max|ref|
DH = 128
SCALE = 1.0 / math.sqrt(DH)
SHAPES = [(128, 1), (256, 2)]     # (T, H)


def _inputs(t, h, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, t, h, DH)).astype(np.float32)
            for _ in range(4)]    # q, k, v, do


def _port_grads(q, k, v, do, causal):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = fa.flash_attention(qt, kt, vt, causal=causal)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _bhtd(x):
    return jnp.asarray(np.transpose(x, (0, 2, 1, 3)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,h", SHAPES)
def test_backward_matches_jax_vjp(t, h, causal):
    q, k, v, do = _inputs(t, h, seed=t + h)
    out, grads = _port_grads(q, k, v, do, causal)

    @jax.jit
    def fwd_and_vjp(a, b, c, d):
        ref, vjp = jax.vjp(lambda x, y, z: jax_sdpa(x, y, z, causal=causal),
                           a, b, c)
        return ref, vjp(d)

    ref, ref_grads = fwd_and_vjp(*(jnp.asarray(x) for x in (q, k, v, do)))
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL, rtol=RTOL)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g, np.asarray(r), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,h", SHAPES)
def test_backward_matches_pallas_mha_reference_bwd(t, h, causal):
    q, k, v, do = _inputs(t, h, seed=10 + t + h)
    _, grads = _port_grads(q, k, v, do, causal)
    # mha_reference_bwd takes sm_scale == 1 only: fold the scale into q
    qs, kb, vb, dob = _bhtd(q * SCALE), _bhtd(k), _bhtd(v), _bhtd(do)
    o, l, m = pallas_fa.mha_reference_no_custom_vjp(
        qs, kb, vb, causal=causal, save_residuals=True)
    dqs, dk, dv, _ = pallas_fa.mha_reference_bwd(
        qs, kb, vb, None, None, o, l, m, dob, causal=causal)
    ref = [np.transpose(np.asarray(x), (0, 2, 1, 3))
           for x in (dqs * SCALE, dk, dv)]   # d/dq = SCALE * d/d(q*SCALE)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,h", SHAPES)
def test_forward_lse_is_m_plus_log_l(t, h, causal):
    q, k, v, _ = _inputs(t, h, seed=20 + t + h)
    out, lse = fa.flash_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), causal, SCALE,
        return_lse=True)
    assert lse.shape == (2, h, t) and lse.dtype == torch.float32
    o, l, m = pallas_fa.mha_reference_no_custom_vjp(
        _bhtd(q), _bhtd(k), _bhtd(v), causal=causal, sm_scale=SCALE,
        save_residuals=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(m + jnp.log(l)),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out.numpy(),
                               np.transpose(np.asarray(o), (0, 2, 1, 3)),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [True, False])
def test_mha_flash_parameter_grads_match_jax(causal):
    n_head, t = 2, 128
    d = n_head * DH
    jm = JaxMHA(d, n_head, causal=causal)
    jm.reset(jax.random.PRNGKey(7))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, t, d)).astype(np.float32)
    w = rng.standard_normal((2, t, d)).astype(np.float32)

    def jloss(params, xs):
        out, _ = jm.apply(params, xs, jm.state)
        return jnp.sum(out * jnp.asarray(w))

    jgrads, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jm.params,
                                                           jnp.asarray(x))
    pm = MultiHeadAttention(d, n_head, causal=causal, flash=True,
                            device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), pm)
    xt = torch.from_numpy(x).requires_grad_(True)
    (pm(xt) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-4,
                               rtol=RTOL)
    for name, p in pm.named_parameters():
        # the MHA weights are (in, out) in both packages
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[name]),
                                   atol=1e-4, rtol=RTOL, err_msg=name)


def test_cpu_backward_launches_nothing_and_keeps_bf16():
    before = dict(fa.launches)
    q, k, v, do = (torch.from_numpy(x).bfloat16() for x in _inputs(128, 1, 3))
    for x in (q, k, v):
        x.requires_grad_(True)
    out = fa.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert out.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 for g in grads)
    assert fa.launches == before


def test_kernel_launchers_refuse_cpu_tensors():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(128, 1, 4))
    lse = torch.zeros(2, 1, 128)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        fa.flash_attention_fwd(q, k, v, True, SCALE, with_lse=True)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        fa.flash_attention_bwd_dkv(q, k, v, do, lse, lse, True, SCALE)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        fa.flash_attention_bwd_dq(q, k, v, do, lse, lse, True, SCALE)
    assert fa._libs == {}


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).bfloat16().float()


def bwd_bf16(q, k, v, do, causal: bool):
    """The bf16 backward kernels' arithmetic on (B, T, H, Dh) fp32 tensors
    that hold bf16 values: (dq, dk, dv) rounded to bf16."""
    qf, kf, vf, dof = (x.transpose(1, 2) for x in (q, k, v, do))
    # the forward kernel's outputs: lse in fp32, o rounded to bf16
    o, lse = fa.flash_attention_reference(q, k, v, causal, SCALE,
                                          return_lse=True)
    di = (o.bfloat16().float() * do).sum(dim=-1).transpose(1, 2)[..., None]
    s = qf @ kf.transpose(-1, -2)
    p = torch.exp2(s * (SCALE * 1.4426950408889634)
                   - lse[..., None] * 1.4426950408889634)
    if causal:
        p = p * torch.ones(p.shape[-2:], dtype=torch.bool).tril()
    ds = (p * (dof @ vf.transpose(-1, -2) - di)).bfloat16().float()
    dq = ds @ kf * SCALE
    dv = p.bfloat16().float().transpose(-1, -2) @ dof
    dk = ds.transpose(-1, -2) @ qf * SCALE
    return tuple(x.transpose(1, 2).bfloat16().float() for x in (dq, dk, dv))


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_dkv_design_holds_the_bf16_gate(causal):
    q, k, v, do = (_bf16(x) for x in _inputs(256, 2, seed=30 + causal))

    @jax.jit
    def vjp_kv(a, b, c, d):
        _, vjp = jax.vjp(lambda y, z: jax_sdpa(a, y, z, causal=causal), b, c)
        return vjp(d)

    ref = vjp_kv(*(jnp.asarray(x.numpy()) for x in (q, k, v, do)))
    for name, out, r in zip(("dk", "dv"), bwd_bf16(q, k, v, do, causal)[1:],
                            ref):
        r = np.asarray(r)
        err = np.abs(out.numpy() - r).max() / np.abs(r).max()
        print(f"causal={causal} {name}: bf16 design max|diff|/max|ref| "
              f"{err:.3e} (limit {RTOL_BF16})")
        assert err <= RTOL_BF16


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_dq_design_holds_the_bf16_gate(causal):
    q, k, v, do = (_bf16(x) for x in _inputs(256, 2, seed=40 + causal))

    @jax.jit
    def vjp_q(a, b, c, d):
        _, vjp = jax.vjp(lambda x: jax_sdpa(x, b, c, causal=causal), a)
        return vjp(d)[0]

    r = np.asarray(vjp_q(*(jnp.asarray(x.numpy()) for x in (q, k, v, do))))
    out = bwd_bf16(q, k, v, do, causal)[0].numpy()
    err = np.abs(out - r).max() / np.abs(r).max()
    print(f"causal={causal} dq: bf16 design max|diff|/max|ref| {err:.3e} "
          f"(limit {RTOL_BF16})")
    assert err <= RTOL_BF16
