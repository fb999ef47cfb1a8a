"""The port's attention (``bigdl_tpu_torch``) held against the JAX package.

Inputs come from a numpy seed and go through both packages on the CPU.  The
JAX flash path needs a TPU and raises here, so the JAX side runs as its own
tests run it: its standard path (``scaled_dot_product_attention``,
``MultiHeadAttention(flash=False)``) and the installed Pallas module's
``mha_reference``.  The port's ``flash=True`` runs the flash kernel's plain
version on CPU tensors.  The kernel itself runs only on a card, where
``chip_smoke.py`` holds it against that plain version.

Tolerance: fp32 atol 1e-5, rtol 1e-5 — two fp32 computations of the same
sums in different orders.
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
from bigdl_tpu_torch.nn.attention import scaled_dot_product_attention
from bigdl_tpu_torch.utils.convert import params_from_jax

ATOL = RTOL = 1e-5
DH = 128


def _qkv(b, t, h, seed=0, tk=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, DH)).astype(np.float32)
    k, v = (rng.standard_normal((b, tk or t, h, DH)).astype(np.float32)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,h", [(128, 1), (256, 2)])
def test_flash_plain_version_matches_jax(t, h, causal):
    q, k, v = _qkv(2, t, h, seed=t + h)
    out = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=causal).numpy()
    ref = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    # the TPU kernel's own reference, in its (B, H, T, Dh) layout
    bhtd = [jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v)]
    pal = pallas_fa.mha_reference(*bhtd, None, causal=causal,
                                  sm_scale=1.0 / math.sqrt(DH))
    np.testing.assert_allclose(out, np.asarray(pal).transpose(0, 2, 1, 3),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [True, False])
def test_standard_path_matches_jax_for_unequal_lengths(causal):
    """Bottom-right causal alignment when Tq != Tkv, as in the JAX package."""
    q, k, v = _qkv(2, 64, 2, seed=3, tk=128)
    out = scaled_dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal).numpy()
    ref = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,n_head", [(128, 1), (256, 2)])
def test_mha_matches_jax_with_weights_carried_over(t, n_head, causal):
    d = n_head * DH
    jm = JaxMHA(d, n_head, causal=causal)
    jm.reset(jax.random.PRNGKey(t + n_head))
    jparams = jax.tree_util.tree_map(np.asarray, jm.params)
    x = np.random.default_rng(1).standard_normal((2, t, d)).astype(np.float32)
    ref, _ = jm.apply(jm.params, jnp.asarray(x), jm.state)
    for flash in (True, False):
        pm = MultiHeadAttention(d, n_head, causal=causal, flash=flash,
                                device="cpu")
        params_from_jax(jparams, pm)
        with torch.no_grad():
            out = pm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("hidden,n_head,tq,tk", [
    (128, 1, 100, 100),    # T not divisible by 128
    (128, 2, 128, 128),    # head_dim 64
    (128, 1, 128, 256),    # cross-attention with Tq != Tkv
])
def test_flash_constraints_raise_like_jax(hidden, n_head, tq, tk):
    rng = np.random.default_rng(2)
    xq = rng.standard_normal((1, tq, hidden)).astype(np.float32)
    xk = rng.standard_normal((1, tk, hidden)).astype(np.float32)
    msg = "equal q/kv sequence lengths divisible by 128"
    jm = JaxMHA(hidden, n_head, flash=True)
    jm.reset(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match=msg):
        jm.apply(jm.params, [jnp.asarray(xq), jnp.asarray(xk)], jm.state)
    pm = MultiHeadAttention(hidden, n_head, flash=True, device="cpu")
    with pytest.raises(ValueError, match=msg):
        pm([torch.from_numpy(xq), torch.from_numpy(xk)])


def test_flash_and_chunk_are_exclusive_and_chunk_is_not_ported():
    """``flash`` with ``chunk`` raises, as in the JAX package.  ``chunk``
    alone is ported now: the layer gives the standard path's result
    (``tests/test_torch_port_moe.py`` holds it against the JAX
    package's)."""
    with pytest.raises(ValueError, match="pick one"):
        MultiHeadAttention(128, 1, flash=True, chunk=64, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 128, 128)).astype(np.float32))
    plain = MultiHeadAttention(128, 1, causal=True, device="cpu")
    chunked = MultiHeadAttention(128, 1, causal=True, chunk=64, device="cpu")
    chunked.load_state_dict(plain.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(chunked(x), plain(x), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("case", ["dtype", "head_dim", "seq_len", "shapes",
                                  "grad"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 128, 1))
    if case == "dtype":
        q, k, v = (x.half() for x in (q, k, v))
        err = TypeError
    elif case == "head_dim":
        q, k, v = (x[..., :64] for x in (q, k, v))
        err = ValueError
    elif case == "seq_len":
        q, k, v = (x[:, :96] for x in (q, k, v))
        err = ValueError
    elif case == "shapes":
        k = k[:, :64]
        err = ValueError
    else:   # the backward kernels have no backward: a second derivative
        q.requires_grad_(True)
        g = torch.ones(q.shape, requires_grad=True)
        (dq,) = torch.autograd.grad(fa.flash_attention(q, k, v), q, g,
                                    create_graph=True)
        with pytest.raises(RuntimeError, match="differentiate twice"):
            dq.sum().backward()
        return
    with pytest.raises(err):
        fa.flash_attention(q, k, v)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = dict(fa.launches)
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 128, 1))
    out = fa.flash_attention(q, k, v, causal=True)
    ref = fa.flash_attention_reference(q, k, v, True, 1.0 / math.sqrt(DH))
    assert torch.equal(out, ref)
    assert fa.launches == before
