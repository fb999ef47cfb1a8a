"""The layers the rest of the model zoo brings beside the recurrent stack
(``Select``, ``Transpose``, ``Sigmoid``, ``MSECriterion``, and
``TimeDistributedCriterion``'s flat path over ClassNLL, CrossEntropy and
MSE), held against the JAX package's on the CPU.  Inputs come from numpy
seeds.  Tolerances: exact for the structural layers (views of the same
values), atol 1e-7 for ``Sigmoid``, rtol 1e-6 for the criterions (the
same sums in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu_torch.nn as pnn

B, T = 3, 5


@pytest.mark.parametrize("dim,index", [(2, -1), (2, 1), (1, 2), (3, -2),
                                       (-1, 3)])
def test_select_matches_jax(dim, index):
    x = np.random.default_rng(14).normal(size=(3, 4, 5)).astype(np.float32)
    ref, _ = jnn.Select(dim, index).apply({}, jnp.asarray(x), {})
    out = pnn.Select(dim, index)(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("perms", [[(2, 3)], [(1, 2), (2, 3)],
                                   [(3, 1)], [(1, 3), (1, 2)],
                                   [(-1, 1)], [(0, -1)], [(-1, -2)],
                                   [(-2, 0)], [(0, -1), (1, 3)]])
def test_transpose_matches_jax(perms):
    x = np.random.default_rng(15).normal(size=(2, 3, 4)).astype(np.float32)
    ref, _ = jnn.Transpose(perms).apply({}, jnp.asarray(x), {})
    out = pnn.Transpose(perms)(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_negative_dims_count_from_the_end():
    """``Transpose`` shifts every dim down by one, as the JAX package's
    does: (-1, -2) swaps the second- and third-to-last dims.  ``Select``
    reads a negative dim from the end."""
    x = torch.arange(24.).reshape(2, 3, 4)
    assert torch.equal(pnn.Transpose([(-1, -2)])(x), x.transpose(0, 1))
    assert torch.equal(pnn.Select(-1, -1)(x), x[..., -1])


def test_sigmoid_matches_jax_and_serves_as_an_activation():
    """``Sigmoid`` against the JAX package's; as an LSTM's inner
    activation (a module where the default is ``torch.sigmoid``) it gives
    the same cell."""
    x = np.random.default_rng(16).normal(size=(4, 7)).astype(np.float32) * 4
    ref, _ = jnn.Sigmoid().apply({}, jnp.asarray(x), {})
    np.testing.assert_allclose(pnn.Sigmoid()(torch.from_numpy(x)).numpy(),
                               np.asarray(ref), atol=1e-7, rtol=0)
    plain = pnn.Recurrent().add(pnn.LSTM(4, 6))
    module = pnn.Recurrent().add(
        pnn.LSTM(4, 6, inner_activation=pnn.Sigmoid()))
    module.load_state_dict(plain.state_dict())
    xs = torch.from_numpy(np.random.default_rng(17).normal(
        size=(B, T, 4)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(module(xs), plain(xs), rtol=0, atol=0)


@pytest.mark.parametrize("size_average", [True, False])
def test_mse_matches_jax(size_average):
    rng = np.random.default_rng(18)
    x, y = (rng.normal(size=(4, 3, 5)).astype(np.float32) for _ in range(2))
    jc = jnn.MSECriterion()
    jc.size_average = size_average
    ref = jc.apply(jnp.asarray(x), jnp.asarray(y))
    got = pnn.MSECriterion(size_average).apply(torch.from_numpy(x),
                                               torch.from_numpy(y))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


def td_inputs(kind, seed=19):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, 6, 5)).astype(np.float32)
    if kind == "mse":
        return x, rng.normal(size=(4, 6, 5)).astype(np.float32)
    if kind == "nll":
        x = x - np.log(np.exp(x).sum(-1, keepdims=True))
    return x, rng.integers(1, 6, size=(4, 6)).astype(np.float32)


def criteria(kind, inner_avg):
    if kind == "nll":
        return (jnn.ClassNLLCriterion(size_average=inner_avg),
                pnn.ClassNLLCriterion(size_average=inner_avg))
    if kind == "ce":
        return (jnn.CrossEntropyCriterion(size_average=inner_avg),
                pnn.CrossEntropyCriterion(size_average=inner_avg))
    jc, pc = jnn.MSECriterion(), pnn.MSECriterion(inner_avg)
    jc.size_average = inner_avg
    return jc, pc
