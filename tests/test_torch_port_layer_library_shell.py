"""The stochastic layers, the initialisers and the imperative shell of the
port's layer library, held against the JAX package.

Split from ``test_torch_port_layer_library.py``,
whose docstring states what is held against the JAX package and with which
tolerances; the helpers and fixtures come from there.  No test file of the
port holds more than 25 tests: pytest-xdist's ``loadfile`` scheduler hands
out the largest files first (ROADMAP.md, standing rules).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu_torch.nn.module import random_stream
from bigdl_tpu_torch.utils.convert import (params_from_jax, params_to_jax,
                                           state_to_jax)

from test_torch_port_layer_library import (_nll_target, _shell_models,
                                           jax_apply, jax_params, normal,
                                           STOCHASTIC, to_torch)


@pytest.mark.parametrize("name,args", STOCHASTIC,
                         ids=[s[0] for s in STOCHASTIC])
def test_stochastic_eval_mode_is_exact(name, args):
    x = normal(4, 6)
    jm, pm = getattr(jnn, name)(*args), getattr(pnn, name)(*args)
    out_j, _, xg_j = jax_apply(jm, {}, x, np.ones_like(x), training=False)
    pm.evaluate()
    g = torch.Generator().manual_seed(0)
    with random_stream(pm, g):
        xt = to_torch(x)
        out = pm(xt)
        (xg,) = torch.autograd.grad(out, xt, torch.ones_like(out))
    np.testing.assert_array_equal(out.detach().numpy(), out_j)
    np.testing.assert_array_equal(xg.numpy(), xg_j)


@pytest.mark.parametrize("name,args", STOCHASTIC,
                         ids=[s[0] for s in STOCHASTIC])
def test_stochastic_training_moments_and_replay(name, args):
    """The noise of one training-mode forward over 200000 entries has its
    mean and variance within 1% (relative, or 3e-3 absolute for a mean of
    0), and the shell's backward uses the forward's draw: the input's
    gradient is what the drawn noise gives."""
    n = 200_000
    x = torch.full((n,), -2.0) if name == "RReLU" else torch.ones(n)
    pm = getattr(pnn, name)(*args)
    out = pm.update_output(x)
    if name == "RReLU":
        noise, mean, var = out / x, 0.25, 0.3 ** 2 / 12
    elif name == "GaussianDropout":
        noise, mean, var = out / x, 1.0, 0.3 / 0.7
    elif name == "GaussianNoise":
        noise, mean, var = out - x, 0.0, 0.25
    else:
        noise, mean, var = out / x, 1.0, 0.4 / 0.6
    assert abs(noise.mean().item() - mean) <= max(0.01 * mean, 3e-3)
    assert abs(noise.var().item() - var) <= 0.01 * var
    if name == "RReLU":
        assert noise.min() >= 0.1 and noise.max() <= 0.4
    g = torch.randn(n, generator=torch.Generator().manual_seed(1))
    gin = pm.backward(x, g)
    expect = g if name == "GaussianNoise" else g * noise
    torch.testing.assert_close(gin, expect, rtol=1e-6, atol=0)
    # a second forward draws anew
    assert not torch.equal(pm.update_output(x), out)


def test_initialisers():
    shape = (3, 4, 5, 5)
    np.testing.assert_array_equal(pnn.Ones()(shape).numpy(),
                                  jnn.Ones()(None, shape))
    np.testing.assert_array_equal(pnn.ConstInitMethod(0.3)(shape).numpy(),
                                  jnn.ConstInitMethod(0.3)(None, shape))
    # the port's (out, in, kh, kw) layout of the JAX package's HWIO
    for k in ((4, 4), (3, 5)):
        p = pnn.BilinearFiller()((2, 3) + k).numpy()
        j = np.asarray(jnn.BilinearFiller()(None, k + (3, 2)))
        np.testing.assert_array_equal(p, np.transpose(j, (3, 2, 0, 1)))
    g = torch.Generator().manual_seed(0)
    for fan_in, fan_out, var_fan_in in ((100, 50, True), (100, 50, False)):
        w = pnn.MsraFiller(var_fan_in)((400, 500), fan_in, fan_out,
                                       generator=g)
        std = (2.0 / (fan_in if var_fan_in else fan_out)) ** 0.5
        assert abs(w.std().item() - std) <= 0.01 * std
        assert abs(w.mean().item()) <= 0.01 * std


def test_shell_trains_like_the_jax_shell():
    jm, pm = _shell_models()
    jc, pc = jnn.ClassNLLCriterion(), pnn.ClassNLLCriterion()
    lr = 0.1
    for step in range(3):
        x = normal(5, 6, seed=step)
        y = _nll_target(5, 4, seed=step)
        for m, c, xs, ys in ((jm, jc, jnp.asarray(x), jnp.asarray(y)),
                             (pm, pc, torch.from_numpy(x),
                              torch.from_numpy(y))):
            m.zero_grad_parameters()
            out = m.update_output(xs) if m is pm else m.forward(xs)
            c.forward(out, ys)
            m.backward(xs, c.backward(out, ys))
            m.update_parameters(lr)
    wj, gj = jm.get_parameters()
    wp, gp = pm.get_parameters()
    assert wp.shape == (pm.n_parameters(),) == (jm.n_parameters(),)
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gp.numpy(), np.asarray(gj), rtol=0, atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(state_to_jax(pm)),
                    jax.tree_util.tree_leaves(jm.state), strict=True):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)


def test_get_parameters_is_the_jax_flat_order():
    """Same weights in both packages give the same flat vector, entry for
    entry (a layer's entries by sorted name, ``Linear`` (in, out));
    ``set_flat_parameters`` is its inverse."""
    jm, pm = _shell_models()
    wj, _ = jm.get_parameters()
    wp, gp = pm.get_parameters()
    np.testing.assert_array_equal(wp.numpy(), np.asarray(wj))
    assert not gp.any()
    pm.set_flat_parameters(2 * wp)
    np.testing.assert_array_equal(pm.get_parameters()[0].numpy(),
                                  2 * np.asarray(wj))
    tree = params_to_jax(pm)
    np.testing.assert_array_equal(tree[0]["weight"],
                                  2 * np.asarray(jm.params[0]["weight"]))


def test_update_grad_input_and_acc_grad_parameters():
    jm, pm = _shell_models()
    x, y = normal(5, 6), _nll_target(5, 4)
    pm.zero_grad_parameters()
    jm.zero_grad_parameters()
    out = pm.update_output(torch.from_numpy(x))
    jout = jm.forward(jnp.asarray(x))
    g = pnn.ClassNLLCriterion().backward(out, torch.from_numpy(y))
    jg = jnn.ClassNLLCriterion().backward(jout, jnp.asarray(y))
    stats = [b.clone() for b in pm.buffers()]
    gin = pm.update_grad_input(torch.from_numpy(x), g)
    np.testing.assert_allclose(gin.numpy(), np.asarray(
        jm.update_grad_input(jnp.asarray(x), jg)), rtol=0, atol=1e-6)
    assert not pm.get_parameters()[1].any()
    for b, kept in zip(pm.buffers(), stats):   # no second statistics update
        assert torch.equal(b, kept)
    pm.acc_grad_parameters(torch.from_numpy(x), g)
    once = pm.get_parameters()[1].clone()
    jm.acc_grad_parameters(jnp.asarray(x), jg)
    np.testing.assert_allclose(once.numpy(), np.asarray(jm.get_parameters()[1]),
                               rtol=0, atol=1e-6)
    pm.acc_grad_parameters(torch.from_numpy(x), g)
    torch.testing.assert_close(pm.get_parameters()[1], 2 * once, rtol=0,
                               atol=0)


def test_scale_w_and_scale_b():
    jl, pl = jnn.Linear(4, 3), pnn.Linear(4, 3)
    params = jax_params(jl, 0)
    params_from_jax(params, pl)
    jl._params = jax.tree_util.tree_map(jnp.asarray, params)
    jl._state, jl._grads = {}, jax.tree_util.tree_map(jnp.zeros_like,
                                                      jl._params)
    x, g = normal(2, 4), normal(2, 3, seed=1)
    pl.zero_grad_parameters()
    pl.backward(torch.from_numpy(x), torch.from_numpy(g))
    plain = pl.get_parameters()[1].clone()
    for m in (jl, pl):
        m.scale_w, m.scale_b = 2.0, 3.0
        m.zero_grad_parameters()
    jl.backward(jnp.asarray(x), jnp.asarray(g))
    pl.backward(torch.from_numpy(x), torch.from_numpy(g))
    scaled = pl.get_parameters()[1]
    np.testing.assert_allclose(scaled.numpy(),
                               np.asarray(jl.get_parameters()[1]),
                               rtol=1e-6, atol=1e-7)
    # flat order: bias (3) then weight (12)
    torch.testing.assert_close(scaled[:3], 3 * plain[:3], rtol=0, atol=0)
    torch.testing.assert_close(scaled[3:], 2 * plain[3:], rtol=0, atol=0)


def test_shell_bookkeeping():
    _, pm = _shell_models()
    x = torch.from_numpy(normal(5, 6))
    out = pm.update_output(x)
    assert pm.output is out
    pm.backward(x, torch.ones_like(out))
    times = pm.get_times()
    assert times[0][0] is pm and times[0][1] > 0 and times[0][2] > 0
    pm.reset_times()
    assert all(f == 0 and b == 0 for _, f, b in pm.get_times())
    clone = pm.clone_module()
    torch.testing.assert_close(clone.get_parameters()[0],
                               pm.get_parameters()[0], rtol=0, atol=0)
    assert clone.layers[0].weight is not pm.layers[0].weight
    table = pm.get_parameters_table()
    assert sorted(table) == ["layers.0", "layers.1", "layers.2", "layers.4"]
    params, grads = pm.params_and_grads()
    assert len(params) == len(grads) == len(list(pm.parameters()))
