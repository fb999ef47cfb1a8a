"""Batch normalisation, the structural layers, conv + BN folding and the
converter's layouts, held against the JAX package.

Split from ``test_torch_port_convnet_layers.py``,
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
from bigdl_tpu.nn.fuse import fold_conv_bn as jax_fold_conv_bn
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu_torch.nn.fuse import fold_conv_bn
from bigdl_tpu_torch.utils.convert import (params_from_jax, params_to_jax,
                                           state_from_jax, state_to_jax)

from test_torch_port_convnet_layers import (_conv_bn, ATOL, BN_CASES, data,
                                            nhwc, numpy_trees, pair, run_jax,
                                            run_port, STRUCT_CASES)


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_matches_jax(case):
    """Two training-mode calls (each output, then both running statistics
    after the two), then an eval-mode call on the running statistics."""
    make_jax, make_port, shape, cl = BN_CASES[case]
    jm, pm = make_jax(), make_port()
    params, state = pair(jm, pm)
    assert set(dict(pm.named_buffers())) == {"running_mean", "running_var"}
    assert all(not b.requires_grad for b in pm.buffers())
    fmt = nhwc if cl else (lambda a: a)
    for seed, training in ((1, True), (2, True), (3, False)):
        x = data(*shape, seed=seed)
        ref, state = run_jax(jm, params, fmt(x), state, training)
        out = run_port(pm, x, training, channels_last=cl)
        np.testing.assert_allclose(fmt(out.numpy()), ref, atol=ATOL)
        for key in ("running_mean", "running_var"):
            np.testing.assert_allclose(getattr(pm, key).numpy(), state[key],
                                       atol=ATOL)


def test_batch_norm_running_update_is_torch_convention():
    """(1 - m) * running + m * batch, the variance unbiased by n/(n-1)."""
    pm = pnn.SpatialBatchNormalization(3, momentum=0.25, device="cpu")
    x = torch.from_numpy(data(4, 3, 5, 5))
    pm.train()(x)
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=True)
    torch.testing.assert_close(pm.running_mean, 0.25 * mean, atol=ATOL,
                               rtol=0)
    torch.testing.assert_close(pm.running_var, 0.75 + 0.25 * var,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", sorted(STRUCT_CASES))
def test_table_and_structural_layers_match_jax(case):
    build, shape = STRUCT_CASES[case]
    jm, pm = build(jnn), build(pnn)
    params, state = numpy_trees(jm, 0)     # trees of empty dicts
    x = data(*shape)
    ref, _ = run_jax(jm, params, x, state)
    out = run_port(pm, x)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_concat_table_returns_a_list_and_view_reshapes_channels_last():
    x = torch.from_numpy(data(2, 3, 4, 4)).contiguous(
        memory_format=torch.channels_last)
    outs = pnn.ConcatTable().add(pnn.Identity()).add(pnn.Tanh())(x)
    assert isinstance(outs, list) and len(outs) == 2
    # channels-last memory is not contiguous in NCHW order: a view refuses
    with pytest.raises(RuntimeError):
        x.view(2, 48)
    flat = pnn.View(48).set_num_input_dims(3)(x)
    np.testing.assert_array_equal(flat.numpy(),
                                  x.contiguous().numpy().reshape(2, 48))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_fold_conv_bn_matches_the_unfolded_eval_forward(layout):
    jm = _conv_bn(jnn, layout)
    pm = _conv_bn(pnn, layout, device="cpu")
    params, state = pair(jm, pm)
    x = data(2, 3, 9, 9)
    ref, _ = run_jax(jm, params, x, state)
    unfolded = run_port(pm, x)
    folded = fold_conv_bn(pm)
    assert not any(isinstance(m, pnn.SpatialBatchNormalization)
                   for m in folded.modules())
    out = run_port(folded, x)
    np.testing.assert_allclose(unfolded.numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), unfolded.numpy(), atol=ATOL)
    # the JAX package's fold of the same weights gives the same model
    jm._params, jm._state = (jax.tree_util.tree_map(jnp.asarray, t)
                             for t in (params, state))
    jm._grads = jax.tree_util.tree_map(jnp.zeros_like, jm._params)
    jm._adopt()
    jf = jax_fold_conv_bn(jm.evaluate())
    np.testing.assert_allclose(out.numpy(), np.asarray(jf.forward(x)),
                               atol=ATOL)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_jax(folded)),
                    jax.tree_util.tree_leaves(jf.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL)


def test_converter_round_trip_keeps_the_conv_layout():
    jm = _conv_bn(jnn, "NHWC")
    pm = _conv_bn(pnn, "NHWC", device="cpu")
    params, state = pair(jm, pm)
    conv = pm.layers[1]
    assert isinstance(conv, pnn.SpatialConvolution)
    hwio = params[1]["weight"]
    assert hwio.shape == (3, 3, 3, 8) and conv.weight.shape == (8, 3, 3, 3)
    # (out, in, kh, kw)[o, i, y, x] is HWIO[y, x, i, o]
    np.testing.assert_array_equal(conv.weight.detach().numpy()[5, 1, 2, 0],
                                  hwio[2, 0, 1, 5])
    for got, want in ((params_to_jax(pm), params),
                      (state_to_jax(pm), state)):
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)


def test_converter_takes_an_nchw_jax_model_into_a_channels_last_port():
    jm = _conv_bn(jnn, "NCHW")
    pm = _conv_bn(pnn, "NHWC", device="cpu")
    assert isinstance(pm.layers[0], pnn.NCHWToNHWC)
    params, state = pair(jm, pm)
    x = data(2, 3, 9, 9)
    ref, _ = run_jax(jm, params, x, state)
    np.testing.assert_allclose(run_port(pm, x).numpy(), ref, atol=ATOL)
    with pytest.raises(ValueError, match="child state trees"):
        state_from_jax(state[:-1], pm)
    # a kernel in torch's layout is not an HWIO kernel
    torch_layout = [{**params[0], "weight": np.zeros((8, 3, 3, 3),
                                                     np.float32)}]
    with pytest.raises(ValueError, match="does not fit"):
        params_from_jax(torch_layout + params[1:], _conv_bn(pnn,
                                                            device="cpu"))
