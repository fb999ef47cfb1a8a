"""The port's convnet layers held against the JAX package's, on the CPU.

Each case builds a ``bigdl_tpu`` layer and its ``bigdl_tpu_torch`` twin,
fills the JAX parameter and state trees from a numpy seed, carries them into
the port with ``params_from_jax``/``state_from_jax``, and feeds both the
same numpy input: convolutions (groups, stride, explicit and SAME padding on
odd and even sizes, no bias, an unbatched map), max and average pooling
(floor and ceil, ``count_include_pad`` both ways, padded), BatchNorm (plain
and spatial, NCHW and channels-last, two training-mode calls with both
running statistics, then eval), the table and structural layers, conv + BN
folding and the converter's round trip.

Tolerance: fp32, atol 1e-5 (the same fp32 sums in other orders), except
where a case states its own.  A channels-last case feeds the JAX layer
(``format="NHWC"``) the NHWC-shaped transpose of the port's input, whose
shape stays NCHW and whose memory is channels-last.
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

ATOL = 1e-5


def numpy_trees(jm, seed):
    """``jm``'s parameter and state trees filled from a numpy seed (shapes
    from ``jax.eval_shape``, so no JAX random draw is compiled): 4-D conv
    kernels He-normal, 2-D weights N(0, 1/fan_in), BN weights U(0.5, 1.5),
    biases N(0, 0.1); running means N(0, 0.1), variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        key = path[-1].key
        if len(s.shape) == 4:
            w = rng.standard_normal(s.shape) * np.sqrt(
                2 / np.prod(s.shape[:3]))
        elif len(s.shape) == 2:
            w = rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
        elif key in ("weight", "running_var"):
            w = rng.uniform(0.5, 1.5, s.shape)
        else:
            w = 0.1 * rng.standard_normal(s.shape)
        return w.astype(np.float32)

    shapes = jax.eval_shape(jm._init_params, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(draw, shapes)
    state = jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(jm._init_state))
    return params, state


def pair(jm, pm, seed=0):
    """The JAX layer's trees from ``seed``, carried into the port layer."""
    params, state = numpy_trees(jm, seed)
    params_from_jax(params, pm)
    state_from_jax(state, pm)
    return params, state


def run_jax(jm, params, x, state, training=False):
    tree = jax.tree_util.tree_map(jnp.asarray, (params, state))
    out, new_state = jm.apply(tree[0], jnp.asarray(x), tree[1],
                              training=training)
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, new_state)


def run_port(pm, x, training=False, channels_last=False):
    pm.train(training)
    t = torch.from_numpy(x)
    if channels_last:
        t = t.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        return pm(t)


def nhwc(x):
    return np.ascontiguousarray(np.moveaxis(x, -3, -1))


def data(*shape, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


# ----------------------------------------------------------- convolution

CONV_CASES = {
    # name: (constructor args (in, out, kw, kh, dw, dh, pw, ph), kwargs,
    #        input shape)
    "groups_stride_pad": ((4, 6, 3, 3, 2, 2, 1, 1), dict(n_group=2),
                          (2, 4, 9, 9)),
    "rect_kernel": ((3, 5, 3, 1, 1, 2, 0, 1), {}, (2, 3, 7, 8)),
    # SAME pads (low, high): (1, 2) on 7 pixels, (0, 1) on 8, (0, 1) on 6
    "same_odd": ((3, 4, 4, 4, 2, 2, -1, -1), {}, (2, 3, 7, 7)),
    "same_even": ((3, 4, 3, 3, 2, 2, -1, -1), {}, (2, 3, 8, 8)),
    "same_stride1_even_kernel": ((3, 4, 2, 2, 1, 1, -1, -1), {},
                                 (2, 3, 6, 6)),
    "no_bias": ((3, 4, 3, 3, 1, 1, 1, 1), dict(with_bias=False),
                (2, 3, 6, 6)),
    "unbatched": ((3, 4, 3, 3, 1, 1, 1, 1), {}, (3, 6, 6)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_spatial_convolution_matches_jax(case):
    args, kw, shape = CONV_CASES[case]
    jm = jnn.SpatialConvolution(*args, **kw)
    pm = pnn.SpatialConvolution(*args, **kw)
    params, state = pair(jm, pm)
    x = data(*shape)
    ref, _ = run_jax(jm, params, x, state)
    out = run_port(pm, x)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_spatial_convolution_channels_last_matches_jax_nhwc():
    jm = jnn.SpatialConvolution(4, 6, 3, 3, 2, 2, -1, -1, format="NHWC")
    pm = pnn.SpatialConvolution(4, 6, 3, 3, 2, 2, -1, -1, format="NHWC")
    assert pm.weight.is_contiguous(memory_format=torch.channels_last)
    params, state = pair(jm, pm)
    x = data(2, 4, 10, 10)
    ref, _ = run_jax(jm, params, nhwc(x), state)
    out = run_port(pm, x, channels_last=True)
    assert out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(out.numpy()), ref, atol=ATOL)


# --------------------------------------------------------------- pooling

POOL_CASES = {
    # name: (layer builder taking its package's nn, input shape)
    "max_floor": (lambda nn: nn.SpatialMaxPooling(3, 3, 2, 2), (2, 3, 9, 9)),
    "max_ceil": (lambda nn: nn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
                 (2, 3, 8, 8)),
    "max_padded": (lambda nn: nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1),
                   (2, 3, 8, 8)),
    "max_padded_ceil": (lambda nn: nn.SpatialMaxPooling(
        3, 2, 2, 2, 1, 1).ceil(), (1, 2, 7, 6)),
    "max_pad_past_half_window": (lambda nn: nn.SpatialMaxPooling(
        3, 3, 2, 2, 2, 2), (1, 2, 6, 7)),
    "avg_floor": (lambda nn: nn.SpatialAveragePooling(3, 3, 2, 2),
                  (2, 3, 9, 9)),
    "avg_ceil_include_pad": (lambda nn: nn.SpatialAveragePooling(
        3, 3, 2, 2, ceil_mode=True), (2, 3, 8, 8)),
    "avg_ceil_exclude_pad": (lambda nn: nn.SpatialAveragePooling(
        3, 3, 2, 2, ceil_mode=True, count_include_pad=False), (2, 3, 8, 8)),
    "avg_padded_include_pad": (lambda nn: nn.SpatialAveragePooling(
        3, 3, 2, 2, 1, 1), (2, 3, 8, 8)),
    "avg_padded_exclude_pad": (lambda nn: nn.SpatialAveragePooling(
        3, 3, 2, 2, 1, 1, count_include_pad=False), (2, 3, 8, 8)),
    "avg_padded_ceil_exclude_pad": (lambda nn: nn.SpatialAveragePooling(
        3, 3, 2, 2, 1, 1, ceil_mode=True, count_include_pad=False),
        (1, 2, 8, 7)),
    "avg_global_no_divide": (lambda nn: nn.SpatialAveragePooling(
        1, 1, global_pooling=True, divide=False), (2, 3, 5, 4)),
    "avg_unbatched": (lambda nn: nn.SpatialAveragePooling(2, 2, 2, 2),
                      (3, 6, 6)),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooling_matches_jax(case):
    build, shape = POOL_CASES[case]
    jm, pm = build(jnn), build(pnn)
    x = data(*shape)
    ref, _ = run_jax(jm, {}, x, {})
    out = run_port(pm, x)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


# ------------------------------------------------------------ batch norm

BN_CASES = {
    # name: (JAX layer, port layer, input shape, channels-last)
    "plain": (lambda: jnn.BatchNormalization(5),
              lambda: pnn.BatchNormalization(5), (8, 5), False),
    "plain_no_affine": (lambda: jnn.BatchNormalization(5, affine=False),
                        lambda: pnn.BatchNormalization(5, affine=False),
                        (8, 5), False),
    "spatial_nchw": (lambda: jnn.SpatialBatchNormalization(4),
                     lambda: pnn.SpatialBatchNormalization(4),
                     (3, 4, 5, 6), False),
    "spatial_channels_last": (
        lambda: jnn.SpatialBatchNormalization(4, momentum=0.3,
                                              format="NHWC"),
        lambda: pnn.SpatialBatchNormalization(4, momentum=0.3,
                                              format="NHWC"),
        (3, 4, 5, 6), True),
}


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


# ---------------------------------------------- table and structural

def _branches(nn):
    return (nn.ConcatTable()
            .add(nn.Sequential().add(nn.MulConstant(2.0)).add(nn.Tanh()))
            .add(nn.Identity()))


STRUCT_CASES = {
    # name: (layer builder taking its package's nn, input shape)
    "concat_dim2": (lambda nn: nn.Concat(2).add(nn.Identity())
                    .add(nn.MulConstant(-3.0)), (2, 3, 4, 4)),
    "concat_last_dim": (lambda nn: nn.Concat(-1).add(nn.Tanh())
                        .add(nn.Identity()), (2, 3, 5)),
    "concat_table_cadd": (lambda nn: nn.Sequential().add(_branches(nn))
                          .add(nn.CAddTable()), (2, 3, 4)),
    "view_num_input_dims": (lambda nn: nn.View(12).set_num_input_dims(3),
                            (2, 3, 2, 2)),
    "view_infer": (lambda nn: nn.View(-1, 6), (2, 3, 4)),
    "reshape_batch": (lambda nn: nn.Reshape((4, 3)), (2, 3, 4)),
    "reshape_whole": (lambda nn: nn.Reshape((3, 8)), (2, 3, 4)),
    "tanh": (lambda nn: nn.Tanh(), (3, 7)),
}


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


# ------------------------------------------------------------- folding

def _conv_bn(nn, layout=None, **kw):
    m = (nn.Sequential()
         .add(nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1, **kw))
         .add(nn.SpatialBatchNormalization(8, **kw)).add(nn.ReLU())
         .add(nn.ConcatTable()
              .add(nn.Sequential()
                   .add(nn.SpatialConvolution(8, 4, 3, 3, 2, 2, -1, -1,
                                              with_bias=False, **kw))
                   .add(nn.SpatialBatchNormalization(4, **kw)))
              .add(nn.Sequential()
                   .add(nn.SpatialConvolution(8, 4, 1, 1, 2, 2, **kw))
                   .add(nn.SpatialBatchNormalization(4, affine=False,
                                                     **kw))))
         .add(nn.CAddTable()))
    return nn.apply_layout(m, layout) if layout else m


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


# ----------------------------------------------------------- converter

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
