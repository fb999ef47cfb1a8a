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
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu_torch.utils.convert import params_from_jax, state_from_jax

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


# ----------------------------------------------------------- converter
