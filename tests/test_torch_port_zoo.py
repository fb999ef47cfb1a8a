"""The rest of the port's convnet zoo (AlexNet, VGG, Inception) and the
layers it brings, held against the JAX package's on the CPU.

Each model or layer is built in both packages.  The JAX parameter and state
trees are filled from a numpy seed (shapes from ``jax.eval_shape``: drawing
its own initial weights, a JAX Inception-v1 takes about 24 s on the CPU) and
carried into the port with ``params_from_jax``/``state_from_jax``; the JAX
forward takes the trees directly and is jitted (an eager Inception-v1
forward dispatches op by op for about 9 s).  Inputs come from numpy seeds.

Tolerances, each stated beside its case:
- fp32 layers: atol 1e-5 (the same sums in other orders);
- LRN in bf16: 2e-2 of the largest |output| (each package rounds its bf16
  intermediates at its own places; bf16 keeps 8 significant bits);
- whole models, eval forward at B1, 224 x 224 (227 for the grouped
  ``alexnet``): log-probs within atol 1e-4;
- training-mode forward and gradients (an Inception-v1 block,
  ``vgg_for_cifar10`` with every ``Dropout`` at p = 0 in both packages):
  fp32 outputs atol 1e-4; the port's float64 gradient within 5e-4 of the
  largest entry of the JAX package's fp32 gradient (see ``grads_close``:
  the port's fp32 CPU gradient depends on the thread count);
- a 3-step trajectory of ``vgg_for_cifar10`` through
  ``Optimizer.create(...).optimize()``, the port in float64 against the
  JAX package in fp32 at B8 (see the test for why): losses within 1e-4
  relative (the first 1e-5), trained weights and running statistics
  within 1e-4 in root mean square per tensor and 1e-3 in their largest
  entry.

``Dropout``'s masks cannot match the JAX package's (threefry bits against
torch's generator), so its training-mode cases check what the mask must be:
the identity in eval mode, at p = 0 and without a random stream; a kept
fraction within binomial bounds, the kept elements scaled by 1/(1 - p), the
gradient masked like the output; each step's masks drawn from a generator
seeded with the step's counter; the same weights from the same seed, run
after run.  VGG-16/19 (138M parameters, most in fc6) are compared by
parameter-tree shape only; their values are checked on the card.
``models/perf.py``: its model table against the JAX package's, the
training protocol on the CPU, ``--partitions 2`` raising, and the
per-layer report's rows and FLOPs.
"""

import contextlib
import copy
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.models as jmodels
import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset import LocalDataSet as JaxLocalDataSet
from bigdl_tpu.dataset import SampleToMiniBatch as JaxSampleToMiniBatch
from bigdl_tpu.dataset.sample import Sample as JaxSample
from bigdl_tpu.models.inception import inception_layer_v1 as jax_block_v1
from bigdl_tpu.utils.random_generator import \
    RandomGenerator as JaxRandomGenerator
import bigdl_tpu_torch.models as pmodels
import bigdl_tpu_torch.nn as pnn
import bigdl_tpu_torch.optim as poptim
from bigdl_tpu_torch.dataset import LocalDataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.models import perf
from bigdl_tpu_torch.models.inception import inception_layer_v1
from bigdl_tpu_torch.utils.convert import (params_from_jax, params_to_jax,
                                           state_from_jax, state_to_jax)
from bigdl_tpu_torch.utils.random_generator import RandomGenerator

ATOL = 1e-5


def numpy_trees(jm, seed):
    """``jm``'s parameter and state trees from a numpy seed, in float32,
    each uniform (a cheaper draw than a normal one at AlexNet's 61M
    parameters) with the spread of the usual init: 4-D conv kernels at
    He's variance 2/fan_in, 2-D weights 1/fan_in, biases and running
    means 0.01; BN weights and running variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        key = path[-1].key
        if key in ("weight", "running_var") and len(s.shape) == 1:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if len(s.shape) == 4:
            var = 2 / np.prod(s.shape[:3])
        elif len(s.shape) == 2:
            var = 1 / s.shape[0]
        else:
            var = 0.01
        half = np.float32(np.sqrt(3 * var))      # U(-a, a) has var a^2/3
        return (rng.random(s.shape, dtype=np.float32) * 2 - 1) * half

    params = jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(jm._init_params, jax.random.PRNGKey(0)))
    state = jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(jm._init_state))
    return params, state


def pair(jm, pm, seed=0, install=False):
    """The JAX model's trees from ``seed``, carried into the port model;
    with ``install``, also given to the JAX model, which then draws none
    of its own (its trainer reads them there)."""
    params, state = numpy_trees(jm, seed)
    if install:
        jm._params = jax.tree_util.tree_map(jnp.asarray, params)
        jm._state = jax.tree_util.tree_map(jnp.asarray, state)
        jm._grads = jax.tree_util.tree_map(jnp.zeros_like, jm._params)
        jm._adopt()
    params_from_jax(params, pm)
    state_from_jax(state, pm)
    return params, state


def jax_forward(jm, params, state, x, training=False):
    out, new_state = jax.jit(lambda p, s, x: jm.apply(
        p, x, s, training=training))(params, state, jnp.asarray(x))
    return np.asarray(out), new_state


def images(n, shape, classes, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n,) + shape).astype(np.float32)
    y = rng.integers(1, classes + 1, n).astype(np.float32)
    return x, y


def set_dropout(model, p, cls):
    for m in model.modules():
        if isinstance(m, cls):
            m.set_p(p)


# ------------------------------------------------------------ the layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("size", [5, 4])
def test_lrn_matches_jax(size, fmt, dtype):
    """Size 4 pads the channel window (1, 2), which torch's
    ``local_response_norm`` would pad (2, 1)."""
    jm = jnn.SpatialCrossMapLRN(size, 0.5, 0.75, 2.0, format=fmt)
    pm = pnn.SpatialCrossMapLRN(size, 0.5, 0.75, 2.0, format=fmt)
    x = np.random.default_rng(1).standard_normal((2, 7, 5, 6)).astype(
        np.float32) * 3
    jx = jnp.asarray(x if fmt == "NCHW" else x.transpose(0, 2, 3, 1),
                     dtype=dtype)
    ref = np.asarray(jax.jit(lambda x: jm.apply({}, x, {})[0])(jx).astype(
        jnp.float32))
    if fmt == "NHWC":
        ref = ref.transpose(0, 3, 1, 2)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    if fmt == "NHWC":
        t = t.contiguous(memory_format=torch.channels_last)
    out = pm(t)
    assert out.dtype == t.dtype
    assert out.is_contiguous(memory_format=torch.channels_last) == \
        (fmt == "NHWC")
    tol = ATOL if dtype == "float32" else 2e-2 * np.abs(ref).max()
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol)
    if dtype == "float32":   # torch's own LRN agrees at odd sizes only
        torch_lrn = torch.nn.functional.local_response_norm(
            torch.from_numpy(x), size, 0.5, 0.75, 2.0).numpy()
        assert np.abs(torch_lrn - ref).max() > 1e-3 if size % 2 == 0 else \
            np.allclose(torch_lrn, ref, atol=ATOL)


def test_threshold_matches_jax():
    x = np.random.default_rng(2).standard_normal((3, 9)).astype(np.float32)
    x[0, :3] = [0.0, 1e-6, -1e-6]
    jm, pm = jnn.Threshold(1e-6, -0.5), pnn.Threshold(1e-6, -0.5)
    np.testing.assert_array_equal(pm(torch.from_numpy(x)).numpy(),
                                  np.asarray(jm.apply({}, jnp.asarray(x),
                                                      {})[0]))


def _dropout_out(p, x, training=True, stream=True, seed=0):
    m = pnn.Dropout(p).train(training)
    t = torch.from_numpy(x).requires_grad_(True)
    gen = torch.Generator().manual_seed(seed)
    with pnn.random_stream(m, gen) if stream else contextlib.nullcontext():
        out = m(t)
    return m, t, out


@pytest.mark.parametrize("case", ["eval", "p0", "no_stream"])
def test_dropout_identity_cases(case):
    """The JAX package's ``Dropout.apply`` returns its input when not
    training, at p <= 0 and with ``rng=None`` (``activation.py:318``)."""
    x = np.random.default_rng(3).standard_normal((4, 50)).astype(np.float32)
    p = 0.0 if case == "p0" else 0.5
    m, t, out = _dropout_out(p, x, training=case != "eval",
                             stream=case != "no_stream")
    assert out is t
    jm = jnn.Dropout(p)
    ref = jm.apply({}, jnp.asarray(x), {}, training=case != "eval",
                   rng=None if case == "no_stream" else
                   jax.random.PRNGKey(0))[0]
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    assert m.generator is None      # the stream is gone after the block


@pytest.mark.parametrize("p", [0.3, 0.5, 0.7])
def test_dropout_training_mask(p):
    """Kept fraction within 5 standard deviations of 1 - p over 40,000
    elements; kept elements are x / (1 - p), dropped ones 0; the
    gradient is masked and scaled like the output."""
    n = 40_000
    x = np.random.default_rng(4).uniform(0.5, 1.5, (8, n // 8)).astype(
        np.float32)
    _, t, out = _dropout_out(p, x, seed=5)
    kept = out.detach() != 0
    frac = kept.float().mean().item()
    assert abs(frac - (1 - p)) <= 5 * math.sqrt(p * (1 - p) / n)
    want = torch.from_numpy(x)[kept] / (1 - p)
    assert ((out.detach()[kept] - want).abs() <= 1e-6 * want).all()
    (grad,) = torch.autograd.grad(out.sum(), t)
    assert ((grad - kept.float() / (1 - p)).abs() <= 1e-6 / (1 - p)).all()
    # the same seed gives the same mask; another seed another one
    assert torch.equal(_dropout_out(p, x, seed=5)[2], out)
    assert not torch.equal(_dropout_out(p, x, seed=6)[2], out)


@pytest.mark.parametrize("kind", ["conv", "linear"])
def test_xavier_bound_matches_jax(kind):
    """The reference's bound sqrt(6 / (fan_in + fan_out)) with the JAX
    layer's fans (conv: in/groups * kh * kw and out/groups * kh * kw,
    ``conv.py:71``; Linear: in and out); the draw fills it uniformly and
    ``Zeros`` empties the bias."""
    if kind == "conv":
        fans = jnn.SpatialConvolution(48, 64, 5, 3, n_group=2)._fans
        pm = pnn.SpatialConvolution(48, 64, 5, 3, n_group=2, device="cpu")
        assert fans == (24 * 15, 32 * 15)
    else:
        fans = (300, 200)
        pm = pnn.Linear(300, 200, device="cpu")
    bound = math.sqrt(6 / sum(fans))
    pm.set_init_method(pnn.Xavier(), pnn.Zeros(),
                       generator=torch.Generator().manual_seed(1))
    w = pm.weight.detach()
    assert 0.99 * bound <= w.abs().max().item() <= bound
    assert abs(w.std().item() - bound / math.sqrt(3)) <= 0.02 * bound
    assert not pm.bias.detach().any()


POOLS = {   # Inception-v2's padded ceil-mode pools
    "max_3x3_s1_p1_ceil": (jnn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil,
                           lambda: pnn.SpatialMaxPooling(
                               3, 3, 1, 1, 1, 1).ceil()),
    "avg_3x3_s1_p1_ceil": (lambda: jnn.SpatialAveragePooling(
                               3, 3, 1, 1, 1, 1, ceil_mode=True),
                           lambda: pnn.SpatialAveragePooling(
                               3, 3, 1, 1, 1, 1, ceil_mode=True)),
    "avg_5x5_s3_ceil": (lambda: jnn.SpatialAveragePooling(
                            5, 5, 3, 3, ceil_mode=True),
                        lambda: pnn.SpatialAveragePooling(
                            5, 5, 3, 3, ceil_mode=True)),
}


@pytest.mark.parametrize("side", [28, 14, 7])
@pytest.mark.parametrize("name", sorted(POOLS))
def test_inception_v2_pools_match_jax(name, side):
    jm, pm = (f() for f in POOLS[name])
    x = np.random.default_rng(6).standard_normal((2, 3, side, side)).astype(
        np.float32)
    ref = np.asarray(jm.apply({}, jnp.asarray(x), {})[0])
    out = pm(torch.from_numpy(x).contiguous(
        memory_format=torch.channels_last)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL)


# -------------------------------------------------------- whole models

EVAL_MODELS = ["alexnet_owt", "alexnet", "inception_v1", "inception_v2"]


@pytest.mark.parametrize("name", EVAL_MODELS)
def test_eval_forward_matches_jax(name):
    """Eval mode, B1 at 224 x 224 (227 x 227 for the grouped ``alexnet``,
    whose unpadded conv1 needs it to reach fc6's 256 x 6 x 6, in both
    packages): the log-probabilities (Inception's [main, aux2, aux1]
    concat) within atol 1e-4."""
    jm = getattr(jmodels, name)()
    pm = getattr(pmodels, name)(device="cpu")
    params, state = pair(jm, pm, seed=7)
    side = 227 if name == "alexnet" else 224
    x = images(1, (3, side, side), 1000, seed=8)[0]
    ref, _ = jax_forward(jm, params, state, x)
    # every spatial layer (conv, pool, LRN, BN), towers included, is
    # handed channels-last memory by the layout pass
    spatial = [m for m in pm.modules()
               if getattr(m, "layout_role", None) == "spatial"]
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(
        a[0].is_contiguous(memory_format=torch.channels_last)))
        for m in spatial]
    with torch.no_grad():
        out = pm.eval()(torch.from_numpy(x)).numpy()
    for h in hooks:
        h.remove()
    assert len(seen) == len(spatial) and all(seen)
    assert all(m.format == "NHWC" for m in spatial)
    heads = 3 if name.startswith("inception") else 1
    assert out.shape == ref.shape == (1, 1000 * heads)
    assert np.isfinite(ref).all() and np.abs(ref).max() < 1e3
    np.testing.assert_allclose(out, ref, atol=1e-4)


def port_shapes(module):
    """The port model's parameter tree as shapes in the JAX package's
    layout (Linear (in, out), convolutions HWIO)."""
    if isinstance(module, pnn.Container):
        return [port_shapes(c) for c in module.layers]
    out = {}
    for key, t in module.named_parameters(recurse=False):
        shape = tuple(t.shape)
        if key == "weight" and isinstance(module, pnn.Linear):
            shape = shape[::-1]
        elif key == "weight" and isinstance(module, pnn.SpatialConvolution):
            shape = shape[2:] + shape[1::-1]
        out[key] = shape
    return out


@pytest.mark.parametrize("name", ["vgg16", "vgg19"])
def test_vgg_imagenet_parameter_shapes(name):
    """Built on the meta device (no storage); the tree of shapes against
    the JAX model's ``eval_shape``."""
    shapes = jax.eval_shape(getattr(jmodels, name)()._init_params,
                            jax.random.PRNGKey(0))
    pm = getattr(pmodels, name)(device="meta")
    assert port_shapes(pm) == jax.tree_util.tree_map(lambda s: s.shape,
                                                     shapes)
    assert sum(p.numel() for p in pm.parameters()) == {
        "vgg16": 138_357_544, "vgg19": 143_667_240}[name]


# ------------------------------------------------ training-mode parity

def float64_grads(pm, x, loss_of):
    """The port's gradients of ``loss_of(output)`` in float64, from a
    float64 copy of ``pm`` (training mode) fed ``x``."""
    m = copy.deepcopy(pm).double().train()
    loss = loss_of(m(torch.from_numpy(x).double()))
    return torch.autograd.grad(loss, list(m.parameters()))


def grads_close(port_grads, jax_tree, pm, rtol=5e-4):
    """Each port gradient within ``rtol`` of the largest entry of the JAX
    gradient, which is carried into the port's layout by the converter.

    The port's side is its float64 gradient: its fp32 CPU path in
    channels-last memory depends on the CPU thread count (measured
    on ``vgg_for_cifar10`` at B4: 6.7e-5 of a tensor's norm from float64
    with 8 threads, 4.6e-3 with 1 or 2, where its NCHW path stays at
    3.9e-5), while the JAX package's fp32 gradient is 7.4e-5 of a
    tensor's norm and 5.7e-5 of the largest entry from it."""
    carrier = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_tree),
                              copy.deepcopy(pm))
    ref = [p.detach().double() for p in carrier.parameters()]
    top = max(r.abs().max().item() for r in ref)
    assert top > 0 and len(ref) == len(port_grads)
    for g, r in zip(port_grads, ref):
        assert (g - r).abs().max().item() <= rtol * top


def test_inception_v1_block_training_matches_jax():
    """inception_3a (192 channels in, 256 out) on a 2 x 192 x 14 x 14
    channels-last batch: the training-mode output and the gradients of
    sum(out * r)."""
    cfg = ((64,), (96, 128), (16, 32), (32,))
    jm = jnn.apply_layout(jnn.Sequential().add(jax_block_v1(192, cfg)),
                          "NHWC")
    pm = pnn.apply_layout(pnn.Sequential().add(inception_layer_v1(
        192, cfg, device="cpu")), "NHWC")
    params, state = pair(jm, pm, seed=9)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 192, 14, 14)).astype(np.float32)
    r = rng.standard_normal((2, 256, 14, 14)).astype(np.float32)

    def loss(p):
        out, _ = jm.apply(p, jnp.asarray(x), state, training=True)
        return jnp.sum(out * r), out

    (_, ref), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    pm.train()
    out = pm(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-4)
    grads_close(float64_grads(pm, x, lambda o: (
        o * torch.from_numpy(r).double()).sum()), jgrad, pm)


@contextlib.contextmanager
def seeded(seed):
    """Both packages' thread-local RandomGenerator replaced by a fresh one
    seeded with ``seed``; the previous ones are put back after (the
    tier-1 run shares worker processes with the JAX tests)."""
    saved = [getattr(cls._tls, "inst", None)
             for cls in (JaxRandomGenerator, RandomGenerator)]
    JaxRandomGenerator._tls.inst = JaxRandomGenerator(seed)
    RandomGenerator._tls.inst = RandomGenerator(seed)
    try:
        yield
    finally:
        for cls, inst in zip((JaxRandomGenerator, RandomGenerator), saved):
            if inst is None:
                del cls._tls.inst
            else:
                cls._tls.inst = inst


class _Losses:
    """A train summary that keeps the JAX trainer's per-step losses."""

    def __init__(self):
        self.losses = []

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.losses.append(float(value))


def train(model, x, y, batch, package, steps=3, seed=11):
    """``steps`` of SGD(0.01, momentum 0.9) through
    ``Optimizer.create(...).optimize()``; returns the per-step losses."""
    jax_side = package == "jax"
    nn, optim = (jnn, joptim) if jax_side else (pnn, poptim)
    sample, lds, s2b = ((JaxSample, JaxLocalDataSet, JaxSampleToMiniBatch)
                        if jax_side else
                        (Sample, LocalDataSet, SampleToMiniBatch))
    ds = lds([sample(x[i], y[i]) for i in range(len(x))]).transform(
        s2b(batch))
    kw = {} if jax_side else {"device": "cpu"}
    opt = optim.Optimizer.create(model, ds, nn.ClassNLLCriterion(), **kw)
    opt.set_optim_method(optim.SGD(learning_rate=0.01, momentum=0.9))
    opt.set_end_when(optim.max_iteration(steps))
    summary = _Losses()
    if jax_side:
        opt.set_train_summary(summary)
    with seeded(seed):
        opt.optimize()
    return summary.losses if jax_side else [h["loss"] for h in opt.history]


def assert_trees_close(port_tree, jax_tree, rms=1e-4, largest=1e-3):
    pl, jl = (jax.tree_util.tree_leaves(t) for t in (port_tree, jax_tree))
    assert len(pl) == len(jl) and pl
    for p, j in zip(pl, jl):
        d = np.abs(p - np.asarray(j))
        assert np.sqrt(np.mean(d ** 2)) <= rms and d.max() <= largest, \
            (p.shape, np.sqrt(np.mean(d ** 2)), d.max())


@pytest.fixture(scope="module")
def cifar_vgg():
    """``vgg_for_cifar10`` in both packages with the same trees and every
    Dropout at p = 0; the port's copy is fresh for each use."""
    jm = jmodels.vgg_for_cifar10()
    pm = pmodels.vgg_for_cifar10(device="cpu")
    set_dropout(jm, 0.0, jnn.Dropout)
    set_dropout(pm, 0.0, pnn.Dropout)
    params, state = pair(jm, pm, seed=12, install=True)
    assert pm.is_stochastic() and isinstance(pm.layers[0], pnn.NCHWToNHWC)
    return jm, pm, params, state


def test_vgg_for_cifar10_training_forward_and_gradients(cifar_vgg):
    """B4 at 32 x 32, training mode (batch statistics): log-probs, the
    loss's gradients and the running statistics the forward wrote."""
    jm, pm, params, state = cifar_vgg
    pm = copy.deepcopy(pm).train()
    x, y = images(4, (3, 32, 32), 10, seed=13)

    def loss(p):
        out, new_state = jm.apply(p, jnp.asarray(x), state, training=True,
                                  rng=jax.random.PRNGKey(0))
        return jnn.ClassNLLCriterion().apply(out, jnp.asarray(y)), (
            out, new_state)

    (ref_loss, (ref, ref_state)), jgrad = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    out = pm(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-4)
    crit = pnn.ClassNLLCriterion()
    np.testing.assert_allclose(crit.apply(out, torch.from_numpy(y)).item(),
                               float(ref_loss), rtol=1e-5)
    assert_trees_close(state_to_jax(pm), ref_state, rms=1e-5, largest=1e-5)
    grads_close(float64_grads(pm, x, lambda o: crit.apply(
        o, torch.from_numpy(y))), jgrad, pm)


def test_vgg_for_cifar10_trajectory_matches_jax(cifar_vgg):
    """3 steps of SGD(0.01, momentum 0.9) at B8 over 2 batches (the third
    step starts a second epoch): the port's LocalOptimizer on a float64
    copy of the model and data against the JAX package's in fp32.

    Why float64 and B8: the port's fp32 CPU path depends on the thread
    count (see ``grads_close``), and at lr 0.01 that moved the port's own
    fp32 third loss by up to 4e-3 between runs with 1, 2 and 8 threads.
    At B4 the trajectory is ill-conditioned even in float64 (a 1e-7
    relative perturbation of the weights moves the third loss by 1.9e-3;
    at B8, 1.6e-5), so the JAX package's fp32 run is itself 2e-3 away.
    At B8 the JAX fp32 run was within 1.4e-5 (losses), 1.2e-4 (weights)
    and 6.2e-5 (statistics) of the port's float64 run.  Gates: the first
    loss 1e-5, all losses 1e-4 relative; weights and statistics
    ``assert_trees_close``'s 1e-4 (RMS) and 1e-3 (largest entry), as in
    ``tests/test_torch_port_resnet.py``."""
    jm, pm, params, _ = cifar_vgg
    pm = copy.deepcopy(pm).double()
    x, y = images(16, (3, 32, 32), 10, seed=14)
    ref_losses = train(jm, x, y, 8, "jax")
    losses = train(pm, x.astype(np.float64), y, 8, "port")
    assert len(losses) == len(ref_losses) == 3
    np.testing.assert_allclose(losses[0], ref_losses[0], rtol=1e-5)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    trained = params_to_jax(pm)
    assert_trees_close(trained, jm.params)
    assert_trees_close(state_to_jax(pm), jm.state)
    assert max(np.abs(a - b).max() for a, b in zip(
        jax.tree_util.tree_leaves(trained),
        jax.tree_util.tree_leaves(params))) > 1e-3


def test_optimizer_seeds_each_step_with_its_counter():
    """The trainer draws iteration i's masks from a generator seeded with
    i - 1 (the JAX package's ``PRNGKey(rng_counter)``), including across
    a second ``optimize()``, and leaves no stream behind."""
    x, y = images(4, (30,), 3, seed=19)
    g = torch.Generator().manual_seed(20)
    drop = pnn.Dropout(0.4)
    m = (pnn.Sequential().add(drop)
         .add(pnn.Linear(30, 3, device="cpu", generator=g))
         .add(pnn.LogSoftMax()))
    seen = []
    drop.register_forward_hook(lambda mod, a, out: seen.append(
        (a[0].detach().clone(), out.detach().clone())))
    ds = LocalDataSet([Sample(x[i], y[i]) for i in range(4)]).transform(
        SampleToMiniBatch(4))
    opt = poptim.Optimizer.create(m, ds, pnn.ClassNLLCriterion(),
                                  device="cpu")
    for steps in (2, 3):
        opt.set_end_when(poptim.max_iteration(steps))
        with seeded(21):
            opt.optimize()
    assert len(seen) == 3 and drop.generator is None
    for counter, (inp, out) in enumerate(seen):
        mask = torch.empty_like(inp).bernoulli_(
            0.6, generator=torch.Generator().manual_seed(counter))
        assert torch.equal(out, inp * mask / 0.6)


def test_dropout_training_is_reproducible():
    """Two runs of 3 steps from one seed with Dropout(0.5) active give
    bit-identical weights; the same run at p = 0 does not."""
    x, y = images(8, (20,), 4, seed=15)

    def run(p):
        g = torch.Generator().manual_seed(16)
        m = (pnn.Sequential()
             .add(pnn.Linear(20, 64, device="cpu", generator=g))
             .add(pnn.ReLU()).add(pnn.Dropout(p))
             .add(pnn.Linear(64, 4, device="cpu", generator=g))
             .add(pnn.LogSoftMax()))
        train(m, x, y, 4, "port")
        return [t.detach().clone() for t in m.parameters()]

    first, again, no_drop = run(0.5), run(0.5), run(0.0)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert not all(torch.equal(a, b) for a, b in zip(first, no_drop))


# ------------------------------------------------------------ perf.py

def test_perf_harness_has_the_reference_table():
    from bigdl_tpu.models import perf as jax_perf
    assert sorted(perf._MODELS) == sorted(jax_perf._MODELS)
    for name, (_, shape, classes) in perf._MODELS.items():
        assert (shape, classes) == jax_perf._MODELS[name][1:]


def test_perf_partitions_raise():
    with pytest.raises(NotImplementedError, match="DistriOptimizer"):
        perf.main(["-m", "lenet5", "--partitions", "2"], device="cpu")


def test_perf_training_protocol_on_the_cpu(capsys):
    opt = perf.main(["-m", "lenet5", "-b", "4", "-i", "2"], device="cpu")
    assert [h["neval"] for h in opt.history] == [1, 2, 3, 4]
    assert all(math.isfinite(h["loss"]) for h in opt.history)
    assert "steady-state throughput" in capsys.readouterr().out


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_per_layer_report_counts_every_leaf(precision):
    """One row per leaf in execution order (the Inception block's towers
    one after another), FLOPs at 2 per multiply-add from the leaves'
    shapes, the output that of the model's own forward."""
    g = torch.Generator().manual_seed(17)
    model = pnn.apply_layout(
        pnn.Sequential().add(inception_layer_v1(
            8, ((4,), (4, 6), (2, 4), (2,)), device="cpu", generator=g))
        .add(pnn.View(16 * 5 * 5)).add(pnn.Linear(400, 3, generator=g))
        .add(pnn.LogSoftMax()), "NHWC")
    x = torch.from_numpy(images(2, (8, 5, 5), 3, seed=18)[0])
    rows = perf.per_layer_report(model, x, peak_tflops=1.0,
                                 file=io.StringIO(), precision=precision)
    leaves = [m for m in model.modules() if isinstance(m, pnn.Module) and
              not isinstance(m, pnn.Container)]
    assert [r["type"] for r in rows] == [type(m).__name__ for m in leaves]
    macs = 2 * 25 * (8 * 4 + 8 * 4 + 4 * 9 * 6 + 8 * 2 + 2 * 25 * 4 +
                     8 * 2) + 2 * 400 * 3
    assert math.isclose(sum(r["gflop"] for r in rows) * 1e9, 2 * macs)
    assert all(r["ms"] >= 0 and 0 <= r["time_share"] <= 1 for r in rows)
