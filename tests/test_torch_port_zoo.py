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
training protocol on the CPU, ``--partitions 2`` raising without two
ranks, and the per-layer report's rows and FLOPs.
"""

import contextlib
import copy
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
from bigdl_tpu.utils.random_generator import \
    RandomGenerator as JaxRandomGenerator
import bigdl_tpu_torch.models as pmodels
import bigdl_tpu_torch.nn as pnn
import bigdl_tpu_torch.optim as poptim
from bigdl_tpu_torch.dataset import LocalDataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.utils.convert import params_from_jax, state_from_jax
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


# -------------------------------------------------------- whole models

EVAL_MODELS = ["alexnet_owt", "alexnet", "inception_v1", "inception_v2"]


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
