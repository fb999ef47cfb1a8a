"""The port's convnet zoo trained and served against the JAX package's, on
the CPU.

Each model is built in both packages; the JAX parameter and state trees are
filled from a numpy seed (shapes from ``jax.eval_shape``, so no JAX random
draw is compiled) and carried into the port with ``params_from_jax`` and
``state_from_jax``.  Inputs come from numpy seeds.

- Training parity: CIFAR ResNet-20 (shortcut A and B, channels-last) at B4
  on 32 x 32, and LeNet-5 at B8, each trained 3 steps of SGD with momentum
  through ``Optimizer.create(...).optimize()`` in both packages over 2
  batches of data (the third step starts a second epoch and its reshuffle).
  Losses within 1e-5 relative; trained weights and running statistics
  within 1e-4 in root mean square per tensor and 1e-3 in their largest
  entry.  The largest entry is not held to 1e-4: in
  ResNet-20 B the JAX package's fp32 gradient differs from the port's
  float64 gradient by about 3e-4 of its largest entry, the port's fp32
  gradient by about 2e-6 (``test_fp32_gradient_matches_float64`` holds
  them to 1e-3 and 1e-5), so after 3 steps one conv weight differs by
  about 1.2e-4, and a running variance downstream of it by as much.  A
  ReLU whose input lies within the forward's rounding of zero, where the
  two fp32 forwards can pick different masks, would do this; that cause
  is not checked.
- ImageNet ResNet-50 at its full width, B1 at 224 x 224, eval forward:
  log-probs within atol 1e-4; ``Predictor(fold_bn=True)`` within 1e-4 of
  the largest |log-prob| (folding multiplies each kernel by its BN scale
  before the convolution's sums instead of after, so its error grows with
  the magnitude; the card's gate in ``chip_smoke.py`` uses the same
  tolerance).  Its running statistics are the batch statistics of a
  calibration image (one JAX training-mode forward with momentum 1), so
  that the eval forward keeps its activations at unit scale and the logits
  are O(1).
- ``Evaluator.test`` with ``Top1Accuracy``, ``Top5Accuracy`` and ``Loss``
  over 10 LeNet-5 samples in batches of 4 (the last one ragged): the same
  counts, the loss within 1e-5 relative.
- The divergence guard: a non-finite batch leaves weights, optimizer slots
  and running statistics bit-identical.
- bf16: one step of a CIFAR ResNet-8 (shortcut B, so a strided 1 x 1
  convolution shortcut with its BN) through ``set_precision("bf16")`` in
  both packages, beside the port's fp32 step from the same weights.  bf16
  keeps 8 significant bits (relative spacing 2^-8 = 3.9e-3), and the two
  packages round intermediates to bf16 at different places (the port's
  BatchNorm normalises in fp32 and rounds once, the JAX package's rounds
  its batch mean and variance and each step of the normalisation).  The
  loss agrees within 1e-2 relative and the running statistics within 1e-2
  of their largest entry.  The weight update is where bf16 shows: each
  package's bf16 update differs from the fp32 update far more than bf16's
  spacing, in the conv tensors most (BatchNorm's backward leaves a small
  difference of large terms).  So the port's update (all tensors as one
  vector) must agree with the JAX package's within 50% of its norm, and
  be no farther from the fp32 update than 1.25 times the JAX package's
  is.

Each optimize() runs under a fresh ``RandomGenerator`` in both packages,
and the previous thread-local ones are put back: the tier-1 run shares
worker processes with the JAX tests.
"""

import contextlib
import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset import LocalDataSet as JaxLocalDataSet
from bigdl_tpu.dataset import SampleToMiniBatch as JaxSampleToMiniBatch
from bigdl_tpu.dataset.sample import Sample as JaxSample
from bigdl_tpu.models.lenet import lenet5 as jax_lenet5
from bigdl_tpu.models.resnet import resnet as jax_resnet
from bigdl_tpu.utils.random_generator import \
    RandomGenerator as JaxRandomGenerator
import bigdl_tpu_torch.nn as pnn
import bigdl_tpu_torch.optim as poptim
from bigdl_tpu_torch.dataset import LocalDataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.models import lenet5, resnet
from bigdl_tpu_torch.utils.convert import (params_from_jax, params_to_jax,
                                           state_from_jax, state_to_jax)
from bigdl_tpu_torch.utils.random_generator import RandomGenerator

STEPS = 3


@contextlib.contextmanager
def seeded(seed):
    """Both packages' thread-local RandomGenerator replaced by a fresh one
    seeded with ``seed``; the previous ones are put back after."""
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


def numpy_trees(jm, seed):
    """``jm``'s parameter and state trees from a numpy seed: 4-D conv
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

    params = jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(jm._init_params, jax.random.PRNGKey(0)))
    state = jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(jm._init_state))
    return params, state


def install(jm, params, state):
    """Give the JAX model these trees without drawing its own."""
    jm._params = jax.tree_util.tree_map(jnp.asarray, params)
    jm._state = jax.tree_util.tree_map(jnp.asarray, state)
    jm._grads = jax.tree_util.tree_map(jnp.zeros_like, jm._params)
    jm._adopt()
    return jm


def both(jm, pm, seed=0):
    """The two models with the same numpy-seeded trees."""
    params, state = numpy_trees(jm, seed)
    install(jm, params, state)
    params_from_jax(params, pm)
    state_from_jax(state, pm)
    return params, state


def assert_trees_close(port_tree, jax_tree, rms=1e-4, largest=1e-3):
    """Per tensor: root mean square difference within ``rms``, the largest
    within ``largest``."""
    pl, jl = (jax.tree_util.tree_leaves(t) for t in (port_tree, jax_tree))
    assert len(pl) == len(jl) and pl
    for p, j in zip(pl, jl):
        d = np.abs(p - np.asarray(j))
        assert np.sqrt(np.mean(d ** 2)) <= rms and d.max() <= largest, \
            (p.shape, np.sqrt(np.mean(d ** 2)), d.max())


class _Losses:
    """A train summary that keeps the JAX trainer's per-step losses."""

    def __init__(self):
        self.losses = []

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.losses.append(float(value))


def classify(nn, body):
    return nn.Sequential().add(body).add(nn.LogSoftMax())


def images(n, shape, classes, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n,) + shape).astype(np.float32)
    y = rng.integers(1, classes + 1, n).astype(np.float32)
    return x, y


def train(model, x, y, batch, package, precision=None, steps=STEPS,
          seed=11):
    """``steps`` of SGD(0.01, momentum 0.9) through
    ``Optimizer.create(...).optimize()``; returns the optimizer and the
    per-step losses."""
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
    if precision:
        opt.set_precision(precision)
    summary = _Losses()
    if jax_side:
        opt.set_train_summary(summary)
    with seeded(seed):
        opt.optimize()
    losses = summary.losses if jax_side else [h["loss"]
                                              for h in opt.history]
    return opt, losses


# ------------------------------------------------------- training parity

MODELS = {
    # name: (builder taking (package's builder, kwargs), image shape,
    #        classes, batch, layout passed)
    "resnet20_A": (lambda b, **kw: b(10, 20, "A", **kw), (3, 32, 32), 10, 4),
    "resnet20_B": (lambda b, **kw: b(10, 20, "B", **kw), (3, 32, 32), 10, 4),
    "lenet5": (lambda b, **kw: b(10, **kw), (28 * 28,), 10, 8),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_training_matches_jax(name):
    build, shape, classes, batch = MODELS[name]
    if name == "lenet5":
        jm, pm = build(jax_lenet5), build(lenet5, device="cpu")
    else:
        jm = classify(jnn, build(jax_resnet))
        pm = classify(pnn, build(resnet, device="cpu"))
        assert isinstance(pm.layers[0].layers[0], pnn.NCHWToNHWC)
    init, init_state = both(jm, pm, seed=1)
    x, y = images(2 * batch, shape, classes, seed=2)
    _, ref_losses = train(jm, x, y, batch, "jax")
    popt, losses = train(pm, x, y, batch, "port")
    assert [h["epoch"] for h in popt.history] == [1, 1, 2]
    assert len(ref_losses) == len(losses) == STEPS
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    trained = params_to_jax(pm)
    assert_trees_close(trained, jm.params)
    # the weights moved, and so did the running statistics
    assert max(np.abs(a - b).max() for a, b in zip(
        jax.tree_util.tree_leaves(trained),
        jax.tree_util.tree_leaves(init))) > 1e-3
    if name != "lenet5":
        stats = state_to_jax(pm)
        assert_trees_close(stats, jm.state)
        assert max(np.abs(a - b).max() for a, b in zip(
            jax.tree_util.tree_leaves(stats),
            jax.tree_util.tree_leaves(init_state))) > 1e-3


# --------------------------------------------- ResNet-50 at full width

@pytest.fixture(scope="module")
def resnet50_pair():
    """ImageNet ResNet-50 in both packages, B1 at 224 x 224; running
    statistics from a calibration image's batch statistics."""
    jm = jax_resnet(1000, 50, dataset="imagenet")
    pm = resnet(1000, 50, dataset="imagenet", device="cpu")
    params, state = numpy_trees(jm, 3)
    calib = images(1, (3, 224, 224), 1000, seed=4)[0]
    bns = [m for m in jm.modules()
           if isinstance(m, jnn.SpatialBatchNormalization)]
    for m in bns:
        m.momentum = 1.0
    try:
        _, state = jax.jit(lambda p, s, x: jm.apply(p, x, s, training=True))(
            params, state, jnp.asarray(calib))
    finally:
        for m in bns:
            m.momentum = 0.1
    state = jax.tree_util.tree_map(np.asarray, state)
    params_from_jax(params, pm)
    state_from_jax(state, pm)
    x = images(1, (3, 224, 224), 1000, seed=5)[0]
    logits = jax.jit(lambda p, s, x: jm.apply(p, x, s, training=False)[0])(
        params, state, jnp.asarray(x))
    ref = np.asarray(jax.nn.log_softmax(logits, axis=-1))
    assert sum(p.numel() for p in pm.parameters()) == sum(
        np.size(a) for a in jax.tree_util.tree_leaves(params))
    return pm, x, ref


def test_resnet50_eval_forward_matches_jax(resnet50_pair):
    pm, x, ref = resnet50_pair
    out = torch.log_softmax(pm.eval()(torch.from_numpy(x)).detach(), -1)
    assert out.shape == (1, 1000) and 1.0 < np.abs(ref).max() < 100.0
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


def test_fp32_gradient_matches_float64():
    """Both packages' fp32 gradients of ResNet-20 B, from the training
    parity test's weights and a batch of 4 from its data seed, against the
    port's float64 gradient: the port's within 1e-5 of the largest entry, the JAX
    package's within 1e-3 (it is 3e-4 away at these seeds, which is why the
    trained weights are not held to 1e-4 in their largest entry)."""
    jm = classify(jnn, jax_resnet(10, 20, "B"))
    pm = classify(pnn, resnet(10, 20, "B", device="cpu")).train()
    params, state = both(jm, pm, seed=1)
    x, y = images(4, (3, 32, 32), 10, seed=2)
    crit = pnn.ClassNLLCriterion()
    grads = []
    for dtype in (torch.float32, torch.float64):
        m = copy.deepcopy(pm).to(dtype)
        loss = crit.apply(m(torch.from_numpy(x).to(dtype)),
                          torch.from_numpy(y))
        grads.append([g.double() for g in torch.autograd.grad(
            loss, list(m.parameters()))])

    def jax_loss(p):
        out, _ = jm.apply(p, jnp.asarray(x), jax.tree_util.tree_map(
            jnp.asarray, state), training=True)
        return jnn.ClassNLLCriterion().apply(out, jnp.asarray(y))

    # the JAX gradient, carried into the port's layout by the converter
    jax_tree = jax.jit(jax.grad(jax_loss))(jm.params)
    carrier = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_tree),
                              copy.deepcopy(pm))
    jax_grad = [p.detach().double() for p in carrier.parameters()]
    top = max(g.abs().max().item() for g in grads[1])
    for got, limit in ((grads[0], 1e-5), (jax_grad, 1e-3)):
        err = max((a - b).abs().max().item()
                  for a, b in zip(got, grads[1]))
        assert err <= limit * top, (err, top, limit)


def test_resnet50_predictor_fold_bn_matches_jax(resnet50_pair):
    pm, x, ref = resnet50_pair
    served = classify(pnn, pm)
    pred = poptim.Predictor(served, fold_bn=True, device="cpu")
    assert not any(isinstance(m, pnn.SpatialBatchNormalization)
                   for m in pred.model.modules())
    # the caller's model keeps its BNs and its mode
    served.train()
    n_bn = sum(isinstance(m, pnn.SpatialBatchNormalization)
               for m in pm.modules())
    assert n_bn == 53
    np.testing.assert_allclose(pred.predict(x, batch_size=1), ref,
                               atol=1e-4 * np.abs(ref).max())
    assert served.training and sum(isinstance(
        m, pnn.SpatialBatchNormalization) for m in pm.modules()) == n_bn


# ------------------------------------------------------------ evaluator

def test_evaluator_metrics_match_jax():
    jm, pm = jax_lenet5(10), lenet5(10, device="cpu")
    both(jm, pm, seed=9)
    x, y = images(10, (28 * 28,), 10, seed=10)
    methods = [(m, getattr(poptim, m.__name__))
               for m in (joptim.Top1Accuracy, joptim.Top5Accuracy,
                         joptim.Loss)]
    ref = joptim.Evaluator(jm).test(
        [JaxSample(x[i], y[i]) for i in range(10)],
        [jmeth() for jmeth, _ in methods], 4)
    pm.train()
    out = poptim.Evaluator(pm, device="cpu").test(
        LocalDataSet([Sample(x[i], y[i]) for i in range(10)]),
        [pmeth() for _, pmeth in methods], 4)
    assert pm.training      # the caller's mode is put back
    assert [m.name for m, _ in out] == [m.name for m, _ in ref]
    for (_, got), (_, want) in zip(out, ref):
        assert got.count == want.count == 10
        np.testing.assert_allclose(got.result, want.result, rtol=1e-5)


# ---------------------------------------------------- divergence guard

def test_non_finite_batch_keeps_weights_slots_and_running_statistics():
    pm = classify(pnn, resnet(10, 8, "B", device="cpu"))
    x, y = images(4, (3, 32, 32), 10, seed=6)
    opt, losses = train(pm, x, y, 4, "port", steps=1)
    assert math.isfinite(losses[0])
    method = opt.optim_method
    before = copy.deepcopy((pm.state_dict(), method._slots))
    bad = x.copy()
    bad[1, 0, 3, 4] = np.nan
    ds = LocalDataSet([Sample(bad[i], y[i]) for i in range(4)]).transform(
        SampleToMiniBatch(4))
    opt2 = poptim.Optimizer.create(pm, ds, pnn.ClassNLLCriterion(),
                                   device="cpu")
    opt2.set_optim_method(method).set_end_when(poptim.max_iteration(2))
    with seeded(12):
        opt2.optimize()
    assert math.isnan(opt2.history[0]["loss"])
    after = (pm.state_dict(), method._slots)
    assert before[0].keys() == after[0].keys()
    assert any(k.endswith("running_var") for k in after[0])
    for k in before[0]:
        assert torch.equal(before[0][k], after[0][k]), k
    for a, b in zip(before[1]["dfdx"], after[1]["dfdx"]):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ bf16

def test_bf16_step_matches_jax():
    jm = classify(jnn, jax_resnet(10, 8, "B"))
    pm = classify(pnn, resnet(10, 8, "B", device="cpu"))
    pm32 = copy.deepcopy(pm)
    init, init_state = both(jm, pm, seed=7)
    both(jax_resnet(10, 8, "B"), pm32.layers[0], seed=7)
    x, y = images(4, (3, 32, 32), 10, seed=8)
    _, ref_losses = train(jm, x, y, 4, "jax", precision="bf16", steps=1)
    _, losses = train(pm, x, y, 4, "port", precision="bf16", steps=1)
    train(pm32, x, y, 4, "port", steps=1)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-2)

    def update(tree):
        return np.concatenate([(np.asarray(a) - b).ravel() for a, b in zip(
            jax.tree_util.tree_leaves(tree),
            jax.tree_util.tree_leaves(init))])

    port, ref, fp32 = (update(t) for t in (
        params_to_jax(pm), jm.params, params_to_jax(pm32)))
    norm = np.linalg.norm
    assert norm(port - ref) <= 0.5 * norm(ref)
    assert norm(port - fp32) <= 1.25 * norm(ref - fp32)
    for p, j in zip(jax.tree_util.tree_leaves(state_to_jax(pm)),
                    jax.tree_util.tree_leaves(jm.state)):
        j = np.asarray(j)
        assert np.abs(p - j).max() <= 1e-2 * np.abs(j).max()
