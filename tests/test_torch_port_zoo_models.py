"""The zoo's models (Inception, VGG, AlexNet) and the perf harness, held
against the JAX package.

Split from ``test_torch_port_zoo.py``,
whose docstring states what is held against the JAX package and with which
tolerances; the helpers and fixtures come from there.  No test file of the
port holds more than 25 tests: pytest-xdist's ``loadfile`` scheduler hands
out the largest files first (ROADMAP.md, standing rules).
"""

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
from bigdl_tpu.models.inception import inception_layer_v1 as jax_block_v1
import bigdl_tpu_torch.models as pmodels
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu_torch.models import perf
from bigdl_tpu_torch.models.inception import inception_layer_v1
from bigdl_tpu_torch.utils.convert import params_to_jax, state_to_jax

from test_torch_port_zoo import (assert_trees_close, ATOL, cifar_vgg,
                                 EVAL_MODELS, float64_grads, grads_close,
                                 images, jax_forward, pair, POOLS, port_shapes,
                                 train)


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


def test_perf_harness_has_the_reference_table():
    from bigdl_tpu.models import perf as jax_perf
    assert sorted(perf._MODELS) == sorted(jax_perf._MODELS)
    for name, (_, shape, classes) in perf._MODELS.items():
        assert (shape, classes) == jax_perf._MODELS[name][1:]


def test_perf_partitions_raise():
    # without a process group of 2 ranks (torchrun --nproc_per_node 2)
    with pytest.raises(ValueError, match="--partitions 2 needs as many "
                                         "ranks, but this run has 1"):
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
