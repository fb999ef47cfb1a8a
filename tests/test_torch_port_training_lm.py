"""The tiny LM trained in both packages, the divergence guard and the
parameter round trip.

Split from ``test_torch_port_training.py``,
whose docstring states what is held against the JAX package and with which
tolerances; the helpers and fixtures come from there.  No test file of the
port holds more than 25 tests: pytest-xdist's ``loadfile`` scheduler hands
out the largest files first (ROADMAP.md, standing rules).
"""

import math

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.sample import Sample as JaxSample
from bigdl_tpu.optim.optimizer import DivergenceError as JaxDivergenceError
import bigdl_tpu_torch.nn as pnn
import bigdl_tpu_torch.optim as poptim
from bigdl_tpu_torch.dataset import LocalDataSet, Sample
from bigdl_tpu_torch.utils.convert import params_from_jax, params_to_jax

from test_torch_port_training import (_assert_trees_close, _guard_run, _mlp,
                                      _np_tree, _train_both, lm_rows, lms,
                                      properties, seeded, STEPS)


def test_lm_training_sgd_momentum_matches_jax(lms, lm_rows):
    jopt, popt = _train_both(
        lms, lm_rows, lambda mod: mod.SGD(learning_rate=0.01, momentum=0.9))
    jm, pm, init = lms
    assert [h["neval"] for h in popt.history] == [1, 2, 3]
    assert [h["epoch"] for h in popt.history] == [1, 1, 2]
    assert all(math.isfinite(h["loss"]) for h in popt.history)
    assert popt.optim_method.state["evalCounter"] == \
        jopt.optim_method.state["evalCounter"] == STEPS
    assert popt.optim_method.state["epoch"] == \
        jopt.optim_method.state["epoch"] == 2
    trained = params_to_jax(pm)
    _assert_trees_close(trained, jm.params, atol=1e-5)
    # the weights moved: the comparison is not of the initial weights
    moved = [np.abs(a - b).max() for a, b in zip(
        jax.tree_util.tree_leaves(trained), jax.tree_util.tree_leaves(init))]
    assert max(moved) > 1e-4


def test_lm_training_adam_matches_jax(lms, lm_rows):
    _train_both(lms, lm_rows, lambda mod: mod.Adam(learning_rate=1e-3))
    jm, pm, _ = lms
    trained = jax.tree_util.tree_leaves_with_path(params_to_jax(pm))
    ref = jax.tree_util.tree_leaves(jm.params)
    assert len(trained) == len(ref)
    for (path, p), r in zip(trained, ref):
        key_bias = jax.tree_util.keystr(path).endswith("['bk']")
        np.testing.assert_allclose(p, np.asarray(r),
                                   atol=1e-3 if key_bias else 1e-4, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_nan_batch_leaves_weights_bit_identical_in_both():
    init, jax_after, port_after = _guard_run(1, nan_rows=slice(None))
    for tree in (jax_after, port_after):
        for a, b in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(init)):
            np.testing.assert_array_equal(a, b)


def test_without_the_guard_a_nan_batch_poisons_the_weights_in_both():
    """``bigdl.divergence.guard=false``: the same step writes the
    non-finite update, in both packages."""
    with properties(bigdl__divergence__guard=False):
        _, jax_after, port_after = _guard_run(1, nan_rows=slice(None))
    for tree in (jax_after, port_after):
        assert not all(np.isfinite(a).all()
                       for a in jax.tree_util.tree_leaves(tree))


def test_divergence_error_after_max_bad_steps_in_both():
    with properties(bigdl__divergence__maxBadSteps=2,
                    bigdl__failure__retryTimes=1):
        jm = _mlp(jnn)
        jm.reset(jax.random.PRNGKey(3))
        pm = params_from_jax(_np_tree(jm), _mlp(pnn, device="cpu"))
        x = np.full((8, 4), np.nan, np.float32)
        y = np.ones(8, np.float32)
        with seeded(13):
            for model, mod, nn_mod, sample, err, kw in (
                    (jm, joptim, jnn, JaxSample, JaxDivergenceError, {}),
                    (pm, poptim, pnn, Sample, poptim.DivergenceError,
                     {"device": "cpu"})):
                opt = mod.Optimizer.create(
                    model, [sample(x[i], y[i]) for i in range(8)],
                    nn_mod.ClassNLLCriterion(), batch_size=4, **kw)
                opt.set_end_when(mod.max_iteration(10))
                with pytest.raises(err, match="2 consecutive non-finite"):
                    opt.optimize()
        assert [h["neval"] for h in opt.history] == [1, 2]
        assert all(math.isnan(h["loss"]) for h in opt.history)


def test_local_optimizer_defaults_to_cuda_and_refuses_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    model = _mlp(pnn, device="cpu")
    ds = [Sample(np.zeros(4, np.float32), np.float32(1))]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        poptim.LocalOptimizer(model, LocalDataSet(ds),
                              pnn.ClassNLLCriterion())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        poptim.Optimizer.create(model, ds, pnn.ClassNLLCriterion())


def test_params_to_jax_inverts_params_from_jax(lms):
    jm, pm, init = lms
    params_from_jax(init, pm)
    back = params_to_jax(pm)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(init)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(init)):
        np.testing.assert_array_equal(a, b)
