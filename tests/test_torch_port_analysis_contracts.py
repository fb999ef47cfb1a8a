"""The module contracts, ``optim/metrics.py`` and LBFGS, held against the JAX
package.

Split from ``test_torch_port_analysis.py``,
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
import bigdl_tpu.optim as joptim
from bigdl_tpu.analysis import contracts as jcontracts, hostsync as jhostsync
from bigdl_tpu.dataset import (LocalDataSet as JaxLocalDataSet,
                               SampleToMiniBatch as JaxSampleToMiniBatch)
from bigdl_tpu.dataset.datasets import synthetic_separable
from bigdl_tpu.optim.metrics import Metrics as JaxMetrics
import bigdl_tpu_torch.nn as pnn
import bigdl_tpu_torch.optim as poptim
from bigdl_tpu_torch.analysis import (contracts as pcontracts,
                                      hostsync as phostsync,
                                      retrace as pretrace)
from bigdl_tpu_torch.dataset import Sample
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optimizer import LocalOptimizer
from bigdl_tpu_torch.utils.convert import params_from_jax, params_to_jax

from test_torch_port_analysis import (_both, _Capture, _check_both, _convnet,
                                      _jax_pin, _mlp, _port_pin, _violations,
                                      _zeros, port_lock_witness, seeded)


def test_clean_and_abstract_inputs_check_ok():
    models = _both(_convnet)
    _, prep = _check_both(models, np.zeros((2, 3, 8, 8), np.float32))
    assert prep.ok and prep.modules_checked >= 5
    spec = pretrace.Spec((2, 3, 8, 8), np.float32)
    assert pcontracts.check_model(models[1], spec, mode="off").ok


def test_int_input_violates_the_conv_dtype_contract():
    _, prep = _check_both(_both(_convnet), np.zeros((2, 3, 8, 8), np.int32))
    assert ("dtype", "Sequential[0].SpatialConvolution") in _violations(prep)


def test_declared_ndim_violation_names_the_container_path():
    def build(mod, **kw):
        inner = mod.Sequential().add(mod.Linear(4, 4, **kw))
        if mod is pnn:
            inner.layers[0].set_contract(input_ndim=(2,), dtypes="float")
        else:
            inner[0].declare_contract(input_ndim=(2,), dtypes="float")
        return mod.Sequential().add(mod.ReLU()).add(inner)
    _, prep = _check_both(_both(build), np.zeros((2, 3, 4), np.float32))
    ndim = [v for v in prep.violations if v.kind == "ndim"]
    assert ndim and ndim[0].module == "Sequential[1].Sequential[0].Linear"
    assert "Sequential[1].Sequential[0].Linear" in str(prep)


def test_promotion_drift_flagged():
    """bf16 activations through an fp32-pinning module: promotion drift in
    both."""
    jm = _zeros(jnn.Sequential().add(_jax_pin()))
    pm = pnn.Sequential().add(_port_pin())
    jrep = jcontracts.check_model(jm, jnp.zeros((2, 4), jnp.bfloat16),
                                  mode="off")
    prep = pcontracts.check_model(pm, pretrace.Spec((2, 4), torch.bfloat16),
                                  mode="off")
    assert _violations(jrep) == _violations(prep) == [
        ("promotion", "Sequential[0].F32Pin")]


def test_nchw_op_inside_nhwc_region_flagged_and_strict_raises():
    jm = _zeros(jnn.to_channels_last(_convnet(jnn)))
    pm = pnn.to_channels_last(_convnet(pnn, device="cpu"))
    x = np.zeros((2, 3, 8, 8), np.float32)
    assert _check_both((jm, pm), x)[1].ok
    jm.find_modules(jnn.SpatialConvolution)[0].format = "NCHW"
    [m for m in pm.modules()
     if isinstance(m, pnn.SpatialConvolution)][0].format = "NCHW"
    _, prep = _check_both((jm, pm), x)
    assert prep.by_kind("layout")
    with pytest.raises(pcontracts.ContractError):
        pcontracts.check_model(pm, x, mode="strict")


def test_folded_serving_model_and_moe_block_check_clean():
    def build(mod, **kw):
        return (mod.Sequential()
                .add(mod.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1, **kw))
                .add(mod.SpatialBatchNormalization(8, **kw))
                .add(mod.ReLU()).add(mod.View(8 * 8 * 8))
                .add(mod.Linear(8 * 8 * 8, 10, **kw)))
    jm, pm = _both(build)
    jm.evaluate()
    pm.evaluate()
    folded = (_zeros(jnn.to_channels_last(jnn.fold_conv_bn(jm))),
              pnn.to_channels_last(pnn.fold_conv_bn(pm)))
    _, prep = _check_both(folded, np.zeros((2, 3, 8, 8), np.float32))
    assert prep.ok

    def moe(mod, **kw):
        expert = (mod.Sequential().add(mod.Linear(8, 16, **kw))
                  .add(mod.ReLU()).add(mod.Linear(16, 8, **kw)))
        return (mod.Sequential().add(mod.Linear(8, 8, **kw))
                .add(mod.MixtureOfExperts(8, expert, n_experts=4,
                                          capacity_factor=4.0, top_k=2,
                                          **kw))
                .add(mod.Linear(8, 3, **kw)))
    _, prep = _check_both(_both(moe), np.zeros((16, 8), np.float32))
    assert prep.ok and prep.modules_checked >= 3


def test_walk_leaves_no_hook_and_runs_no_flop():
    """The hooks are removed and the modes put back (the twin of
    test_restores_apply_after_walk); the walk runs on meta tensors, so it
    neither reads nor writes the model's tensors."""
    pm = _convnet(pnn, device="cpu")
    pm.evaluate()
    before = [p.clone() for p in pm.parameters()]
    pcontracts.check_model(pm, np.zeros((2, 3, 8, 8), np.float32),
                           training=True, mode="off")
    assert all(not m._forward_hooks and not m._forward_pre_hooks
               for m in pm.modules())
    assert not any(m.training for m in pm.modules())
    assert all(torch.equal(a, b) for a, b in zip(before, pm.parameters()))
    assert pm(torch.zeros(2, 3, 8, 8)).shape == (2, 10)


def test_metrics_summary_matches_jax():
    out = []
    for cls, arr in ((JaxMetrics, jnp.asarray), (Metrics, torch.tensor)):
        m = cls()
        m.add("t", 1.0)
        m.add("t", arr(2.0))
        m.add("t", 3)
        m.add("x", arr(2e9))
        m.set("y", 4e9, parallelism=2)
        m.add("z", arr(5.0))
        m.set("z", 1.0)
        m.set("per node", [1.0, 2.0])
        out.append((m.summary(), m.get("t"), m.get("z"), m.get("per node"),
                    m.aggregated("x")))
    assert out[0] == out[1]
    assert "x: 2.0 s" in out[1][0]


def test_metrics_park_device_scalars_without_a_sync():
    """Adds inside a strict region pull nothing, and compaction past
    COMPACT_AT is an on-device sum; one pull at the read, in both."""
    for pkg, cls, arr in ((jhostsync, JaxMetrics, jnp.asarray),
                          (phostsync, Metrics, torch.tensor)):
        m = cls()
        before = pkg.STATS.snapshot()
        with pkg.HostSyncGuard("strict").armed():
            for i in range(m.COMPACT_AT * 2 + 7):
                m.add("t", arr(1.0))
            assert len(m._pending["t"]) < m.COMPACT_AT
        assert m.get("t") == m.COMPACT_AT * 2 + 7
        after = pkg.STATS.snapshot()
        assert after["implicit"] == before["implicit"]
        assert after["explicit_pulls"] == before["explicit_pulls"] + 1


@pytest.mark.parametrize("line_search", [False, True])
def test_lbfgs_quadratic_matches_jax(line_search):
    """The twin of test_optim.py's test_lbfgs_converges_fast: x and every
    loss within rtol 1e-5, and the method's state keys alike."""
    x0 = np.array([0.0, 10.0, -5.0], np.float32)
    jm = joptim.LBFGS(max_iter=10, line_search=line_search)
    pm = poptim.LBFGS(max_iter=10, line_search=line_search)
    jx, jl = jm.optimize(lambda x: (jnp.sum((x - 3.0) ** 2), 2 * (x - 3.0)),
                         jnp.asarray(x0))
    px, pl = pm.optimize(lambda x: (((x - 3.0) ** 2).sum(), 2 * (x - 3.0)),
                         torch.from_numpy(x0))
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-5)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    np.testing.assert_allclose(px.numpy(), 3.0, atol=1e-4)
    assert sorted(jm.state) == sorted(pm.state)
    assert jm.state["evalCounter"] == pm.state["evalCounter"] == 1


@pytest.mark.parametrize("line_search", [False, True])
def test_lbfgs_trainer_path_matches_jax(line_search):
    """The test_dead_apis.py LBFGS trainer path from the same parameters:
    Optimizer.create -> LocalOptimizer's feval step, each iteration's loss
    and the final parameters within rtol 1e-4 / atol 1e-5; no sentinel
    and no guard on the host-driven path, in both."""
    jm = _mlp(jnn)
    with seeded(5489):
        jm.reset(jax.random.PRNGKey(5))
    pm = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                         _mlp(pnn, device="cpu"))
    records = synthetic_separable(128, 4, n_classes=2, seed=3)
    samples = [Sample(s.features[0], s.labels[0]) for s in records]
    jopt = joptim.Optimizer.create(
        jm, JaxLocalDataSet(records).transform(JaxSampleToMiniBatch(128)),
        jnn.ClassNLLCriterion())
    popt = poptim.Optimizer.create(pm, samples, pnn.ClassNLLCriterion(),
                                   batch_size=128, device="cpu")
    caps = []
    for opt, mod in ((jopt, joptim), (popt, poptim)):
        opt.set_optim_method(mod.LBFGS(max_iter=8, line_search=line_search))
        opt.set_end_when(mod.max_iteration(4))
        cap = _Capture()
        opt.set_train_summary(cap)
        opt.optimize()
        caps.append(cap)
    assert isinstance(popt, LocalOptimizer)
    np.testing.assert_allclose(caps[1].tags["Loss"], caps[0].tags["Loss"],
                               rtol=1e-4, atol=1e-5)
    assert [h["loss"] for h in popt.history] == caps[1].tags["Loss"]
    for o, r in zip(jax.tree_util.tree_leaves(params_to_jax(pm)),
                    jax.tree_util.tree_leaves(jm.params)):
        np.testing.assert_allclose(np.asarray(o), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)
    assert (jopt.optim_method.state["evalCounter"] ==
            popt.optim_method.state["evalCounter"])
    assert popt._retrace_sentinel is None and popt._hostsync_base is None
    assert "Analysis/retraces" not in caps[1].tags


def test_lbfgs_refuses_bf16_and_the_sharded_trainers():
    """set_precision with a feval method raises the JAX text; the
    DistriOptimizer refuses LBFGS at its first step, as the JAX one's step
    does (its pure_update raises)."""
    pm = _mlp(pnn, device="cpu")
    samples = [Sample(np.ones(4, np.float32), np.array([1.0]))] * 8
    opt = poptim.Optimizer.create(pm, samples, pnn.ClassNLLCriterion(),
                                  batch_size=8, device="cpu")
    opt.set_optim_method(poptim.LBFGS()).set_precision("bf16")
    opt.set_end_when(poptim.max_iteration(1))
    with pytest.raises(ValueError, match="fp32-only; unset set_precision"):
        opt.optimize()
    with pytest.raises(NotImplementedError, match="use optimize"):
        poptim.LBFGS().pure_update([], [], {}, {})
    with pytest.raises(NotImplementedError, match="use optimize"):
        joptim.LBFGS().pure_update([], [], {}, {})
