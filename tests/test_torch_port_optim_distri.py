"""Validation scores, ``DistriOptimizer``'s sharded methods and the method's
snapshot payload, held against the JAX package.

Split from ``test_torch_port_optim_methods.py``,
whose docstring states what is held against the JAX package and with which
tolerances; the helpers and fixtures come from there.  No test file of the
port holds more than 25 tests: pytest-xdist's ``loadfile`` scheduler hands
out the largest files first (ROADMAP.md, standing rules).
"""

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
import bigdl_tpu.optim.evaluator as jevaluator
from bigdl_tpu.dataset.datasets import \
    synthetic_separable as jax_synthetic_separable
import bigdl_tpu_torch.nn as pnn
import bigdl_tpu_torch.optim as poptim
from bigdl_tpu_torch.dataset import Sample, SampleToMiniBatch, ShardedDataSet
from bigdl_tpu_torch.optim import optim_method as pom
from bigdl_tpu_torch.optim.optimizer import LocalOptimizer
from bigdl_tpu_torch.parallel import DistriOptimizer
from bigdl_tpu_torch.utils import config as pconfig
from bigdl_tpu_torch.utils.convert import params_from_jax

from test_torch_port_optim_methods import (_mlp, group1, properties, seeded)


def test_validation_scores_and_max_score_match_jax(monkeypatch):
    jm = _mlp(jnn)
    jm.reset(jax.random.PRNGKey(4))
    pm = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                         _mlp(pnn, device="cpu"))
    records = jax_synthetic_separable(78, 4, n_classes=3, seed=5)
    jtrain, jval = records[:48], records[48:]
    ptrain, pval = ([Sample(s.features[0], s.labels[0]) for s in ss]
                    for ss in (jtrain, jval))
    jax_scores = []
    real = jevaluator.evaluate_dataset

    def recording(*args, **kwargs):
        results = real(*args, **kwargs)
        jax_scores.append({m.name: r.final_result() for m, r in results})
        return results

    monkeypatch.setattr(jevaluator, "evaluate_dataset", recording)
    evals = []
    with seeded(8):
        for model, mod, nn_mod, train, val, kw in (
                (jm, joptim, jnn, jtrain, jval, {}),
                (pm, poptim, pnn, ptrain, pval, {"device": "cpu"})):
            opt = mod.Optimizer.create(model, train,
                                       nn_mod.ClassNLLCriterion(),
                                       batch_size=8, **kw)
            opt.set_optim_method(mod.SGD(learning_rate=0.02))
            opt.set_validation(mod.every_epoch(), val,
                               [mod.Loss(nn_mod.ClassNLLCriterion()),
                                mod.Top1Accuracy()], batch_size=10)
            opt.set_end_when(mod.max_score(0.95) | mod.max_epoch(30))
            opt.optimize()
            evals.append(opt.optim_method.state["evalCounter"])
    port = opt.validation_history
    assert evals[0] == evals[1] and len(port) == len(jax_scores) > 1
    assert port[-1]["Top1Accuracy"] > 0.95 and evals[1] < 30 * 6
    for p, j in zip(port, jax_scores):
        assert p["Top1Accuracy"] == j["Top1Accuracy"]
        np.testing.assert_allclose(p["Loss"], j["Loss"], rtol=0, atol=1e-5)
    assert [p["neval"] for p in port] == [6 * (i + 1)
                                         for i in range(len(port))]
    assert opt.optim_method.state["score"] == port[-1]["Top1Accuracy"]


@pytest.mark.parametrize("name", ["Adagrad", "Adadelta", "Adamax",
                                  "RMSprop"])
def test_distri_optimizer_shards_the_method_bit_for_bit(group1, name):
    """At one rank the trainers agree to the bit: the method's slots go
    through ``map_over_slots`` and the ZeRO-1 shards, and come back per
    parameter."""
    samples = [Sample(s.features[0], s.labels[0])
               for s in jax_synthetic_separable(32, 4, n_classes=3, seed=9)]
    runs = []
    for cls in (LocalOptimizer, DistriOptimizer):
        model = _mlp(pnn, device="cpu")
        ds = ShardedDataSet(samples, 1).transform(SampleToMiniBatch(8))
        with seeded(10), properties([pconfig], bigdl__parallel__overlap=True):
            opt = cls(model, ds, pnn.ClassNLLCriterion(), device="cpu")
            opt.set_optim_method(getattr(pom, name)())
            opt.set_end_when(poptim.max_iteration(6)).optimize()
        slots = opt.optim_method._slots
        runs.append(([h["loss"] for h in opt.history],
                     [p.detach() for p in model.parameters()],
                     [t for k in sorted(slots) for t in slots[k]]))
    (l0, p0, s0), (l1, p1, s1) = runs
    assert l0 == l1 and len(s0) == len(s1) > 0
    for a, b in zip(p0 + s0, p1 + s1):
        assert torch.equal(a, b)


def test_distri_optimizer_refuses_lbfgs_like_jax(group1):
    """Neither package's data-parallel trainer has a feval step: its first
    step calls LBFGS's ``pure_update``, which raises (the JAX package's
    retry loop retries it; with one attempt, both raise the same text)."""
    from bigdl_tpu.dataset import ShardedDataSet as JaxShardedDataSet
    from bigdl_tpu.dataset import SampleToMiniBatch as JaxSampleToMiniBatch
    from bigdl_tpu.parallel import DistriOptimizer as JaxDistriOptimizer
    from bigdl_tpu.utils import config as jconfig
    records = jax_synthetic_separable(32, 4, n_classes=3, seed=9)
    jm = _mlp(jnn)
    jm.reset(jax.random.PRNGKey(4))
    jds = JaxShardedDataSet(records, partition_num=8).transform(
        JaxSampleToMiniBatch(16, 8))
    pds = ShardedDataSet([Sample(s.features[0], s.labels[0])
                          for s in records], 1).transform(
        SampleToMiniBatch(16))
    with properties([jconfig, pconfig], bigdl__failure__retryTimes=1):
        for opt, mod in ((JaxDistriOptimizer(jm, jds,
                                             jnn.ClassNLLCriterion()),
                          joptim),
                         (DistriOptimizer(_mlp(pnn, device="cpu"), pds,
                                          pnn.ClassNLLCriterion(),
                                          device="cpu"), poptim)):
            opt.set_optim_method(mod.LBFGS())
            opt.set_end_when(mod.max_iteration(2))
            with pytest.raises(NotImplementedError,
                               match="LBFGS needs re-evaluation inside the "
                                     "step; use optimize"):
                opt.optimize()


def test_optim_method_saves_and_loads_as_plain_data(tmp_path):
    sgd = pom.SGD(learning_rate=0.2, momentum=0.9,
                  learning_rate_schedule=pom.Plateau("score", patience=1))
    sgd.state.update(evalCounter=7, epoch=3, score=0.5)
    sgd.schedule._best, sgd.schedule._wait = 0.4, 1
    sgd.set_slots({"dfdx": [torch.arange(3.0), torch.ones(2, 2)]})
    sgd.save(str(tmp_path / "optim"))
    back = pom.OptimMethod.load(str(tmp_path / "optim"))
    assert type(back) is pom.SGD and back.state == sgd.state
    assert (back.learning_rate, back.momentum) == (0.2, 0.9)
    assert type(back.schedule) is pom.Plateau
    assert (back.schedule._best, back.schedule._wait) == (0.4, 1)
    assert all(torch.equal(a, b) for a, b in
               zip(back._slots["dfdx"], sgd._slots["dfdx"]))
    with pytest.raises(TypeError, match="cannot be loaded into"):
        pom.load_payload(pom.Adam(), pom.optim_payload(sgd))
    decay = pom.SGD(learning_rate_schedule=pom.EpochDecay(lambda e: e))
    decay.save(str(tmp_path / "decay"))
    with pytest.raises(NotImplementedError, match="holds code"):
        pom.OptimMethod.load(str(tmp_path / "decay"))
