"""The port's remaining optimization methods, schedules and validation held
against the JAX package, on the CPU.

Each piece goes through both packages with inputs from a numpy seed:

- ``Adagrad``, ``Adadelta``, ``Adamax`` and ``RMSprop``: 10 steps of
  ``pure_update`` from the same parameters and gradients, each step with
  its own ``hyper()`` and ``step_done()``; rtol 1e-5 / atol 1e-7 (the
  same fp32 arithmetic in other orders);
- every learning-rate schedule: the rate of 40 iterations over 6 epochs,
  and ``Plateau`` fed the same scores: equal within 1e-12 relative (both
  compute in Python floats);
- ``scale_w``/``scale_b``: the port trainer's scaled gradient against the
  JAX package's module ``backward`` (atol 1e-6);
- ``set_validation`` on a small MLP in both packages: the same scores
  (``Top1Accuracy`` exact, ``Loss`` within 1e-5) at the same iterations,
  and ``max_score`` stopping both at the same one;
- a new method through ``DistriOptimizer`` on a one-rank gloo group,
  bit-identical to ``LocalOptimizer`` (the port against itself).

Each test reseeds both packages' ``RandomGenerator`` with a fresh instance
and puts back the previous thread-local ones, and restores every config
key it sets: the tier-1 run shares worker processes with the JAX tests.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import bigdl_tpu.nn as jnn
from bigdl_tpu.optim import optim_method as jom
from bigdl_tpu.utils.random_generator import \
    RandomGenerator as JaxRandomGenerator
import bigdl_tpu_torch.nn as pnn
import bigdl_tpu_torch.optim as poptim
from bigdl_tpu_torch.dataset import Sample
from bigdl_tpu_torch.engine import Engine
from bigdl_tpu_torch.optim import optim_method as pom
from bigdl_tpu_torch.utils.convert import params_from_jax, params_to_jax
from bigdl_tpu_torch.utils.random_generator import RandomGenerator

RTOL, ATOL = 1e-5, 1e-7
LR_RTOL = 1e-12


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


@contextlib.contextmanager
def properties(mods, **keys):
    """Set config keys (dots as ``__``) in the config modules ``mods``,
    restore them after."""
    saved = []
    for mod in mods:
        for key, value in keys.items():
            name = key.replace("__", ".")
            saved.append((mod, name, name in mod._OVERRIDES,
                          mod._OVERRIDES.get(name)))
            mod.set_property(name, value)
    try:
        yield
    finally:
        for mod, name, had, value in saved:
            if had:
                mod.set_property(name, value)
            else:
                mod.clear_property(name)


# ------------------------------------------------------------ the methods

def _params_and_grads(seed, steps):
    rng = np.random.default_rng(seed)
    shapes = [(3, 4), (5,), (2, 3, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(steps)]
    return params, grads


METHODS = [
    ("Adagrad", dict(learning_rate=0.1)),
    ("Adagrad", dict(learning_rate=0.05, learning_rate_decay=0.1,
                     weight_decay=0.01)),
    ("Adadelta", dict()),
    ("Adadelta", dict(decay_rate=0.5, epsilon=1e-6)),
    ("Adamax", dict()),
    ("Adamax", dict(learning_rate=0.01, beta1=0.8, beta2=0.99,
                    epsilon=1e-8)),
    ("RMSprop", dict()),
    ("RMSprop", dict(learning_rate=0.05, learning_rate_decay=0.2,
                     decay_rate=0.9, epsilon=1e-6)),
]


@pytest.mark.parametrize("name,kw", METHODS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(METHODS)])
def test_method_matches_jax_over_ten_steps(name, kw):
    jmethod, pmethod = getattr(jom, name)(**kw), getattr(pom, name)(**kw)
    params, grads = _params_and_grads(7, 10)
    jp = [jnp.asarray(p) for p in params]
    pp = [torch.from_numpy(p.copy()) for p in params]
    js, ps = jmethod.init_slots(jp), pmethod.init_slots(pp)
    assert sorted(js) == sorted(ps)
    for g in grads:
        jh, ph = jmethod.hyper(), pmethod.hyper()
        assert jh == ph
        jp, js = jmethod.pure_update([jnp.asarray(x) for x in g], jp, js, jh)
        slots_before = {k: [t.clone() for t in v] for k, v in ps.items()}
        pp, new_ps = pmethod.pure_update([torch.from_numpy(x) for x in g],
                                         pp, ps, ph)
        # pure: the inputs are not written
        for k, v in slots_before.items():
            assert all(torch.equal(a, b) for a, b in zip(v, ps[k]))
        ps = new_ps
        jmethod.step_done()
        pmethod.step_done()
    assert jmethod.state == pmethod.state
    for o, r in zip(pp, jp):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)
    for k in js:
        for o, r in zip(ps[k], js[k]):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL,
                                       atol=ATOL)


def test_lbfgs_is_refused():
    """LBFGS builds with the JAX package's hyper-parameters and refuses
    only the fused step: its ``pure_update`` raises the JAX text (the line
    search re-evaluates the loss, through ``optimize(feval, x)``), and it
    asks the trainers for the feval path."""
    j, p = jom.LBFGS(max_iter=7, line_search=True), pom.LBFGS(
        max_iter=7, line_search=True)
    for attr in ("max_iter", "max_eval", "tolerance_fun", "tolerance_x",
                 "n_correction", "learning_rate", "line_search",
                 "requires_feval"):
        assert getattr(j, attr) == getattr(p, attr), attr
    assert j.state == p.state
    for m in (j, p):
        with pytest.raises(NotImplementedError,
                           match="LBFGS needs re-evaluation inside the step"):
            m.pure_update([], [], {}, {})


# ----------------------------------------------------------- the schedules

def _schedules(mod):
    return {
        "Default": None,
        "Step": mod.Step(5, 0.5),
        "MultiStep": mod.MultiStep([5, 12, 30], 0.3),
        "EpochStep": mod.EpochStep(2, 0.5),
        "EpochDecay": mod.EpochDecay(lambda e: e // 3),
        "Poly": mod.Poly(0.5, 30),
        "Exponential": mod.Exponential(7, 0.9),
        "Exponential-stair": mod.Exponential(7, 0.9, stair_case=True),
        "NaturalExp": mod.NaturalExp(6, 0.2),
        "EpochSchedule": mod.EpochSchedule([
            mod.Regime(1, 2, {"learning_rate": 0.1}),
            mod.Regime(3, 6, {"learning_rate": 0.01,
                              "weight_decay": 1e-4})]),
        "Plateau-min": mod.Plateau("score", factor=0.5, patience=1,
                                   mode="min", cooldown=1, min_lr=0.02),
        "Plateau-max": mod.Plateau("score", factor=0.3, patience=2,
                                   mode="max"),
        "Plateau-Loss": mod.Plateau("Loss", factor=0.5, patience=1),
    }


# the validation scores a plateau sees, one per epoch
SCORES = [0.5, 0.4, 0.45, 0.44, 0.6, 0.6]


@pytest.mark.parametrize("name", list(_schedules(jom)))
def test_schedule_rates_match_jax(name):
    rates = []
    for mod in (jom, pom):
        sched = _schedules(mod)[name]
        sgd = mod.SGD(learning_rate=0.3, learning_rate_decay=0.05,
                      learning_rate_schedule=sched)
        seq = []
        for it in range(40):
            epoch = 1 + it * 6 // 40
            sgd.state["epoch"] = epoch
            sgd.state["score"] = SCORES[epoch - 1]
            sgd.state["Loss"] = 2.0 - SCORES[epoch - 1]
            seq.append(sgd.hyper()["lr"])
            sgd.step_done()
        rates.append(seq)
    assert len(set(rates[1])) > 1 or name == "Default"
    np.testing.assert_allclose(rates[1], rates[0], rtol=LR_RTOL, atol=0)


# ------------------------------------------------------- gradient scales

def test_scale_w_and_scale_b_match_the_jax_module_backward():
    """The JAX package scales a layer's gradients in its own ``backward``
    (``nn/module.py:312``); the port's trainers scale them before the
    update.  One SGD step at lr 1 moves the port's weights by the scaled
    gradient."""
    jlin = jnn.Linear(4, 3)
    jlin.reset(jax.random.PRNGKey(2))
    jlin.scale_w, jlin.scale_b = 0.5, 2.0
    pm = pnn.Sequential().add(pnn.Linear(4, 3, device="cpu")).add(
        pnn.LogSoftMax())
    params_from_jax([jax.tree_util.tree_map(np.asarray, jlin.params), {}],
                    pm)
    pm.layers[0].set_scale_w(0.5).set_scale_b(2.0)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 4)).astype(np.float32)
    y = rng.integers(1, 4, 6).astype(np.float32)
    crit = jnn.ClassNLLCriterion()
    z = jlin.forward(jnp.asarray(x))
    g_out = jax.grad(lambda z: crit.apply(jax.nn.log_softmax(z, -1),
                                          jnp.asarray(y)))(z)
    jlin.zero_grad_parameters()
    jlin.backward(jnp.asarray(x), g_out)
    ref = jax.tree_util.tree_map(np.asarray, jlin.parameters()[1])
    before = params_to_jax(pm)[0]
    opt = poptim.Optimizer.create(pm, [Sample(x[i], y[i]) for i in range(6)],
                                  pnn.ClassNLLCriterion(), batch_size=6,
                                  device="cpu")
    opt.set_optim_method(poptim.SGD(learning_rate=1.0))
    with seeded(3):
        opt.set_end_when(poptim.max_iteration(1)).optimize()
    after = params_to_jax(pm)[0]
    for k in ("weight", "bias"):
        np.testing.assert_allclose(before[k] - after[k], ref[k], atol=1e-6)


# ----------------------------------------------------------- validation

def _mlp(mod, **kw):
    return (mod.Sequential().add(mod.Linear(4, 8, **kw)).add(mod.Tanh())
            .add(mod.Linear(8, 3, **kw)).add(mod.LogSoftMax()))


# -------------------------------------------------- through the trainers

@pytest.fixture
def group1(tmp_path):
    """A gloo process group of one rank in this process, destroyed
    after."""
    Engine.init_distributed(init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()
