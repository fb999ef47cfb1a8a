"""The port's training slice held against the JAX package, on the CPU.

Each piece goes through both packages with inputs from a numpy seed: the
criterions, ``SGD``/``Adam`` ``pure_update`` on given gradients, the
triggers, the ``LocalDataSet``/``SampleToMiniBatch`` batch order over two
epochs, the regularizer penalty, and ``Optimizer.create(...).optimize()``
over a tiny transformer LM (vocab 64, d_model 256, 2 heads of 128, 2 layers,
T 128, batch 4, 8 samples, 3 steps: the third crosses an epoch boundary and
its reshuffle).  The JAX parameters are carried into the port with
``params_from_jax`` and the trained weights read back with
``params_to_jax``.  The port runs ``flash=True`` (the flash kernels' plain
forward and backward on CPU tensors); the JAX package runs ``flash=False``,
because its flash path needs a TPU.

Tolerances:
- criterions, penalties, SGD and Adam updates on given gradients: fp32
  atol 1e-6 / rtol 1e-5 (the same fp32 arithmetic in other orders);
- trained LM weights, SGD with momentum: atol 1e-5;
- trained LM weights, Adam (lr 1e-3): atol 1e-4, and 1e-3 for the
  attention's key biases ``bk``.  Adam moves a weight by about lr whatever
  its gradient's size (m / sqrt(v) is +-1), so an entry whose gradient is
  close to 0 carries the two frameworks' different fp32 rounding into its
  step.  The key biases' exact gradient is 0 (they add one constant to all
  of a query's scores, which the softmax cancels): what each framework
  computes is rounding noise of about 1e-9, which Adam's eps (1e-8) turns
  into steps of up to about lr/10 that differ between the two;
- the divergence guard: bit-identical weights.

Each test reseeds both packages' ``RandomGenerator`` with a fresh instance
and restores the previous thread-local ones, and restores every config key
it sets: the tier-1 run shares worker processes with the JAX tests.
"""

import contextlib
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
from bigdl_tpu.models.transformer import transformer_lm as jax_lm
from bigdl_tpu.optim import optim_method as jom
from bigdl_tpu.optim import regularizer as jreg
from bigdl_tpu.optim import trigger as jtrig
from bigdl_tpu.optim.optimizer import DivergenceError as JaxDivergenceError
from bigdl_tpu.optim.optimizer import \
    regularization_penalty as jax_regularization_penalty
from bigdl_tpu.utils import config as jconfig
from bigdl_tpu.utils.random_generator import \
    RandomGenerator as JaxRandomGenerator
import bigdl_tpu_torch.nn as pnn
import bigdl_tpu_torch.optim as poptim
from bigdl_tpu_torch.dataset import LocalDataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.models.transformer import transformer_lm
from bigdl_tpu_torch.optim import optim_method as pom
from bigdl_tpu_torch.optim import regularizer as preg
from bigdl_tpu_torch.optim import trigger as ptrig
from bigdl_tpu_torch.optim.optimizer import regularization_penalty
from bigdl_tpu_torch.utils import config as pconfig
from bigdl_tpu_torch.utils.convert import params_from_jax, params_to_jax
from bigdl_tpu_torch.utils.random_generator import RandomGenerator

ATOL, RTOL = 1e-6, 1e-5
VOCAB, D_MODEL, N_HEAD, N_LAYERS, SEQ = 64, 256, 2, 2, 128
BATCH, N_SAMPLES, STEPS = 4, 8, 3


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
def properties(**keys):
    """Set config keys in both packages (dots as ``__``), restore after."""
    saved = []
    for mod in (jconfig, pconfig):
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


def _np_tree(jm):
    return jax.tree_util.tree_map(np.asarray, jm.params)


def _assert_trees_close(port_tree, jax_tree, atol, rtol=0.0):
    pl, jl = (jax.tree_util.tree_leaves(t) for t in (port_tree, jax_tree))
    assert len(pl) == len(jl)
    for p, j in zip(pl, jl):
        np.testing.assert_allclose(p, np.asarray(j), atol=atol, rtol=rtol)


# ------------------------------------------------------------- criterions

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("size_average", [True, False])
def test_class_nll_matches_jax(weighted, size_average):
    rng = np.random.default_rng(0)
    logp = np.log(rng.dirichlet(np.ones(5), 6)).astype(np.float32)
    target = rng.integers(1, 6, 6).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 5).astype(np.float32) if weighted else None
    ref = jnn.ClassNLLCriterion(w, size_average).forward(
        jnp.asarray(logp), jnp.asarray(target))
    crit = pnn.ClassNLLCriterion(w, size_average)
    out = crit.forward(torch.from_numpy(logp), torch.from_numpy(target))
    assert crit.output is out
    np.testing.assert_allclose(out.item(), float(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("weighted", [False, True])   # flat / unrolled path
@pytest.mark.parametrize("size_average", [True, False])
def test_time_distributed_matches_jax(weighted, size_average):
    rng = np.random.default_rng(1)
    logp = np.log(rng.dirichlet(np.ones(7), (3, 4))).astype(np.float32)
    target = rng.integers(1, 8, (3, 4)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 7).astype(np.float32) if weighted else None
    jc = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(w), size_average)
    pc = pnn.TimeDistributedCriterion(pnn.ClassNLLCriterion(w), size_average)
    assert pc._separable() == (not weighted)
    ref = jc.forward(jnp.asarray(logp), jnp.asarray(target))
    out = pc.forward(torch.from_numpy(logp), torch.from_numpy(target))
    np.testing.assert_allclose(out.item(), float(ref), atol=ATOL, rtol=RTOL)
    # backward: the gradient with respect to the input
    gref = jc.backward(jnp.asarray(logp), jnp.asarray(target))
    grad = pc.backward(torch.from_numpy(logp), torch.from_numpy(target))
    assert pc.grad_input is grad
    np.testing.assert_allclose(grad.numpy(), np.asarray(gref), atol=ATOL,
                               rtol=RTOL)


# ------------------------------------------------------- optim methods

def _params_and_grads(seed, steps):
    rng = np.random.default_rng(seed)
    shapes = [(3, 4), (5,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(steps)]
    return params, grads


def _run_updates(jmethod, pmethod, seed, steps=3):
    """Three steps of pure_update in both packages from the same params and
    gradients, each with its own hyper() and step_done()."""
    params, grads = _params_and_grads(seed, steps)
    jp = [jnp.asarray(p) for p in params]
    pp = [torch.from_numpy(p.copy()) for p in params]
    js, ps = jmethod.init_slots(jp), pmethod.init_slots(pp)
    for g in grads:
        jp, js = jmethod.pure_update([jnp.asarray(x) for x in g], jp, js,
                                     jmethod.hyper())
        before = [p.clone() for p in pp]
        pp, ps = pmethod.pure_update([torch.from_numpy(x) for x in g], pp,
                                     ps, pmethod.hyper())
        jmethod.step_done()
        pmethod.step_done()
        assert all(not torch.equal(a, b) for a, b in zip(before, pp))
    assert jmethod.state == pmethod.state
    return [np.asarray(x) for x in jp], [x.numpy() for x in pp]


@pytest.mark.parametrize("kw", [
    dict(learning_rate=0.1),
    dict(learning_rate=0.1, momentum=0.9),
    dict(learning_rate=0.1, momentum=0.9, dampening=0.0, nesterov=True,
         weight_decay=0.01),
    dict(learning_rate=0.1, learning_rate_decay=0.5, momentum=0.5,
         dampening=0.2),
])
def test_sgd_pure_update_matches_jax(kw):
    ref, out = _run_updates(jom.SGD(**kw), pom.SGD(**kw), seed=2)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, r, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kw", [dict(), dict(learning_rate=0.01,
                                             learning_rate_decay=0.1,
                                             beta1=0.8, beta2=0.99)])
def test_adam_pure_update_matches_jax(kw):
    ref, out = _run_updates(jom.Adam(**kw), pom.Adam(**kw), seed=3)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, r, atol=ATOL, rtol=RTOL)


def test_sgd_first_step_takes_the_gradient_and_slots_stay_untouched():
    p = [torch.ones(3)]
    g = [torch.full((3,), 2.0)]
    sgd = pom.SGD(learning_rate=0.5, momentum=0.9)
    slots = sgd.init_slots(p)
    new_p, new_slots = sgd.pure_update(g, p, slots, sgd.hyper())
    assert torch.equal(new_slots["dfdx"][0], g[0])      # v = g at t == 0
    assert torch.equal(new_p[0], torch.zeros(3))         # 1 - 0.5 * 2
    assert torch.equal(p[0], torch.ones(3))              # inputs unwritten
    assert torch.equal(slots["dfdx"][0], torch.zeros(3))


def test_nesterov_without_momentum_is_refused_like_jax():
    for mod in (jom, pom):
        with pytest.raises(ValueError, match="Nesterov"):
            mod.SGD(nesterov=True)


# ------------------------------------------------------------ triggers

def _trigger_pairs():
    return [
        (jtrig.every_epoch(), ptrig.every_epoch()),
        (jtrig.several_iteration(3), ptrig.several_iteration(3)),
        (jtrig.max_epoch(2), ptrig.max_epoch(2)),
        (jtrig.max_iteration(4), ptrig.max_iteration(4)),
        (jtrig.max_score(0.5), ptrig.max_score(0.5)),
        (jtrig.min_loss(1.0), ptrig.min_loss(1.0)),
        (jtrig.max_iteration(5) & jtrig.min_loss(2.0),
         ptrig.max_iteration(5) & ptrig.min_loss(2.0)),
        (jtrig.max_epoch(3) | jtrig.max_score(0.9),
         ptrig.max_epoch(3) | ptrig.max_score(0.9)),
    ]


def test_triggers_fire_like_jax():
    states = [{"epoch": 1 + n // 3, "neval": n,
               "Loss": None if n == 1 else 3.0 - 0.4 * n,
               "score": None if n < 4 else 0.2 * n}
              for n in range(1, 10)]
    for jt, pt in _trigger_pairs():
        assert [pt(s) for s in states] == [jt(s) for s in states]
        assert pt.reads_loss == jt.reads_loss


# ------------------------------------------------- dataset and batches

def test_batch_order_over_two_epochs_matches_jax():
    """The training loop's protocol: shuffle, iterate batches, reshuffle and
    restart at the epoch boundary; 10 records in batches of 4, so a batch
    crosses the boundary as the reference's looped iterator makes it."""
    x = np.arange(10, dtype=np.float32)[:, None] * np.ones((1, 3), np.float32)
    ys = np.arange(10, dtype=np.float32) + 1

    def batches(ds_cls, sample_cls, to_batch):
        ds = ds_cls([sample_cls(x[i], ys[i]) for i in range(10)]).transform(
            to_batch(4))
        out, fetched = [], 0
        ds.shuffle()
        it = ds.data(train=True)
        for _ in range(6):
            b = next(it)
            out.append((b.get_input().copy(), b.get_target().copy()))
            fetched += b.size()
            if fetched >= ds.size():
                fetched = 0
                ds.shuffle()
                it = ds.data(train=True)
        return out

    with seeded(7):
        ref = batches(JaxLocalDataSet, JaxSample, JaxSampleToMiniBatch)
        out = batches(LocalDataSet, Sample, SampleToMiniBatch)
    assert len(out) == len(ref) == 6
    for (oi, ot), (ri, rt) in zip(out, ref):
        np.testing.assert_array_equal(oi, ri)
        np.testing.assert_array_equal(ot, rt)
    # the two epochs were shuffled differently
    assert not np.array_equal(out[0][1], out[3][1])


# -------------------------------------------------------- regularizers

@pytest.mark.parametrize("kind", ["l1", "l2", "l1l2"])
def test_regularization_penalty_matches_jax(kind):
    def regs(mod):
        return {"l1": mod.L1Regularizer(0.01), "l2": mod.L2Regularizer(0.1),
                "l1l2": mod.L1L2Regularizer(0.01, 0.1)}[kind]
    jm = (jnn.Sequential()
          .add(jnn.Linear(4, 6, w_regularizer=regs(jreg),
                          b_regularizer=regs(jreg)))
          .add(jnn.ReLU())
          .add(jnn.Linear(6, 2, w_regularizer=regs(jreg))))
    jm.reset(jax.random.PRNGKey(0))
    pm = (pnn.Sequential()
          .add(pnn.Linear(4, 6, w_regularizer=regs(preg),
                          b_regularizer=regs(preg), device="cpu"))
          .add(pnn.ReLU())
          .add(pnn.Linear(6, 2, w_regularizer=regs(preg), device="cpu")))
    params_from_jax(_np_tree(jm), pm)
    ref = jax_regularization_penalty(jm, jm.params)
    out = regularization_penalty(pm)
    np.testing.assert_allclose(out.item(), float(ref), atol=ATOL, rtol=RTOL)
    assert regularization_penalty(pnn.Sequential().add(
        pnn.Linear(4, 2, device="cpu"))) is None


def test_lookup_table_regularizer_matches_jax():
    jm = jnn.LookupTable(10, 4, w_regularizer=jreg.L2Regularizer(0.5))
    jm.reset(jax.random.PRNGKey(1))
    pm = pnn.LookupTable(10, 4, w_regularizer=preg.L2Regularizer(0.5),
                         device="cpu")
    params_from_jax(_np_tree(jm), pm)
    np.testing.assert_allclose(
        regularization_penalty(pm).item(),
        float(jax_regularization_penalty(jm, jm.params)), rtol=RTOL)


# --------------------------------------------- end to end: optimize()

@pytest.fixture(scope="module")
def lms():
    """The tiny LM in both packages, built once; its initial weights."""
    jm = jax_lm(VOCAB, d_model=D_MODEL, n_head=N_HEAD, n_layers=N_LAYERS,
                max_len=SEQ)
    jm.reset(jax.random.PRNGKey(0))
    init = _np_tree(jm)
    pm = transformer_lm(VOCAB, d_model=D_MODEL, n_head=N_HEAD,
                        n_layers=N_LAYERS, max_len=SEQ, flash=True,
                        device="cpu")
    return jm, pm, init


@pytest.fixture(scope="module")
def lm_rows():
    ids = np.random.default_rng(5).integers(
        1, VOCAB + 1, (N_SAMPLES, SEQ + 1)).astype(np.float32)
    return ids[:, :-1], ids[:, 1:]


def _train_both(lms, lm_rows, make_method, seed=11):
    jm, pm, init = lms
    jm.params = jax.tree_util.tree_map(jnp.asarray, init)
    jm._adopt()
    params_from_jax(init, pm)
    x, y = lm_rows
    results = []
    with seeded(seed):
        for model, mod, nn_mod, sample, lds, s2b in (
                (jm, joptim, jnn, JaxSample, JaxLocalDataSet,
                 JaxSampleToMiniBatch),
                (pm, poptim, pnn, Sample, LocalDataSet, SampleToMiniBatch)):
            ds = lds([sample(x[i], y[i]) for i in range(N_SAMPLES)]
                     ).transform(s2b(BATCH))
            crit = nn_mod.TimeDistributedCriterion(nn_mod.ClassNLLCriterion(),
                                                   size_average=True)
            kw = {} if mod is joptim else {"device": "cpu"}
            opt = mod.Optimizer.create(model, ds, crit, **kw)
            opt.set_optim_method(make_method(mod))
            opt.set_end_when(mod.max_iteration(STEPS))
            opt.optimize()
            results.append(opt)
    return results


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


# ------------------------------------------------- the divergence guard

def _mlp(mod, **kw):
    return (mod.Sequential().add(mod.Linear(4, 8, **kw)).add(mod.ReLU())
            .add(mod.Linear(8, 3, **kw)).add(mod.LogSoftMax()))


def _guard_run(n_steps, nan_rows):
    """Train the same small MLP in both packages on 8 rows (batches of 4)
    whose ``nan_rows`` hold a NaN feature; returns the initial and trained
    weights of each, as numpy trees (JAX, port)."""
    jm = _mlp(jnn)
    jm.reset(jax.random.PRNGKey(3))
    init = _np_tree(jm)
    pm = params_from_jax(init, _mlp(pnn, device="cpu"))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    x[nan_rows, 1] = np.nan
    y = rng.integers(1, 4, 8).astype(np.float32)
    with seeded(12):
        for model, mod, nn_mod, sample, lds, kw in (
                (jm, joptim, jnn, JaxSample, JaxLocalDataSet, {}),
                (pm, poptim, pnn, Sample, LocalDataSet, {"device": "cpu"})):
            ds = lds([sample(x[i], y[i]) for i in range(8)])
            opt = mod.Optimizer.create(model, ds, nn_mod.ClassNLLCriterion(),
                                       batch_size=4, **kw)
            opt.set_optim_method(mod.SGD(learning_rate=0.1, momentum=0.9))
            opt.set_end_when(mod.max_iteration(n_steps))
            opt.optimize()
    return init, _np_tree(jm), params_to_jax(pm)


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


# ----------------------------------------------------- entry points

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
