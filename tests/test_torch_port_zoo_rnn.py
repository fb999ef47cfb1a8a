"""The rest of the port's model zoo (the RNN and LSTM language models, the
autoencoder, the text classifier and the TreeLSTM sentiment classifier) and
its train drivers, held against the JAX package's on the CPU.

Each builder is built in both packages, the JAX parameter tree filled from
a numpy seed (shapes from ``jax.eval_shape``) and carried into the port
with ``params_from_jax``; inputs come from numpy seeds.

Tolerances, each stated beside its case:
- parameter shapes: equal, tree for tree;
- eval forwards in fp32: atol 1e-5 (the text classifier's 1000-step
  convolutions: 1e-4);
- 3 Adagrad steps (``lstm_lm`` and ``tree_lstm_sentiment``, the drivers'
  Adagrad settings) through the port's ``LocalOptimizer`` against the JAX
  package's, both in fp32 from the same weights and batches: losses within
  rtol 1e-5, trained weights within atol 1e-5;
- the bf16 ``mixed_precision_forward`` of ``lstm_lm`` against the JAX
  package's: log-probs within atol 0.0625, two bf16 steps at magnitudes
  4 to 8 (bf16 keeps 8 significant bits, and each package rounds its bf16
  intermediates at its own places: GEMM epilogues here, separate adds
  there).  Over seeds 12-15 the distance was 0.016-0.031, and the port's
  fp32 forward was 0.016-0.018 from the JAX package's bf16 one.

The drivers' ``main`` run with ``--device cpu --synthetic`` for two
epochs: finite losses, a validation result each epoch.
"""

import contextlib
import logging

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
from bigdl_tpu.models.autoencoder import autoencoder as jax_autoencoder
from bigdl_tpu.models.rnn import lstm_lm as jax_lstm_lm
from bigdl_tpu.models.rnn import simple_rnn as jax_simple_rnn
from bigdl_tpu.models.textclassifier import \
    text_classifier as jax_text_classifier
from bigdl_tpu.models.treelstm import \
    tree_lstm_sentiment as jax_tree_lstm_sentiment
from bigdl_tpu.optim.optimizer import \
    mixed_precision_forward as jax_mixed_precision_forward
from bigdl_tpu.utils.random_generator import \
    RandomGenerator as JaxRandomGenerator
import bigdl_tpu_torch.nn as pnn
import bigdl_tpu_torch.optim as poptim
from bigdl_tpu_torch.dataset import LocalDataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.models import (autoencoder, lstm_lm, simple_rnn,
                                    text_classifier, tree_lstm_sentiment)
from bigdl_tpu_torch.models.autoencoder import train as ae_train
from bigdl_tpu_torch.models.rnn import train as rnn_train
from bigdl_tpu_torch.models.textclassifier import train as tc_train
from bigdl_tpu_torch.models.treelstm import train as tree_train
from bigdl_tpu_torch.optim.optimizer import mixed_precision_forward
from bigdl_tpu_torch.utils import config as pconfig
from bigdl_tpu_torch.utils.convert import params_from_jax, params_to_jax
from bigdl_tpu_torch.utils.random_generator import RandomGenerator

VOCAB, HIDDEN, STEPS = 12, 8, 6
TREE_D, TREE_H, TREE_CLASSES, LEAVES = 5, 6, 3, 6


def numpy_params(jm, seed):
    """``jm``'s parameter tree from a numpy seed, float32: weights uniform
    at variance 1/fan_in (2-D (in, out): fan_in = in; 4-D HWIO: H*W*I),
    vectors U(-0.1, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(s):
        shape = s.shape
        if len(shape) >= 2:
            fan_in = np.prod(shape[:3]) if len(shape) == 4 else shape[0]
            bound = np.sqrt(3.0 / fan_in)
        else:
            bound = 0.1
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    return jax.tree_util.tree_map(
        draw, jax.eval_shape(jm._init_params, jax.random.PRNGKey(0)))


def pair(jm, pm, seed=0, install=False):
    """The JAX tree from ``seed``, carried into the port model; with
    ``install``, also given to the JAX model (its trainer reads it
    there)."""
    params = numpy_params(jm, seed)
    if install:
        jm._params = jax.tree_util.tree_map(jnp.asarray, params)
        jm._state = jm._init_state()
        jm._grads = jax.tree_util.tree_map(jnp.zeros_like, jm._params)
        jm._adopt()
    params_from_jax(params, pm)
    return params


def one_hot_batch(b, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, size=(b, STEPS))
    x = np.eye(VOCAB, dtype=np.float32)[ids]
    y = (rng.integers(0, VOCAB, size=(b, STEPS)) + 1).astype(np.float32)
    return x, y


def trees(b, seed):
    """``b`` rows of leaf vectors and trees over LEAVES leaves, alternately
    left-leaning and balanced-then-left, one row with its first internal
    nodes as -1 padding (its root stays last)."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(b, LEAVES, TREE_D)).astype(np.float32)
    left = [[0, 1]] + [[LEAVES + j, j + 2] for j in range(LEAVES - 2)]
    bal = [[0, 1], [2, 3], [4, 5], [6, 7], [9, 8]]
    pad = [[-1, -1], [-1, -1], [0, 1], [LEAVES + 2, 2], [LEAVES + 3, 3]]
    t = np.asarray([[left, bal, pad][i % 3] for i in range(b)], np.int32)
    y = (rng.integers(0, TREE_CLASSES, size=(b,)) + 1).astype(np.float32)
    return emb, t, y


BUILDERS = {
    "simple_rnn": (lambda: jax_simple_rnn(VOCAB, HIDDEN, VOCAB),
                   lambda: simple_rnn(VOCAB, HIDDEN, VOCAB, device="cpu"),
                   lambda: one_hot_batch(3, 1)[0]),
    "lstm_lm": (lambda: jax_lstm_lm(VOCAB, HIDDEN, VOCAB),
                lambda: lstm_lm(VOCAB, HIDDEN, VOCAB, device="cpu"),
                lambda: one_hot_batch(3, 2)[0]),
    "autoencoder": (lambda: jax_autoencoder(16),
                    lambda: autoencoder(16, device="cpu"),
                    lambda: np.random.default_rng(3).uniform(
                        size=(3, 28, 28)).astype(np.float32)),
    "text_classifier": (lambda: jax_text_classifier(20),
                        lambda: text_classifier(20, device="cpu"),
                        lambda: np.random.default_rng(4).normal(
                            size=(2, 1000, 200)).astype(np.float32)),
    "tree_lstm_sentiment": (
        lambda: jax_tree_lstm_sentiment(TREE_D, TREE_H, TREE_CLASSES),
        lambda: tree_lstm_sentiment(TREE_D, TREE_H, TREE_CLASSES,
                                    device="cpu"),
        lambda: list(trees(3, 5)[:2])),
}


def port_shapes(module):
    """The port's parameter tree in the JAX layout, as shapes, without the
    channels-last boundary modules (the JAX builders have none)."""
    if isinstance(module, pnn.Container):
        return [port_shapes(c) for c in module.layers
                if not isinstance(c, (pnn.NCHWToNHWC, pnn.NHWCToNCHW))]
    return jax.tree_util.tree_map(np.shape, params_to_jax(module))


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_matches_jax(name):
    """Parameter shapes equal the JAX package's, tree for tree, and the
    eval forward matches it."""
    make_jax, make_port, make_input = BUILDERS[name]
    jm, pm = make_jax(), make_port()
    shapes = jax.tree_util.tree_map(
        lambda s: tuple(s.shape),
        jax.eval_shape(jm._init_params, jax.random.PRNGKey(0)))
    assert port_shapes(pm) == shapes
    params = pair(jm, pm, seed=6)
    x = make_input()
    jx = [jnp.asarray(a) for a in x] if isinstance(x, list) else \
        jnp.asarray(x)
    ref, _ = jax.jit(lambda p, x: jm.apply(p, x, jm._init_state()))(
        params, jx)
    with torch.inference_mode():
        out = pm.eval()([torch.from_numpy(a) for a in x]
                        if isinstance(x, list) else torch.from_numpy(x))
    assert out.shape == ref.shape
    atol = 1e-4 if name == "text_classifier" else 1e-5
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol,
                               rtol=0)


def test_text_classifier_is_channels_last_behind_its_facade():
    m = text_classifier(20, device="cpu")
    assert isinstance(m.layers[2], pnn.NCHWToNHWC)
    assert text_classifier(20, layout="NCHW", device="cpu").layers[2]. \
        __class__ is pnn.SpatialConvolution


@contextlib.contextmanager
def seeded(seed):
    """Both packages' thread-local RandomGenerator seeded with ``seed``;
    the previous ones are put back after."""
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
    def __init__(self):
        self.losses = []

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.losses.append(float(value))


def train(model, features, labels, criterion, package, lr=0.1,
          decay=0.001, batch=4, steps=3):
    """``steps`` of Adagrad(lr, decay) through
    ``Optimizer.create(...).optimize()``; the per-step losses."""
    jax_side = package == "jax"
    optim = joptim if jax_side else poptim
    sample, lds, s2b = ((JaxSample, JaxLocalDataSet, JaxSampleToMiniBatch)
                        if jax_side else
                        (Sample, LocalDataSet, SampleToMiniBatch))
    ds = lds([sample(f, y) for f, y in zip(features, labels)]).transform(
        s2b(batch))
    kw = {} if jax_side else {"device": "cpu"}
    opt = optim.Optimizer.create(model, ds, criterion, **kw)
    opt.set_optim_method(optim.Adagrad(learning_rate=lr,
                                       learning_rate_decay=decay))
    opt.set_end_when(optim.max_iteration(steps))
    summary = _Losses()
    if jax_side:
        opt.set_train_summary(summary)
    with seeded(7):
        opt.optimize()
    return summary.losses if jax_side else [h["loss"] for h in opt.history]


def assert_trajectory(jm, pm, params, ref_losses, losses):
    assert len(losses) == len(ref_losses) == 3
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    trained = params_to_jax(pm)
    moved = 0.0
    for p, j, p0 in zip(jax.tree_util.tree_leaves(trained),
                        jax.tree_util.tree_leaves(jm.params),
                        jax.tree_util.tree_leaves(params)):
        np.testing.assert_allclose(p, np.asarray(j), atol=1e-5, rtol=0)
        moved = max(moved, float(np.abs(p - p0).max()))
    assert moved > 1e-2


def test_lstm_lm_trajectory_matches_jax():
    """The rnn driver's training: Adagrad(0.1, decay 0.001) and
    ``TimeDistributedCriterion(ClassNLL, size_average=True)``, 3 steps at
    B4 over 8 sequences (the third step starts a second epoch)."""
    jm = jax_lstm_lm(VOCAB, HIDDEN, VOCAB)
    pm = lstm_lm(VOCAB, HIDDEN, VOCAB, device="cpu")
    params = pair(jm, pm, seed=8, install=True)
    x, y = one_hot_batch(8, 9)
    ref = train(jm, x, y, jnn.TimeDistributedCriterion(
        jnn.ClassNLLCriterion(), size_average=True), "jax")
    got = train(pm, x, y, pnn.TimeDistributedCriterion(
        pnn.ClassNLLCriterion(), size_average=True), "port")
    assert_trajectory(jm, pm, params, ref, got)


def test_tree_lstm_trajectory_matches_jax():
    """The treelstm driver's training: Adagrad(0.1), ClassNLL, 3 steps at
    B4 over 8 trees, padded rows among them."""
    jm = jax_tree_lstm_sentiment(TREE_D, TREE_H, TREE_CLASSES)
    pm = tree_lstm_sentiment(TREE_D, TREE_H, TREE_CLASSES, device="cpu")
    params = pair(jm, pm, seed=10, install=True)
    emb, t, y = trees(8, 11)
    features = [[e, tr] for e, tr in zip(emb, t)]
    ref = train(jm, features, y, jnn.ClassNLLCriterion(), "jax", decay=0.0)
    got = train(pm, features, y, pnn.ClassNLLCriterion(), "port",
                decay=0.0)
    assert_trajectory(jm, pm, params, ref, got)


def test_lstm_lm_bf16_forward_matches_jax():
    jm = jax_lstm_lm(VOCAB, HIDDEN, VOCAB)
    pm = lstm_lm(VOCAB, HIDDEN, VOCAB, device="cpu")
    params = pair(jm, pm, seed=12)
    x, _ = one_hot_batch(3, 13)
    ref, _ = jax.jit(lambda p, x: jax_mixed_precision_forward(
        jm, p, x, jm._init_state(), "bf16", False, None))(
            params, jnp.asarray(x))
    with torch.inference_mode():
        out = mixed_precision_forward(pm, torch.from_numpy(x), "bf16")
    assert out.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    # the hidden state followed the bf16 weights
    assert pm.layers[0].get_hidden_state()[0].dtype == torch.bfloat16
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=0.0625,
                               rtol=0)


@pytest.fixture
def driver_logging(tmp_path):
    """The drivers' logging bootstrap writes under ``tmp_path``; the
    port's logger and config are put back after."""
    lg = logging.getLogger("bigdl_tpu_torch")
    saved = (list(lg.handlers), lg.level, lg.propagate)
    key = "bigdl.utils.LoggerFilter.logFile"
    had, old = key in pconfig._OVERRIDES, pconfig._OVERRIDES.get(key)
    pconfig.set_property(key, str(tmp_path / "bigdl.log"))
    try:
        yield
    finally:
        if had:
            pconfig.set_property(key, old)
        else:
            pconfig.clear_property(key)
        for h in lg.handlers:
            if h not in saved[0]:
                h.close()
        lg.handlers, lg.level, lg.propagate = saved


@pytest.mark.parametrize("main,argv,metric", [
    (rnn_train.main, ["--synthetic", "40", "-b", "12", "--hidden", "8",
                      "--cell", "rnn"], "Loss"),
    (rnn_train.main, ["--synthetic", "40", "-b", "12", "--hidden", "8",
                      "--cell", "lstm"], "Loss"),
    (ae_train.main, ["--synthetic", "32", "-b", "12", "--bottleneck", "8"],
     "Loss"),
    (tc_train.main, ["--synthetic", "20", "-b", "6"], "Top1Accuracy"),
    (tree_train.main, ["--synthetic", "32", "-b", "12", "--hidden", "8"],
     "Top1Accuracy"),
], ids=["rnn", "lstm", "autoencoder", "textclassifier", "treelstm"])
def test_driver_trains_on_the_cpu(main, argv, metric, driver_logging):
    """Two epochs of at least two iterations: finite losses and a
    validation result after each epoch."""
    with seeded(14):
        opt = main(argv + ["-e", "2", "--device", "cpu"])
    assert len(opt.history) >= 4
    assert all(np.isfinite(h["loss"]) for h in opt.history)
    assert [v["epoch"] for v in opt.validation_history] == [2, 3]
    assert all(np.isfinite(v[metric]) for v in opt.validation_history)


def test_treelstm_driver_needs_synthetic(driver_logging):
    with pytest.raises(SystemExit, match="SST corpus parsing"):
        tree_train.main(["--device", "cpu"])


def test_drivers_asked_for_cuda_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for main in (rnn_train.main, ae_train.main, tc_train.main,
                 tree_train.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--synthetic", "8"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lstm_lm(VOCAB, HIDDEN, VOCAB)
