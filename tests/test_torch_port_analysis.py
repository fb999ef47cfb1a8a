"""The port's runtime analysis passes, ``optim/metrics.py`` and ``LBFGS``
held against the JAX package, on the CPU.

Each case builds the JAX object and its port twin with the same arguments,
the same inputs from a numpy seed, and compares them:

- the host-sync guard (``analysis/hostsync.py``): the same verdict (raise,
  count or free) for each of eight conversions in each of the three modes
  (JAX arrays on its CPU backend, CPU tensors here: an unscoped guard
  reports every tensor, as the JAX one reports every array); ``host_pull``,
  ``allow_host_sync``, thread locality; the hot loop of ``LocalOptimizer``
  under strict: clean in both, a stray ``float()`` in a fetch transformer
  raises in both, and ``Analysis/retraces`` and
  ``Analysis/implicit_host_syncs`` reach TrainSummary with equal values;
- the recompile sentinel (``analysis/retrace.py``): equal diff lines for
  the same shape and dtype drift on numpy inputs, and the same retrace
  count for an uneven last batch through ``LocalOptimizer``;
- the lock witness (``analysis/lockwitness.py``): a two-lock cycle raises
  ``LockOrderViolation`` with the same edges, consistent orders stay
  clean, and ``bigdl.chaos.lockDelayAt`` stalls the named acquisition;
- the contract checker (``analysis/contracts.py``): the same violations
  (kind and container path) from the same model and input;
- ``Metrics``: the same ``summary()`` text for the same adds, and tensors
  parked without a sync under a strict guard;
- ``LBFGS``: the quadratic with and without the line search (``x`` and
  the losses within rtol 1e-5), and the trainer path from the same
  parameters (each iteration's loss and the final parameters within rtol
  1e-4 / atol 1e-5).

``port_lock_witness`` arms the port's lock witness strict around every
test of the files that import it (the port's threaded test files): the
JAX package's witness is the conftest's, and the two never share a lock.
Every config key a test sets is put back in both packages.
"""

import contextlib
import itertools
import logging
import operator

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.analysis import contracts as jcontracts
from bigdl_tpu.analysis import hostsync as jhostsync
from bigdl_tpu.dataset import LocalDataSet as JaxLocalDataSet
from bigdl_tpu.dataset import Sample as JaxSample
from bigdl_tpu.dataset import SampleToMiniBatch as JaxSampleToMiniBatch
from bigdl_tpu.optim.optimizer import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.utils import config as jconfig
from bigdl_tpu.utils.random_generator import \
    RandomGenerator as JaxRandomGenerator
import bigdl_tpu_torch.nn as pnn
import bigdl_tpu_torch.optim as poptim
from bigdl_tpu_torch.analysis import contracts as pcontracts
from bigdl_tpu_torch.analysis import hostsync as phostsync
from bigdl_tpu_torch.analysis import lockwitness as pwitness
from bigdl_tpu_torch.dataset import LocalDataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.optim.optimizer import LocalOptimizer
from bigdl_tpu_torch.utils import config as pconfig
from bigdl_tpu_torch.utils.convert import params_from_jax
from bigdl_tpu_torch.utils.random_generator import RandomGenerator

#: the passes' modes
MODES = ("strict", "warn", "off")


@pytest.fixture(autouse=True)
def port_lock_witness():
    """The port's lock witness armed strict for the test: an acquisition
    that closes a cycle in the port's acquisition-order graph raises
    ``LockOrderViolation`` before it blocks.  The graph and counters are
    dropped after, so one test's order never poisons another's."""
    pwitness.arm("strict")
    try:
        yield
    finally:
        pwitness.disarm()
        pwitness.reset()


@contextlib.contextmanager
def properties(**keys):
    """Set ``bigdl.*`` keys (dots as ``__``) in both packages; put every
    one back after."""
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
        for mod, name, had, value in reversed(saved):
            if had:
                mod.set_property(name, value)
            else:
                mod.clear_property(name)


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


def _guard(pkg, mode):
    return pkg.HostSyncGuard(mode) if mode != "off" else pkg.NULL_GUARD


# ---------------------------------------------------------------------------
# the host-sync guard
# ---------------------------------------------------------------------------

#: name -> (the JAX conversion, the port's); a JAX array has no ``numpy``
#: method, and ``np.asarray`` of one reads its buffer without the hooked
#: ``__array__``: both port conversions pair with its ``__array__()``
CONVERSIONS = {
    "__float__": (float, float),
    "__int__": (int, int),
    "__bool__": (bool, bool),
    "__index__": (operator.index, operator.index),
    "item": (lambda x: x.item(), lambda t: t.item()),
    "tolist": (lambda x: x.tolist(), lambda t: t.tolist()),
    "numpy": (lambda x: x.__array__(), lambda t: t.numpy()),
    "__array__": (lambda x: x.__array__(), lambda t: t.__array__()),
}


def _verdict(pkg, guard, convert, value):
    before = pkg.STATS.snapshot()["implicit"]
    try:
        with guard.armed():
            convert(value)
    except pkg.HostSyncError:
        return "raise"
    return "count" if pkg.STATS.snapshot()["implicit"] > before else "free"


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(CONVERSIONS))
def test_conversion_verdicts_match_jax(name, mode, caplog):
    jconv, pconv = CONVERSIONS[name]
    caplog.set_level(logging.ERROR)       # warn mode logs once per site
    got = [_verdict(jhostsync, _guard(jhostsync, mode), jconv,
                    jnp.ones((), jnp.int32)),
           _verdict(phostsync, _guard(phostsync, mode), pconv,
                    torch.ones((), dtype=torch.int32))]
    assert got[0] == got[1] == {"strict": "raise", "warn": "count",
                                "off": "free"}[mode], got


def test_strict_report_names_the_call_site_and_the_fix():
    guard = phostsync.HostSyncGuard("strict")
    with guard.armed():
        with pytest.raises(phostsync.HostSyncError) as ei:
            float(torch.ones(()) * 3)
    msg = str(ei.value)
    assert "__float__" in msg and "host_pull" in msg
    assert "test_torch_port_analysis.py:" in msg     # the offending line


# -- the trainers' hot loop --------------------------------------------------

class _Capture:
    def __init__(self):
        self.tags = {}

    def add_scalar(self, tag, value, step):
        self.tags.setdefault(tag, []).append(value)
        return self

    def save_parameters_due(self, state):
        return False


def _mlp(mod, **kw):
    return (mod.Sequential().add(mod.Linear(4, 8, **kw)).add(mod.Tanh())
            .add(mod.Linear(8, 2, **kw)).add(mod.LogSoftMax()))


def _pair_trainers(n=16, batch=8, iters=3, seed=0, poison=None,
                   ragged=False):
    """The same MLP, data and SGD in both packages (``poison``: a stray
    pull in each fetch, as a fetch transformer would make it; ``ragged``:
    each epoch's batches as a finite pass makes them, the last one short,
    which the looped training iterator never yields by itself)."""
    rng = np.random.RandomState(seed)
    xs = rng.randn(n, 4).astype(np.float32)
    ys = (1 + np.arange(n) % 2).astype(np.float32)
    jm = _mlp(jnn)
    jm.reset(jax.random.PRNGKey(seed))
    pm = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                         _mlp(pnn, device="cpu"))
    jopt = JaxLocalOptimizer(
        jm, JaxLocalDataSet([JaxSample(x, np.array([y])) for x, y in
                             zip(xs, ys)]).transform(
            JaxSampleToMiniBatch(batch)), jnn.ClassNLLCriterion())
    popt = LocalOptimizer(
        pm, LocalDataSet([Sample(x, np.array([y])) for x, y in
                          zip(xs, ys)]).transform(SampleToMiniBatch(batch)),
        pnn.ClassNLLCriterion(), device="cpu")
    for opt, mod, pull in ((jopt, joptim, lambda: float(jnp.asarray(1.0))),
                           (popt, poptim, lambda: float(torch.ones(())))):
        opt.set_optim_method(mod.SGD(learning_rate=0.1))
        opt.set_end_when(mod.max_iteration(iters))
        if ragged:
            batcher = (JaxSampleToMiniBatch if mod is joptim
                       else SampleToMiniBatch)(batch)
            batches = list(batcher(iter(opt.dataset.records)))
            opt.dataset.data = (lambda *a, _b=batches, **kw:
                                itertools.cycle(_b))
        if poison:
            orig = opt.dataset.data

            def poisoned(*a, _orig=orig, _pull=pull, **kw):
                for batch in _orig(*a, **kw):
                    _pull()                  # a device pull in the fetch
                    yield batch

            opt.dataset.data = poisoned
    return jopt, popt


# ---------------------------------------------------------------------------
# the recompile sentinel
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the lock witness
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the contract checker
# ---------------------------------------------------------------------------

def _convnet(mod, **kw):
    return (mod.Sequential()
            .add(mod.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1, **kw))
            .add(mod.ReLU())
            .add(mod.SpatialMaxPooling(2, 2, 2, 2))
            .add(mod.View(8 * 4 * 4))
            .add(mod.Linear(8 * 16, 10, **kw)))


def _zeros(jm):
    """Install zero parameters and state of the JAX model's shapes (from
    ``jax.eval_shape``; its own init compiles a random draw per shape, and
    the walk reads shapes only)."""
    def zeros(tree):
        return jax.tree_util.tree_map(
            lambda sd: jnp.zeros(sd.shape, sd.dtype), tree)
    jm._params = zeros(jax.eval_shape(jm._init_params,
                                      jax.random.PRNGKey(0)))
    jm._state = zeros(jax.eval_shape(jm._init_state))
    jm._grads = jm._params
    if hasattr(jm, "_adopt"):
        jm._adopt()
    return jm


def _both(build):
    """(JAX model with zero parameters, port model) from
    ``build(mod, **kw)``."""
    return _zeros(build(jnn)), build(pnn, device="cpu")


def _violations(rep):
    return [(v.kind, v.module) for v in rep.violations]


def _check_both(models, x, **kw):
    jm, pm = models
    jrep = jcontracts.check_model(jm, jnp.asarray(x), mode="off", **kw)
    prep = pcontracts.check_model(pm, x, mode="off", **kw)
    assert _violations(jrep) == _violations(prep), (str(jrep), str(prep))
    assert jrep.ok == prep.ok
    return jrep, prep


def _jax_pin():
    class F32Pin(jnn.Module):
        layout_role = "agnostic"

        def apply(self, params, input, state, training=False, rng=None):
            return input + jnp.ones(input.shape[-1:], jnp.float32), state
    return F32Pin()


def _port_pin():
    class F32Pin(pnn.Module):
        layout_role = "agnostic"

        def forward(self, input):
            return input + torch.ones(input.shape[-1:], dtype=torch.float32,
                                      device=input.device)
    return F32Pin()


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# LBFGS
# ---------------------------------------------------------------------------
