"""The port's data-parallel trainer held against the JAX package, on the CPU:
``DistriOptimizer``, ``ShardedDataSet``, ``SampleToMiniBatch``'s partition
split, ``AllReduceParameter`` and ``Engine``'s topology.

Ranks.  One module-scoped spawn runs every rank leg: a worker script written
to ``tmp_path`` (it imports ``torch`` and ``bigdl_tpu_torch`` only) is run
with ``sys.executable`` as two ranks joined over gloo on a ``file://`` store.
Each rank writes its results to an ``.npz``.  The models reach the workers
pickled, with the JAX package's initial weights (``params_from_jax``).  While
the workers run, this process trains the same models with the JAX package's
``DistriOptimizer`` on a 2-device mesh (``jax.devices()[:2]``) over
``ShardedDataSet(samples, 2)``, so that both packages see the same partition
batches.  A worker that fails stops both; each has a hard timeout and is
killed on a hang.

Legs: the reference test's MLP (``tests/test_distri_optimizer.py:27-34``)
and its conv + BatchNorm model (:255-276, NCHW) under SGD with momentum, 6
steps, in both schedules (``bigdl.parallel.overlap``); the MLP under Adam
(the sharded slots); the tiny transformer LM of
``tests/test_torch_port_training.py`` (the port with ``flash=True`` on its
plain path, the JAX package with ``flash=False``); then the port against
itself: dp=2 against ``LocalOptimizer``, the divergence guard, Dropout
masks, a second ``optimize()`` resuming from the published slots,
``compression="bf16"`` and ``models/perf.py --partitions 2``.

Tolerances:
- the MLP and the conv + BN model against the JAX package and against
  ``LocalOptimizer``: rtol 2e-4, atol 2e-5 on losses, weights, slots and
  statistics, as the reference's own test (``test_distri_optimizer.py:111``);
- the MLP under Adam: atol 1e-4, rtol 1e-3 (Adam's step is about lr
  whatever the gradient's size, so fp32 rounding of small gradients in the
  two frameworks shows in the weights);
- the tiny LM: atol 1e-5 on weights and slots, rtol 1e-5 on losses, as the
  port's ``LocalOptimizer`` test of the same model;
- the bucketed and the one-block schedules, the ranks' weights, the
  divergence guard and a resumed run: bit-identical.
"""

import contextlib
import copy
import logging
import math
import os
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset import SampleToMiniBatch as JaxSampleToMiniBatch
from bigdl_tpu.dataset.dataset import ShardedDataSet as JaxShardedDataSet
from bigdl_tpu.dataset.datasets import synthetic_separable
from bigdl_tpu.dataset.sample import Sample as JaxSample
from bigdl_tpu.engine import Engine as JaxEngine
from bigdl_tpu.models.transformer import transformer_lm as jax_lm
from bigdl_tpu.parallel import AllReduceParameter as JaxAllReduceParameter
from bigdl_tpu.parallel import DistriOptimizer as JaxDistriOptimizer
from bigdl_tpu.utils import config as jconfig
from bigdl_tpu.utils.random_generator import \
    RandomGenerator as JaxRandomGenerator
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu_torch.dataset import (LocalDataSet, Sample, SampleToMiniBatch,
                                     ShardedDataSet)
from bigdl_tpu_torch.engine import Engine, allgather_sum
from bigdl_tpu_torch.models.transformer import transformer_lm
from bigdl_tpu_torch.optim import (SGD, LocalOptimizer, Optimizer,
                                   max_iteration)
from bigdl_tpu_torch.parallel import AllReduceParameter, DistriOptimizer
from bigdl_tpu_torch.utils import config as pconfig
from bigdl_tpu_torch.utils.convert import (params_from_jax, params_to_jax,
                                           state_to_jax)
from bigdl_tpu_torch.utils.random_generator import RandomGenerator
from tests.test_e2e_train import synthetic_digit_images

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 17
RTOL, ATOL = 2e-4, 2e-5
VOCAB, D_MODEL, N_HEAD, N_LAYERS, SEQ = 64, 256, 2, 2, 128
WORKER_TIMEOUT = 420.0      # seconds for both ranks, then they are killed


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


# ----------------------------------------------------------------- models

def _mlp(mod, n_out=2, **kw):
    return (mod.Sequential().add(mod.Linear(4, 16, **kw)).add(mod.Tanh())
            .add(mod.Linear(16, n_out, **kw)).add(mod.LogSoftMax()))


def _conv_bn(mod, **kw):
    return (mod.Sequential()
            .add(mod.Reshape((1, 8, 8)))
            .add(mod.SpatialConvolution(1, 4, 3, 3, 1, 1, 1, 1, **kw))
            .add(mod.SpatialBatchNormalization(4, **kw))
            .add(mod.ReLU())
            .add(mod.Reshape((4 * 8 * 8,)))
            .add(mod.Linear(4 * 8 * 8, 2, **kw))
            .add(mod.LogSoftMax()))


def _twins(build, seed):
    """The JAX model from ``PRNGKey(seed)`` and its port twin on the CPU
    with the same initial weights."""
    jm = build(jnn)
    jm.reset(jax.random.PRNGKey(seed))
    pm = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                         build(pnn, device="cpu"))
    return jm, pm


def _port_samples(jax_samples):
    return [Sample(s.features[0], s.labels[0]) for s in jax_samples]


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


# ---------------------------------------------------------- the workers

_WORKER = textwrap.dedent(r'''
    import copy, os, sys
    repo, store, outdir, rank = sys.argv[1:5]
    rank = int(rank)
    sys.path.insert(0, repo)
    import numpy as np
    import torch
    torch.set_num_threads(2)
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, ShardedDataSet
    from bigdl_tpu_torch.engine import Engine, allgather_sum
    from bigdl_tpu_torch.models import perf
    from bigdl_tpu_torch.optim import SGD, Adam, Optimizer, max_iteration
    from bigdl_tpu_torch.optim.optimizer import module_state
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from bigdl_tpu_torch.utils import config
    from bigdl_tpu_torch.utils.convert import params_to_jax, state_to_jax
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    Engine.init_distributed(init_method="file://" + store, rank=rank,
                            world_size=2, device="cpu")
    inp = torch.load(os.path.join(outdir, "inputs.pt"), weights_only=False)
    SEED = inp["seed"]
    out = {"node_number": np.array(Engine.node_number()),
           "allgather_sum": allgather_sum([rank + 1.0, 2.0])}

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for t in tree for x in leaves(t)]
        return [tree]

    def keep(prefix, tree):
        for i, x in enumerate(leaves(tree)):
            out[f"{prefix}{i}"] = np.asarray(x)

    def as_jax(model, tensors):
        """Tensors shaped as the model's parameters, in the JAX layout."""
        params = list(model.parameters())
        saved = [p.detach().clone() for p in params]
        with torch.no_grad():
            for p, t in zip(params, tensors):
                p.copy_(t)
            tree = params_to_jax(model)
            for p, s in zip(params, saved):
                p.copy_(s)
        return tree

    def record(leg, opt, model):
        out[f"{leg}/loss"] = np.array([h["loss"] for h in opt.history])
        keep(f"{leg}/p", params_to_jax(model))
        keep(f"{leg}/s", state_to_jax(model))
        for fam, ts in opt.optim_method._slots.items():
            keep(f"{leg}/{fam}", as_jax(model, ts))

    def run(leg, key, samples, batch, steps, method, crit=None,
            overlap=True, compression=None, **ds_kw):
        RandomGenerator.RNG().set_seed(SEED)
        config.set_property("bigdl.parallel.overlap", overlap)
        model = copy.deepcopy(inp[key])
        ds = ShardedDataSet(samples, 2, **ds_kw).transform(
            SampleToMiniBatch(batch, 2))
        crit = crit or nn.ClassNLLCriterion()
        if compression is None:
            opt = Optimizer.create(model, ds, crit, device="cpu")
        else:
            opt = DistriOptimizer(model, ds, crit, compression=compression,
                                  device="cpu")
        opt.set_optim_method(method).set_end_when(max_iteration(steps))
        opt.optimize()
        record(leg, opt, model)
        return opt, model

    d = inp["data"]
    for overlap, name in ((True, "bucketed"), (False, "mono")):
        run(f"mlp_{name}", "mlp", d["mlp"], 64, 6,
            SGD(0.2, momentum=0.9), overlap=overlap)
        run(f"bn_{name}", "bn", d["bn"], 32, 6,
            SGD(0.1, momentum=0.9), overlap=overlap)
    # every leg runs with the prefetcher at its default depth (2); this
    # one fetches on the training thread
    config.set_property("bigdl.prefetch.depth", 0)
    opt, _ = run("bn_depth0", "bn", d["bn"], 32, 6, SGD(0.1, momentum=0.9))
    config.clear_property("bigdl.prefetch.depth")
    out["depth0_wait_seconds"] = np.array([h["wait_seconds"]
                                      for h in opt.history])
    run("mlp_adam", "mlp", d["mlp"], 32, 6, Adam(1e-2))
    run("lm", "lm", d["lm"], 4, 3, SGD(0.01, momentum=0.9),
        crit=nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                         size_average=True))
    # every rank holds the same 16 rows: BatchNorm's statistics over a
    # rank's batch are the full batch's, as in a LocalOptimizer
    run("bn_same_rows", "bn", d["bn_rows"] * 2, 32, 4,
        SGD(0.1, momentum=0.9), global_shuffle=False)

    # the divergence guard: 2 good steps, then one whose NaN lies in rank
    # 1's rows only
    def rank_state(opt, model):
        arp = opt._arp
        row = arp.local_shard(arp.flatten(
            [p.detach() for p in model.parameters()]), rank)
        return ([row.clone()] + [v.clone() for v in opt._slot_shards.values()]
                + [b.clone() for b in module_state(model)])

    opt, model = run("guard_pre", "bn", d["bn_rows"] * 2, 32, 2,
                     SGD(0.1, momentum=0.9), global_shuffle=False)
    for i, t in enumerate(rank_state(opt, model)):
        out[f"guard/before{i}"] = t.numpy()
    ds = ShardedDataSet(d["bn_rows"] + d["bn_nan"], 2,
                        global_shuffle=False).transform(SampleToMiniBatch(32, 2))
    bad = DistriOptimizer(model, ds, nn.ClassNLLCriterion(), device="cpu")
    bad.set_optim_method(opt.optim_method).set_end_when(max_iteration(3))
    bad.optimize()
    for i, t in enumerate(rank_state(bad, model)):
        out[f"guard/after{i}"] = t.numpy()
    out["guard/loss"] = np.array([h["loss"] for h in bad.history])
    # rank 1 alone finds its step bad (all of its tensors finite): rank 0
    # must skip the step too
    import bigdl_tpu_torch.parallel.distri_optimizer as dmod
    real = dmod.all_finite
    if rank == 1:
        dmod.all_finite = lambda *trees: torch.tensor(False)
    ds = ShardedDataSet(d["bn_rows"] * 2, 2,
                        global_shuffle=False).transform(SampleToMiniBatch(32, 2))
    flag = DistriOptimizer(model, ds, nn.ClassNLLCriterion(), device="cpu")
    flag.set_optim_method(opt.optim_method).set_end_when(max_iteration(4))
    flag.optimize()
    dmod.all_finite = real
    for i, t in enumerate(rank_state(flag, model)):
        out[f"guard/flagged{i}"] = t.numpy()
    out["guard/flagged_loss"] = np.array([h["loss"] for h in flag.history])

    # Dropout: each step's mask, twice from the same weights and seed
    masks = []
    for _ in range(2):
        model = copy.deepcopy(inp["drop"])
        drop = [m for m in model.modules() if isinstance(m, nn.Dropout)][0]
        drop.register_forward_hook(
            lambda m, i, o: masks.append((o == 0).numpy().copy()))
        RandomGenerator.RNG().set_seed(SEED)
        ds = ShardedDataSet(d["mlp"], 2).transform(SampleToMiniBatch(64, 2))
        dopt = Optimizer.create(model, ds, nn.ClassNLLCriterion(),
                                device="cpu")
        dopt.set_optim_method(SGD(0.2)).set_end_when(max_iteration(2))
        dopt.optimize()
    out["drop/mask"] = np.stack(masks)

    # a second optimize() continues from the published slots
    opt, model = run("resume_first", "mlp", d["mlp"], 64, 3,
                     SGD(0.2, momentum=0.9))
    opt.set_end_when(max_iteration(6)).optimize()
    record("resume", opt, model)

    # gradients sent as bf16, against the fp32 wire
    for comp in ("bf16", None):
        run(f"sep_{comp}", "mlp3", d["sep"], 64, 96, SGD(0.5),
            compression=comp)

    opt = perf.main(["-m", "lenet5", "-b", "8", "-i", "2", "--partitions",
                     "2"], device="cpu")
    out["perf/trainer"] = np.array(type(opt).__name__)
    out["perf/loss"] = np.array([h["loss"] for h in opt.history])

    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    print("WORKER_OK", rank)
''')


def _jax_run(model, samples, batch, steps, method, crit=None, overlap=True):
    """Train ``model`` with the JAX package's DistriOptimizer on a 2-device
    mesh; its per-step losses (from the training log's records), weights,
    slots and module state."""
    mesh = JaxEngine.create_mesh((2,), ("data",), devices=jax.devices()[:2])
    ds = JaxShardedDataSet(samples, 2).transform(JaxSampleToMiniBatch(batch, 2))
    opt = JaxDistriOptimizer(model, ds, crit or jnn.ClassNLLCriterion(),
                             mesh=mesh)
    opt.set_optim_method(method)
    opt.set_end_when(joptim.max_iteration(steps))
    losses = []

    class Losses(logging.Handler):
        def emit(self, record):
            if str(record.msg).startswith("[Epoch"):
                losses.append(record.args[7])

    log = logging.getLogger("bigdl_tpu")
    handler, level = Losses(logging.INFO), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        with seeded(SEED), properties([jconfig],
                                      bigdl__parallel__overlap=overlap):
            opt.optimize()
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    return {"loss": np.array(losses), "p": _leaves(model.params),
            "s": _leaves(model.state),
            "slots": {k: _leaves(v)
                      for k, v in opt.optim_method._slots.items()}}


def _spawn(outdir):
    script = os.path.join(outdir, "worker.py")
    with open(script, "w") as f:
        f.write(_WORKER)
    store = os.path.join(outdir, "store")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs, logs = [], []
    for rank in range(2):
        log = open(os.path.join(outdir, f"rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, script, REPO, store, outdir, str(rank)],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs, logs


def _reap(procs, logs, outdir, deadline):
    """Wait for both ranks; kill both when one fails or the deadline
    passes.  Returns each rank's log."""
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        for log in logs:
            log.close()
    texts = []
    for rank in range(2):
        with open(os.path.join(outdir, f"rank{rank}.log")) as f:
            texts.append(f.read())
    return texts


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the two ranks once; meanwhile, train the JAX references.
    Returns (each rank's results, the JAX results, the inputs)."""
    outdir = str(tmp_path_factory.mktemp("distri"))
    jmlp, pmlp = _twins(_mlp, 11)
    jbn, pbn = _twins(_conv_bn, 5)
    jlm = jax_lm(VOCAB, d_model=D_MODEL, n_head=N_HEAD, n_layers=N_LAYERS,
                 max_len=SEQ)
    jlm.reset(jax.random.PRNGKey(0))
    plm = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jlm.params),
        transformer_lm(VOCAB, d_model=D_MODEL, n_head=N_HEAD,
                       n_layers=N_LAYERS, max_len=SEQ, flash=True,
                       device="cpu"))
    mlp_samples = synthetic_separable(64, 4, n_classes=2, seed=3)
    bn_samples = synthetic_digit_images(128, side=8, n_classes=2)
    ids = np.random.default_rng(5).integers(
        1, VOCAB + 1, (8, SEQ + 1)).astype(np.float32)
    lm_samples = [Sample(r[:-1], r[1:]) for r in ids]
    rows = _port_samples(synthetic_digit_images(16, side=8, n_classes=2,
                                                seed=4))
    nan_rows = copy.deepcopy(rows)
    nan_rows[4].features[0][2, 3] = np.nan
    drop = (pnn.Sequential().add(pnn.Linear(4, 16, device="cpu"))
            .add(pnn.Dropout(0.5)).add(pnn.Linear(16, 2, device="cpu"))
            .add(pnn.LogSoftMax()))
    inputs = {
        "seed": SEED, "mlp": pmlp, "bn": pbn, "lm": plm, "drop": drop,
        "mlp3": _mlp(pnn, 3, device="cpu"),
        "data": {"mlp": _port_samples(mlp_samples),
                 "bn": _port_samples(bn_samples), "lm": lm_samples,
                 "bn_rows": rows, "bn_nan": nan_rows,
                 "sep": _port_samples(synthetic_separable(512, 4, 3, seed=7))}}
    torch.save(inputs, os.path.join(outdir, "inputs.pt"))
    t0 = time.monotonic()
    procs, logs = _spawn(outdir)
    try:
        init = {k: copy.deepcopy(m) for k, m in
                (("mlp", jmlp), ("bn", jbn), ("lm", jlm))}
        ref = {}
        for overlap, name in ((True, "bucketed"), (False, "mono")):
            ref[f"mlp_{name}"] = _jax_run(copy.deepcopy(init["mlp"]),
                                          mlp_samples, 64, 6,
                                          joptim.SGD(0.2, momentum=0.9),
                                          overlap=overlap)
            ref[f"bn_{name}"] = _jax_run(copy.deepcopy(init["bn"]),
                                         bn_samples, 32, 6,
                                         joptim.SGD(0.1, momentum=0.9),
                                         overlap=overlap)
        ref["mlp_adam"] = _jax_run(copy.deepcopy(init["mlp"]), mlp_samples,
                                   32, 6, joptim.Adam(1e-2))
        jlm_samples = [JaxSample(s.feature, s.label) for s in lm_samples]
        ref["lm"] = _jax_run(
            copy.deepcopy(init["lm"]), jlm_samples, 4, 3,
            joptim.SGD(0.01, momentum=0.9),
            crit=jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(),
                                              size_average=True))
    finally:
        texts = _reap(procs, logs, outdir, t0 + WORKER_TIMEOUT)
    for rank, (p, text) in enumerate(zip(procs, texts)):
        assert p.returncode == 0 and f"WORKER_OK {rank}" in text, (
            f"rank {rank} exited {p.returncode} after "
            f"{time.monotonic() - t0:.1f} s:\n{text[-6000:]}")
    outs = []
    for rank in range(2):
        with np.load(os.path.join(outdir, f"rank{rank}.npz")) as z:
            outs.append(dict(z))
    return outs, ref, inputs


def _port(out, leg, kind):
    n = sum(1 for k in out if k.startswith(f"{leg}/{kind}") and
            k[len(leg) + 1 + len(kind):].isdigit())
    return [out[f"{leg}/{kind}{i}"] for i in range(n)]


def _assert_close(port, ref, rtol, atol, what):
    assert len(port) == len(ref) and port, what
    for i, (p, r) in enumerate(zip(port, ref)):
        np.testing.assert_allclose(p, r, rtol=rtol, atol=atol,
                                   err_msg=f"{what} leaf {i}")


def _assert_leg_matches_jax(ranks, leg, rtol, atol, loss_rtol=None):
    outs, ref, _ = ranks
    r = ref[leg]
    out = outs[0]
    np.testing.assert_allclose(out[f"{leg}/loss"], r["loss"],
                               rtol=loss_rtol or rtol, atol=atol)
    assert len(r["loss"]) == len(out[f"{leg}/loss"])
    _assert_close(_port(out, leg, "p"), r["p"], rtol, atol, f"{leg} weights")
    if r["s"]:
        _assert_close(_port(out, leg, "s"), r["s"], rtol, atol,
                      f"{leg} state")
    for fam, leaves in r["slots"].items():
        _assert_close(_port(out, leg, fam), leaves, rtol, atol,
                      f"{leg} slot {fam}")


# ------------------------------------------- against the JAX package

@pytest.mark.parametrize("schedule", ["bucketed", "mono"])
@pytest.mark.parametrize("model", ["mlp", "bn"])
def test_dp2_sgd_matches_jax(ranks, model, schedule):
    _assert_leg_matches_jax(ranks, f"{model}_{schedule}", RTOL, ATOL)
    if model == "bn":   # the running statistics moved off their init
        assert np.abs(ranks[0][0][f"bn_{schedule}/s0"]).sum() > 0


def test_dp2_adam_matches_jax(ranks):
    _assert_leg_matches_jax(ranks, "mlp_adam", 1e-3, 1e-4)


def test_dp2_tiny_lm_matches_jax(ranks):
    _assert_leg_matches_jax(ranks, "lm", 0.0, 1e-5, loss_rtol=1e-5)


# ----------------------------------------------- the port against itself

def test_dp2_prefetch_depth_does_not_change_training(ranks):
    """The legs train with the prefetcher at depth 2 (the default, its
    producer rolling the epochs over); the conv + BN leg at depth 0 gives
    the same bits on every rank."""
    outs, _, _ = ranks
    for out in outs:
        keys = [k for k in out if k.startswith("bn_bucketed/")]
        assert keys and len(out["depth0_wait_seconds"]) == 6
        for k in keys:
            np.testing.assert_array_equal(
                out[k], out[k.replace("bn_bucketed/", "bn_depth0/")],
                err_msg=k)


@pytest.mark.parametrize("model", ["mlp", "bn"])
def test_schedules_are_bit_identical(ranks, model):
    outs, _, _ = ranks
    for out in outs:
        keys = [k for k in out if k.startswith(f"{model}_bucketed/")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(
                out[k], out[k.replace("_bucketed/", "_mono/")], err_msg=k)


def test_ranks_hold_identical_weights_slots_and_statistics(ranks):
    outs, _, _ = ranks
    legs = {k.split("/")[0] for k in outs[0] if "/" in k} - {
        "guard", "drop", "perf"}
    for k in outs[0]:
        if k.split("/")[0] in legs:
            np.testing.assert_array_equal(outs[0][k], outs[1][k],
                                          err_msg=k)


def _local_run(model, samples, batch, steps, lr):
    with seeded(SEED):
        opt = LocalOptimizer(
            model, LocalDataSet(samples).transform(SampleToMiniBatch(batch)),
            pnn.ClassNLLCriterion(), device="cpu")
        opt.set_optim_method(SGD(lr, momentum=0.9))
        opt.set_end_when(max_iteration(steps)).optimize()
    return opt


@pytest.mark.parametrize("leg", ["mlp_bucketed", "bn_same_rows"])
def test_dp2_matches_local_optimizer_on_the_full_batch(ranks, leg):
    """The MLP: each rank's half of a 64-row batch against one 64-row
    batch.  The conv + BN model: BatchNorm normalises over each rank's own
    rows, so there every rank holds the same 16 rows (partition-local
    blocks) against one 16-row batch."""
    outs, _, inputs = ranks
    model = copy.deepcopy(inputs["mlp" if leg == "mlp_bucketed" else "bn"])
    if leg == "mlp_bucketed":
        opt = _local_run(model, inputs["data"]["mlp"], 64, 6, 0.2)
    else:
        opt = _local_run(model, inputs["data"]["bn_rows"], 16, 4, 0.1)
    out = outs[0]
    np.testing.assert_allclose(out[f"{leg}/loss"],
                               [h["loss"] for h in opt.history],
                               rtol=RTOL, atol=ATOL)
    _assert_close(_port(out, leg, "p"), _leaves(params_to_jax(model)),
                  RTOL, ATOL, "weights")
    if leg == "bn_same_rows":
        _assert_close(_port(out, leg, "s"), _leaves(state_to_jax(model)),
                      RTOL, ATOL, "statistics")
    slots = opt.optim_method._slots["dfdx"]
    with torch.no_grad():
        for p, s in zip(model.parameters(), slots):
            p.copy_(s)
    _assert_close(_port(out, leg, "dfdx"), _leaves(params_to_jax(model)),
                  RTOL, ATOL, "momentum")


@pytest.mark.parametrize("fault", ["after", "flagged"])
def test_a_bad_step_on_one_rank_keeps_every_rank_at_its_pre_step_state(
        ranks, fault):
    """``after``: a NaN in one of rank 1's rows.  ``flagged``: rank 1's
    finite check alone fails, every tensor finite (a verdict taken per
    rank would let rank 0 apply the step)."""
    outs, _, _ = ranks
    for rank, out in enumerate(outs):
        before = [out[f"guard/before{i}"] for i in range(4)]
        after = [out[f"guard/{fault}{i}"] for i in range(4)]
        # this rank's slice, its momentum shard, BN mean and variance
        assert f"guard/{fault}4" not in out
        for b, a in zip(before, after):
            assert np.isfinite(b).all()
            np.testing.assert_array_equal(a, b, err_msg=f"rank {rank}")
        loss = out["guard/loss" if fault == "after" else
                   "guard/flagged_loss"]
        assert loss.shape == (1,) and math.isnan(loss[0])


def test_dropout_masks_differ_between_ranks_and_repeat(ranks):
    outs, _, _ = ranks
    masks = [out["drop/mask"] for out in outs]    # (run x step, rows, 16)
    for m in masks:
        assert m.shape == (4, 32, 16)
        np.testing.assert_array_equal(m[:2], m[2:])      # run to run
        assert not np.array_equal(m[0], m[1])            # step to step
        assert 0.3 < m.mean() < 0.7
    assert not np.array_equal(masks[0], masks[1])        # rank to rank


def test_second_optimize_resumes_from_the_published_slots(ranks):
    for out in ranks[0]:
        assert len(out["resume/loss"]) == 6
        for k in [k for k in out if k.startswith("resume/")]:
            np.testing.assert_array_equal(
                out[k], out[k.replace("resume/", "mlp_bucketed/")],
                err_msg=k)


def test_bf16_wire_converges_on_separable_data(ranks):
    outs, _, inputs = ranks
    data = inputs["data"]["sep"]
    x = torch.from_numpy(np.stack([s.feature for s in data]))
    y = np.array([s.label for s in data])
    for comp in ("bf16", "None"):
        model = copy.deepcopy(inputs["mlp3"])
        jtree = params_to_jax(model)
        leaves, treedef = jax.tree_util.tree_flatten(jtree)
        trained = _port(outs[0], f"sep_{comp}", "p")
        params_from_jax(jax.tree_util.tree_unflatten(treedef, trained),
                        model)
        with torch.no_grad():
            acc = (model(x).argmax(1).numpy() + 1 == y).mean()
        assert acc > 0.9, (comp, acc)
        assert np.isfinite(outs[0][f"sep_{comp}/loss"]).all()
    # the bf16 wire rounds each gradient to 8 bits of mantissa: the losses
    # stay within a few percent of the fp32 wire's
    np.testing.assert_allclose(outs[0]["sep_bf16/loss"],
                               outs[0]["sep_None/loss"], rtol=0.05,
                               atol=5e-3)


def test_perf_harness_trains_with_two_partitions(ranks):
    for out in ranks[0]:
        assert str(out["perf/trainer"]) == "DistriOptimizer"
        assert len(out["perf/loss"]) == 4
        assert np.isfinite(out["perf/loss"]).all()


def test_engine_topology_over_two_ranks(ranks):
    for out in ranks[0]:
        assert int(out["node_number"]) == 2
        np.testing.assert_array_equal(out["allgather_sum"], [3.0, 4.0])


# ----------------------------------------- in one process, no spawning

@pytest.mark.parametrize("global_shuffle", [True, False])
@pytest.mark.parametrize("partitions", [1, 2, 4])
def test_sharded_dataset_order_matches_jax(partitions, global_shuffle):
    """Each partition's records, epoch by epoch, as the JAX package's."""
    ids = np.arange(24, dtype=np.float32)
    orders = []
    with seeded(SEED):
        for cls in (JaxShardedDataSet, ShardedDataSet):
            ds = cls(list(ids), partitions, global_shuffle=global_shuffle)
            epochs = []
            for _ in range(3):
                ds.shuffle()
                epochs.append([list(ds.shard_data(p, train=False))
                               for p in range(partitions)])
            assert ds.size() == 24
            orders.append(epochs)
    assert orders[0] == orders[1]
    assert orders[1][0] != orders[1][1]      # the epochs are reshuffled


def test_sharded_dataset_remainder_local_partitions_and_key():
    for cls in (JaxShardedDataSet, ShardedDataSet):
        ds = cls(list(range(26)), 4, local_partitions=[1, 3])
        assert (ds.size(), ds.dropped_records, ds.local_partitions,
                sorted(ds.shards)) == (24, 2, [1, 3], [1, 3])
        with pytest.raises(ValueError, match="not local"):
            ds.shard_data(0, train=True)
        with pytest.raises(ValueError, match="subset"):
            cls(list(range(8)), 2, local_partitions=[2])
    with properties([jconfig, pconfig],
                    bigdl__elastic__globalShuffle=False):
        assert not JaxShardedDataSet(list(range(8)), 2).global_shuffle
        assert not ShardedDataSet(list(range(8)), 2).global_shuffle


def test_sample_to_minibatch_partition_split_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((10, 3)).astype(np.float32)
    got = []
    for s2b, sample in ((JaxSampleToMiniBatch, JaxSample),
                        (SampleToMiniBatch, Sample)):
        batches = list(s2b(12, 3)(iter(sample(r, np.float32(1)) for r in x)))
        got.append([np.asarray(b.get_input()) for b in batches])
        with pytest.raises(ValueError, match="divisible"):
            s2b(10, 3)
    assert [b.shape for b in got[1]] == [(4, 3), (4, 3), (2, 3)]
    for a, b in zip(*got, strict=True):
        np.testing.assert_array_equal(a, b)
    assert SampleToMiniBatch(8).batch_per_partition == 8
    # ragged samples are padded to the longest of the partition's batch
    ragged = [(np.ones(n, np.float32), np.float32(1)) for n in (2, 3, 1, 4)]
    padded = [np.asarray(b.get_input()) for s2b, sample in (
        (JaxSampleToMiniBatch, JaxSample), (SampleToMiniBatch, Sample))
        for b in s2b(4, 2)(iter(sample(*r) for r in ragged))]
    assert [b.shape for b in padded] == [(2, 3), (2, 4)] * 2
    for a, b in zip(padded[:2], padded[2:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_all_reduce_parameter_geometry_matches_jax(n_shards):
    shapes = [(4, 5), (3,), (7, 1, 3), ()]
    jarp = JaxAllReduceParameter(
        {f"p{i}": np.zeros(s, np.float32) for i, s in enumerate(shapes)},
        n_shards)
    arp = AllReduceParameter([torch.zeros(s) for s in shapes], n_shards)
    assert (arp.size, arp.padded_size, arp.shard_size) == \
        (jarp.size, jarp.padded_size, jarp.shard_size)
    for k in (1, 2, 3, 4, 7, 100):
        assert arp.bucket_edges(k) == jarp.bucket_edges(k)
    with pytest.raises(ValueError, match="compression"):
        AllReduceParameter([torch.zeros(3)], 2, compression="fp16")


def test_bind_makes_parameters_views_in_their_memory_order():
    g = torch.Generator().manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(6, 3, 2, 2, generator=g)
                                 .to(memory_format=torch.channels_last)),
              torch.nn.Parameter(torch.randn(5, generator=g)),
              torch.nn.Parameter(torch.randn(4, 3, generator=g).t())]
    values = [p.detach().clone() for p in params]
    strides = [p.stride() for p in params]
    arp = AllReduceParameter(params, 4)
    flat = arp.bind(params)
    assert flat.shape == (arp.padded_size,) and arp.padded_size % 4 == 0
    lo, hi = flat.data_ptr(), flat.data_ptr() + flat.numel() * 4
    for p, v, st in zip(params, values, strides):
        assert torch.equal(p, v) and p.stride() == st
        assert lo <= p.data_ptr() < hi
    # each parameter's elements lie in the buffer in its memory order
    np.testing.assert_array_equal(
        flat[:params[0].numel()].numpy(),
        params[0].detach().permute(0, 2, 3, 1).reshape(-1).numpy())
    for got, p in zip(arp.unflatten(arp.flatten(values)), params):
        assert torch.equal(got, p)
    flat.zero_()
    assert all(float(p.detach().abs().sum()) == 0 for p in params)


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


def _mlp_samples(n=16):
    return _port_samples(synthetic_separable(n, 4, n_classes=2, seed=3))


def test_without_a_group_distri_optimizer_refuses():
    assert not dist.is_initialized()
    assert Engine.node_number() == 1 and Engine.core_number() == 1
    np.testing.assert_array_equal(allgather_sum([1.5, 2.0]), [1.5, 2.0])
    ds = ShardedDataSet(_mlp_samples(), 1)
    with pytest.raises(RuntimeError, match="Engine.init_distributed"):
        DistriOptimizer(_mlp(pnn, device="cpu"), ds, pnn.ClassNLLCriterion(),
                        device="cpu")


def test_create_dispatches_on_the_dataset_type(group1):
    crit = pnn.ClassNLLCriterion()
    local = Optimizer.create(_mlp(pnn, device="cpu"), _mlp_samples(), crit,
                             batch_size=8, device="cpu")
    assert type(local) is LocalOptimizer
    distri = Optimizer.create(_mlp(pnn, device="cpu"),
                              ShardedDataSet(_mlp_samples(), 1), crit,
                              batch_size=8, device="cpu")
    assert type(distri) is DistriOptimizer
    assert distri.dataset.shards[0].transformers[0].batch_per_partition == 8


def test_partition_count_must_match_the_group(group1):
    ds = ShardedDataSet(_mlp_samples(), 2).transform(SampleToMiniBatch(8, 2))
    opt = DistriOptimizer(_mlp(pnn, device="cpu"), ds,
                          pnn.ClassNLLCriterion(), device="cpu")
    with pytest.raises(ValueError, match="must match"):
        opt.optimize()


def test_backend_and_compression_are_checked(group1, monkeypatch):
    ds = ShardedDataSet(_mlp_samples(), 1)
    with pytest.raises(ValueError, match="compression"):
        DistriOptimizer(_mlp(pnn, device="cpu"), ds, pnn.ClassNLLCriterion(),
                        compression="fp16", device="cpu")
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="trains over gloo"):
        DistriOptimizer(_mlp(pnn, device="cpu"), ds, pnn.ClassNLLCriterion(),
                        device="cpu")


@pytest.mark.parametrize("ask", [
    "set_mesh", "bigdl.integrity.everyN", "bigdl.chaos.extraAllGather",
    "bigdl.chaos.dropBucketCollective", "bigdl.elastic.handleSignals"])
def test_unported_features_raise(group1, ask):
    ds = ShardedDataSet(_mlp_samples(), 1).transform(SampleToMiniBatch(8))
    opt = DistriOptimizer(_mlp(pnn, device="cpu"), ds,
                          pnn.ClassNLLCriterion(), device="cpu")
    opt.set_end_when(max_iteration(1))
    if ask == "set_mesh":
        with pytest.raises(NotImplementedError, match="seq/model/expert"):
            opt.set_mesh(None)
        return
    value = True if ask.endswith(("Gather", "Signals")) else 1
    with properties([pconfig], **{ask.replace(".", "__"): value}):
        with pytest.raises(NotImplementedError, match="not ported"):
            opt.optimize()
    assert opt.history == []


@pytest.mark.parametrize("overlap", [True, False])
def test_one_rank_is_local_optimizer_bit_for_bit(group1, overlap):
    """At one rank the reduce-scatter is a copy and the division by 1
    exact: the trainers agree to the bit on the same rows in the same
    order (a 1-partition ShardedDataSet feeds both)."""
    samples = _mlp_samples(32)
    runs = []
    for cls in (LocalOptimizer, DistriOptimizer):
        model = _mlp(pnn, device="cpu")
        ds = ShardedDataSet(samples, 1).transform(SampleToMiniBatch(8))
        with seeded(SEED), properties([pconfig],
                                      bigdl__parallel__overlap=overlap):
            opt = cls(model, ds, pnn.ClassNLLCriterion(), device="cpu")
            opt.set_optim_method(SGD(0.2, momentum=0.9))
            opt.set_end_when(max_iteration(6)).optimize()
        runs.append(([h["loss"] for h in opt.history],
                     [p.detach() for p in model.parameters()],
                     opt.optim_method._slots["dfdx"]))
    (l0, p0, s0), (l1, p1, s1) = runs
    assert l0 == l1
    for a, b in zip(p0 + s0, p1 + s1):
        assert torch.equal(a, b)
