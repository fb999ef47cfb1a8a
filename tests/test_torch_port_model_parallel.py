"""The port's in-step model sharding on four CPU ranks, held against the JAX
package: dp2 x tp2 (``DistriOptimizer`` over a ``("data", "model")`` mesh:
the Megatron split) and dp2 x ep2 (a ``("data", "expert")`` mesh: MoE's
``all_to_all`` dispatch), the twins of ``tests/test_parallel_trainers.py``
and ``tests/test_tensor_parallel.py``.

Ranks.  One module-scoped spawn runs every rank leg: a worker script written
to ``tmp_path`` (``torch`` and ``bigdl_tpu_torch`` only) runs as four ranks
joined over gloo on a ``file://`` store, one torch thread each, with a hard
timeout; a rank that fails stops all four, and each is reaped.  The models
reach the workers pickled, with the JAX package's initial weights.  While
they run, this process trains the JAX references on 4 of the 8 virtual
devices (``tests/conftest.py``): the GSPMD dp x tp and the shard_map dp x ep
meshes of the same shape, and ``LocalOptimizer`` over the full batch.

Legs: the reference tests' MLP (``_tp_model``) under SGD with momentum and
under Adam (its blocks and slot blocks physically 1/4 of the whole); the
MoE classifier (``_moe_model``) with capacity drops against the JAX mesh and
drop-free with the aux weight at 0 against the full batch; the tiny
tp-tagged transformer LM; a snapshot of the dp x tp run (canonical,
unsharded tensors, the mesh in its manifest) resumed bit-exactly on the same
mesh and resharded onto a data-only mesh of four; the LM driver's
``main(argv)`` with ``--tensor-parallel 2`` and with ``--moe-experts 4
--expert-parallel 2``; and the refusals that need a process group.

Tolerances (fp32): weights, slots and losses rtol 2e-4 / atol 2e-5 against
the JAX meshes and full batch, the reference tests' own
(``test_parallel_trainers.py:72``); the resumed run and the ranks' copies of
the weights: bit-identical.
"""

import copy
import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset import SampleToMiniBatch as JaxSampleToMiniBatch
from bigdl_tpu.dataset.dataset import LocalDataSet as JaxLocalDataSet
from bigdl_tpu.dataset.dataset import ShardedDataSet as JaxShardedDataSet
from bigdl_tpu.dataset.sample import Sample as JaxSample
from bigdl_tpu.engine import Engine as JaxEngine
from bigdl_tpu.models.transformer import transformer_lm as jax_lm
from bigdl_tpu.nn.moe import MixtureOfExperts as JaxMoE
from bigdl_tpu.parallel import DistriOptimizer as JaxDistriOptimizer
from bigdl_tpu.parallel.tensor_parallel import (column_parallel as
                                                jax_column,
                                                row_parallel as jax_row)
from bigdl_tpu.utils.random_generator import \
    RandomGenerator as JaxRandomGenerator
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu_torch.dataset import Sample
from bigdl_tpu_torch.models.transformer import transformer_lm
from bigdl_tpu_torch.parallel.tensor_parallel import (column_parallel,
                                                      row_parallel)
from bigdl_tpu_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 17
RTOL, ATOL = 2e-4, 2e-5
WORLD = 4
WORKER_TIMEOUT = 240.0
D = 8
LM = dict(d_model=16, n_head=2, n_layers=1, max_len=8)
VOCAB = 16


def _tp_model(mod, tp, **kw):
    up, down = mod.Linear(4, 16, **kw), mod.Linear(16, 2, **kw)
    if tp:
        (jax_column if mod is jnn else column_parallel)(up)
        (jax_row if mod is jnn else row_parallel)(down)
    return (mod.Sequential().add(up).add(mod.Tanh()).add(down)
            .add(mod.LogSoftMax()))


def _moe_model(mod, capacity_factor, **kw):
    expert = (mod.Sequential().add(mod.Linear(D, 16, **kw)).add(mod.ReLU())
              .add(mod.Linear(16, D, **kw)))
    moe = (JaxMoE(D, expert, 4, capacity_factor=capacity_factor)
           if mod is jnn else
           pnn.MixtureOfExperts(D, expert, 4,
                                capacity_factor=capacity_factor))
    return (mod.Sequential().add(mod.Linear(4, D, **kw)).add(mod.Tanh())
            .add(moe).add(mod.Linear(D, 2, **kw)).add(mod.LogSoftMax()))


def _twins(build, seed, **kw):
    jm = build(jnn, **kw)
    jm.reset(jax.random.PRNGKey(seed))
    pm = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                         build(pnn, device="cpu", **kw))
    return jm, pm


def _samples(n=64):
    rng = np.random.RandomState(3)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float32) + 1
    return x, y


def _lm_rows(n=8):
    return np.random.default_rng(5).integers(
        1, VOCAB + 1, (n, LM["max_len"] + 1)).astype(np.float32)


# ---------------------------------------------------------- the workers

_WORKER = textwrap.dedent(r'''
    import copy, json, os, sys
    repo, store, outdir, rank = sys.argv[1:5]
    rank = int(rank)
    sys.path.insert(0, repo)
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, ShardedDataSet
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.models.transformer import train as lm_train
    from bigdl_tpu_torch.optim import SGD, Adam, max_iteration
    from bigdl_tpu_torch.optim import several_iteration
    from bigdl_tpu_torch.optim.optim_method import load_payload
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from bigdl_tpu_torch.utils import config
    from bigdl_tpu_torch.utils.checkpoint_manager import load_file
    from bigdl_tpu_torch.utils.convert import params_to_jax
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    Engine.init_distributed(init_method="file://" + store, rank=rank,
                            world_size=4, device="cpu")
    config.set_property("bigdl.failure.retryTimes", 1)
    inp = torch.load(os.path.join(outdir, "inputs.pt"), weights_only=False)
    SEED = inp["seed"]
    out = {}
    meshes = {axes: Engine.create_mesh((2, 2), axes)
              for axes in (("data", "model"), ("data", "expert"))}

    def keep(prefix, tree):
        def leaves(t):
            if isinstance(t, dict):
                return [x for k in sorted(t) for x in leaves(t[k])]
            if isinstance(t, (list, tuple)):
                return [x for s in t for x in leaves(s)]
            return [t]
        for i, x in enumerate(leaves(tree)):
            out[f"{prefix}{i}"] = np.asarray(x)

    def as_jax(model, tensors):
        params = list(model.parameters())
        saved = [p.detach().clone() for p in params]
        with torch.no_grad():
            for p, t in zip(params, tensors):
                p.copy_(t)
            tree = params_to_jax(model)
            for p, s in zip(params, saved):
                p.copy_(s)
        return tree

    def run(leg, key, axes, batch, steps, method, crit=None, aux=None,
            dp=2, mesh=None, model=None, setup=None):
        RandomGenerator.RNG().set_seed(SEED)
        model = model or copy.deepcopy(inp[key])
        x, y = inp["data"][key.split("_")[0]]
        samples = [inp["Sample"](a, b) for a, b in zip(x, y)]
        ds = ShardedDataSet(samples, dp).transform(SampleToMiniBatch(batch,
                                                                     dp))
        opt = DistriOptimizer(model, ds, crit or nn.ClassNLLCriterion(),
                              mesh=mesh or meshes[axes], device="cpu")
        opt.set_optim_method(method).set_end_when(max_iteration(steps))
        if aux is not None:
            opt.set_moe_aux_weight(aux)
        if setup is not None:
            setup(opt)
        opt.optimize()
        out[f"{leg}/loss"] = np.array([h["loss"] for h in opt.history])
        keep(f"{leg}/p", params_to_jax(model))
        for fam in sorted(opt.optim_method._slots):
            keep(f"{leg}/{fam}", as_jax(model, opt.optim_method._slots[fam]))
        return opt, model

    tp, ep = ("data", "model"), ("data", "expert")
    run("tp_sgd", "mlp", tp, 64, 6, SGD(0.2, momentum=0.9))
    opt, _ = run("tp_adam", "mlp", tp, 64, 2, Adam(0.05))
    col = "layers.0.weight"
    out["tp_adam/block"] = np.array(opt.tp_shards["params"][col].shape)
    out["tp_adam/slot_block"] = np.array(
        opt.tp_shards["slots"]["s"][col].shape)
    run("ep_drop", "moe_drop", ep, 64, 6, SGD(0.2, momentum=0.9))
    run("ep_free", "moe_free", ep, 64, 6, SGD(0.2, momentum=0.9), aux=0.0)
    lm_crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                          size_average=True)
    run("tp_lm", "lm", tp, 8, 3, SGD(0.1, momentum=0.9), crit=lm_crit)

    # a snapshot of the dp x tp run, resumed on the same mesh and onto a
    # data-only mesh of four
    ckpt = os.path.join(outdir, "ckpt")
    run("tp_ckpt", "mlp", tp, 64, 2, SGD(0.2, momentum=0.9),
        setup=lambda o: o.set_checkpoint(ckpt, several_iteration(1)))
    with open(os.path.join(ckpt, "manifest.2")) as f:
        out["ckpt/topology"] = np.array(json.dumps(
            json.load(f)["topology"], sort_keys=True))
    out["ckpt/shapes"] = np.array(json.dumps(
        {k: list(v.shape) for k, v in load_file(
            os.path.join(ckpt, "model.2")).items()}, sort_keys=True))

    def resumed():
        model = copy.deepcopy(inp["mlp"])
        model.load_state_dict(load_file(os.path.join(ckpt, "model.2")))
        method = SGD(0.2, momentum=0.9)
        load_payload(method, load_file(os.path.join(ckpt, "optimMethod.2")))
        return model, method

    model, method = resumed()
    run("tp_resumed", "mlp", tp, 64, 4, method, model=model)
    run("tp_straight", "mlp", tp, 64, 4, SGD(0.2, momentum=0.9))
    model, method = resumed()
    run("dp4_resumed", "mlp", None, 64, 4, method, model=model, dp=4,
        mesh=Engine.create_mesh((4,), ("data",)))

    common = ["--synthetic", "16", "-b", "8", "--seq-len", "8",
              "--d-model", "16", "--heads", "2", "--layers", "1", "-i", "2",
              "--partitions", "2", "--device", "cpu"]
    for leg, flags in (("drv_tp", ["--tensor-parallel", "2"]),
                       ("drv_ep", ["--moe-experts", "4",
                                   "--expert-parallel", "2"])):
        RandomGenerator.RNG().set_seed(SEED)
        opt = lm_train.main(common + flags)
        out[f"{leg}/loss"] = np.array([h["loss"] for h in opt.history])
        out[f"{leg}/mesh"] = np.array(json.dumps(opt.mesh.shape))
        keep(f"{leg}/p", params_to_jax(opt.model))

    # the refusals that need a group
    def refusal(name, fn):
        try:
            fn()
            out[f"refuse/{name}"] = np.array("no error")
        except Exception as e:
            out[f"refuse/{name}"] = np.array(type(e).__name__ + ": " + str(e))

    both = Engine.create_mesh((1, 2, 2), ("data", "model", "expert"))
    refusal("model_with_expert", lambda: run(
        "x", "mlp", None, 64, 1, SGD(0.1), mesh=both, dp=1))
    refusal("compression_under_tp", lambda: DistriOptimizer(
        copy.deepcopy(inp["mlp"]), ShardedDataSet(
            [inp["Sample"](a, b) for a, b in zip(*inp["data"]["mlp"])],
            2).transform(SampleToMiniBatch(64, 2)), nn.ClassNLLCriterion(),
        compression="bf16", mesh=meshes[tp], device="cpu").optimize())
    refusal("expert_without_moe", lambda: run(
        "x", "mlp", ep, 64, 1, SGD(0.1)))
    refusal("seq_mesh", lambda: DistriOptimizer(
        copy.deepcopy(inp["mlp"]), ShardedDataSet(
            [inp["Sample"](a, b) for a, b in zip(*inp["data"]["mlp"])], 2),
        nn.ClassNLLCriterion(), device="cpu",
        mesh=Engine.create_mesh((2, 2), ("data", "seq"))))
    refusal("flash_under_tp", lambda: run(
        "x", "lm_flash", tp, 8, 1, SGD(0.1), crit=lm_crit))

    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    print("WORKER_OK", rank)
''')


def _jax_run(model, x, y, batch, steps, method, mesh_shape=None, axes=None,
             crit=None, aux=None):
    """The JAX package's run of the same leg: a DistriOptimizer over the
    first prod(mesh_shape) virtual devices, or a LocalOptimizer over the
    full batch.  Returns (losses are not logged here) weights and slots as
    numpy leaves."""
    samples = [JaxSample(a, b) for a, b in zip(x, y)]
    crit = crit or jnn.ClassNLLCriterion()
    if mesh_shape is None:
        ds = JaxLocalDataSet(samples).transform(JaxSampleToMiniBatch(batch))
        opt = joptim.Optimizer.create(model, ds, crit)
    else:
        n = int(np.prod(mesh_shape))
        mesh = JaxEngine.create_mesh(mesh_shape, axes,
                                     devices=jax.devices()[:n])
        ds = JaxShardedDataSet(samples, mesh_shape[0]).transform(
            JaxSampleToMiniBatch(batch, mesh_shape[0]))
        opt = JaxDistriOptimizer(model, ds, crit, mesh=mesh)
    opt.set_optim_method(method)
    if aux is not None:
        opt.set_moe_aux_weight(aux)
    opt.set_end_when(joptim.max_iteration(steps))
    JaxRandomGenerator.RNG().set_seed(SEED)
    opt.optimize()
    leaves = lambda t: [np.asarray(v) for v in jax.tree_util.tree_leaves(t)]
    return {"p": leaves(model.params),
            "slots": {k: leaves(v) for k, v in
                      opt.optim_method._slots.items()}}


def _reap(procs, logs, deadline):
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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the four ranks once; meanwhile, train the JAX references.
    Returns (each rank's results, the JAX results)."""
    outdir = str(tmp_path_factory.mktemp("model_parallel"))
    jmlp, pmlp = _twins(_tp_model, 11, tp=True)
    jdrop, pdrop = _twins(_moe_model, 7, capacity_factor=1.25)
    jfree, pfree = _twins(_moe_model, 7, capacity_factor=4.0)
    jlm = jax_lm(VOCAB, tp=True, **LM)
    jlm.reset(jax.random.PRNGKey(0))
    plm = params_from_jax(jax.tree_util.tree_map(np.asarray, jlm.params),
                          transformer_lm(VOCAB, tp=True, device="cpu", **LM))
    x, y = _samples()
    rows = _lm_rows()
    torch.save({"seed": SEED, "Sample": Sample, "mlp": pmlp,
                "moe_drop": pdrop, "moe_free": pfree, "lm": plm,
                "lm_flash": transformer_lm(VOCAB, tp=True, flash=True,
                                           device="cpu", **LM),
                "data": {"mlp": (x, y), "moe": (x, y),
                         "lm": (rows[:, :-1], rows[:, 1:])}},
               os.path.join(outdir, "inputs.pt"))
    script = os.path.join(outdir, "worker.py")
    with open(script, "w") as f:
        f.write(_WORKER)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    t0 = time.monotonic()
    procs, logs = [], []
    for rank in range(WORLD):
        logs.append(open(os.path.join(outdir, f"rank{rank}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, script, REPO, os.path.join(outdir, "store"),
             outdir, str(rank)], cwd=outdir, env=env, stdout=logs[-1],
            stderr=subprocess.STDOUT))
    try:
        sgd = lambda: joptim.SGD(0.2, momentum=0.9)
        tp = ((2, 2), ("data", "model"))
        ep = ((2, 2), ("data", "expert"))
        ref = {
            "tp_sgd": _jax_run(copy.deepcopy(jmlp), x, y, 64, 6, sgd(), *tp),
            "tp_sgd_local": _jax_run(copy.deepcopy(jmlp), x, y, 64, 6,
                                     sgd()),
            "tp_adam": _jax_run(copy.deepcopy(jmlp), x, y, 64, 2,
                                joptim.Adam(0.05), *tp),
            "ep_drop": _jax_run(jdrop, x, y, 64, 6, sgd(), *ep),
            "ep_free": _jax_run(jfree, x, y, 64, 6, sgd(), aux=0.0),
            "tp_lm": _jax_run(jlm, rows[:, :-1], rows[:, 1:], 8, 3,
                              joptim.SGD(0.1, momentum=0.9),
                              crit=jnn.TimeDistributedCriterion(
                                  jnn.ClassNLLCriterion(),
                                  size_average=True)),
        }
    finally:
        _reap(procs, logs, t0 + WORKER_TIMEOUT)
    texts = []
    for rank in range(WORLD):
        with open(os.path.join(outdir, f"rank{rank}.log")) as f:
            texts.append(f.read())
    for rank, (p, text) in enumerate(zip(procs, texts)):
        assert p.returncode == 0 and f"WORKER_OK {rank}" in text, (
            f"rank {rank} exited {p.returncode} after "
            f"{time.monotonic() - t0:.1f} s:\n{text[-6000:]}")
    outs = []
    for rank in range(WORLD):
        with np.load(os.path.join(outdir, f"rank{rank}.npz")) as z:
            outs.append(dict(z))
    return outs, ref


def _port(out, leg, kind):
    n = sum(1 for k in out if k.startswith(f"{leg}/{kind}") and
            k[len(leg) + 1 + len(kind):].isdigit())
    return [out[f"{leg}/{kind}{i}"] for i in range(n)]


def _assert_matches(out, leg, ref, what):
    port = _port(out, leg, "p")
    assert len(port) == len(ref["p"]) and port, what
    for i, (a, b) in enumerate(zip(port, ref["p"])):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} weight {i}")
    for fam, leaves in ref["slots"].items():
        for i, (a, b) in enumerate(zip(_port(out, leg, fam), leaves)):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} slot {fam} {i}")


@pytest.mark.parametrize("leg,against", [
    ("tp_sgd", "tp_sgd"), ("tp_sgd", "tp_sgd_local"), ("tp_adam", "tp_adam"),
    ("ep_drop", "ep_drop"), ("ep_free", "ep_free"), ("tp_lm", "tp_lm")])
def test_mesh_leg_matches_jax(ranks, leg, against):
    """Every rank's weights and slots against the JAX package's run of the
    same leg (its dp x tp GSPMD or dp x ep shard_map mesh of the same
    shape, or ``LocalOptimizer`` over the full batch), and the ranks'
    weights bit-identical."""
    outs, ref = ranks
    for rank, out in enumerate(outs):
        _assert_matches(out, leg, ref[against], f"{leg} rank {rank}")
        assert np.all(np.isfinite(out[f"{leg}/loss"]))
        for a, b in zip(_port(out, leg, "p"), _port(outs[0], leg, "p")):
            assert np.array_equal(a, b)


def test_tp_blocks_and_slots_are_physically_split(ranks):
    """The column weight, (16, 4) in the port's (out, in) layout, is a
    (8, 4) block on each rank; its Adam slot is split over both axes, a
    (8, 2) block: a quarter of the whole (the JAX test's 1/(dp x tp))."""
    outs, _ = ranks
    for out in outs:
        assert tuple(out["tp_adam/block"]) == (8, 4)
        assert tuple(out["tp_adam/slot_block"]) == (8, 2)


def test_tp_snapshot_resume_and_reshard(ranks):
    """The dp x tp snapshot holds canonical, unsharded tensors and the mesh
    in its manifest (the JAX package's schema); resumed on the same mesh
    it gives the straight run's bits; restored onto a data-only mesh of
    four it reshards and trains on."""
    outs, _ = ranks
    for out in outs:
        topo = json.loads(str(out["ckpt/topology"]))
        assert topo == {"axes": {"data": 2, "model": 2}, "device_count": 4,
                        "slot_axis": "data", "step": "tensor_parallel"}
        assert json.loads(str(out["ckpt/shapes"])) == {
            "layers.0.bias": [16], "layers.0.weight": [16, 4],
            "layers.2.bias": [2], "layers.2.weight": [2, 16]}
        for a, b in zip(_port(out, "tp_resumed", "p") +
                        _port(out, "tp_resumed", "dfdx"),
                        _port(out, "tp_straight", "p") +
                        _port(out, "tp_straight", "dfdx")):
            assert np.array_equal(a, b)
        np.testing.assert_array_equal(out["tp_resumed/loss"],
                                      out["tp_straight/loss"][2:])
        assert np.all(np.isfinite(out["dp4_resumed/loss"]))
        assert len(out["dp4_resumed/loss"]) == 2


@pytest.mark.parametrize("leg,mesh", [
    ("drv_tp", {"data": 2, "model": 2}), ("drv_ep", {"data": 2,
                                                     "expert": 2})])
def test_lm_driver_trains_on_the_mesh(ranks, leg, mesh):
    """``models/transformer/train.py``'s ``main(argv)`` with
    ``--partitions 2 --tensor-parallel 2`` and with ``--moe-experts 4
    --partitions 2 --expert-parallel 2``: the mesh the JAX driver builds,
    finite losses, the ranks' weights bit-identical."""
    outs, _ = ranks
    for out in outs:
        assert json.loads(str(out[f"{leg}/mesh"])) == mesh
        assert len(out[f"{leg}/loss"]) == 2
        assert np.all(np.isfinite(out[f"{leg}/loss"]))
        for a, b in zip(_port(out, leg, "p"), _port(outs[0], leg, "p")):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("name,error", [
    ("model_with_expert", "ValueError: the tensor-parallel step "
                          "composes with 'data' only"),
    ("compression_under_tp", "ValueError: compression='bf16'"),
    ("expert_without_moe", "ValueError: mesh declares an 'expert' axis"),
    ("seq_mesh", "NotImplementedError: a mesh with a 'seq' axis"),
    ("flash_under_tp", "ValueError: flash kernel is incompatible")])
def test_mesh_refusals(ranks, name, error):
    """The JAX package's refusals on a mesh, with its error types (a
    ``seq`` axis, not ported, raises NotImplementedError)."""
    outs, _ = ranks
    for out in outs:
        assert str(out[f"refuse/{name}"]).startswith(error), \
            str(out[f"refuse/{name}"])
