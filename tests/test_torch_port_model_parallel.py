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

import concurrent.futures
import copy
import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
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
from bigdl_tpu.models.transformer import PositionalEncoding as JaxPE
from bigdl_tpu.models.transformer import transformer_block as jax_block
from bigdl_tpu.models.transformer import transformer_lm as jax_lm
from bigdl_tpu.nn.attention import \
    scaled_dot_product_attention as jax_attention
from bigdl_tpu.parallel import PipelineOptimizer as JaxPipelineOptimizer
from bigdl_tpu.parallel import pipeline as jpipe
from bigdl_tpu.parallel.ring_attention import ring_attention as jax_ring
from bigdl_tpu.nn.moe import MixtureOfExperts as JaxMoE
from bigdl_tpu.parallel import DistriOptimizer as JaxDistriOptimizer
from bigdl_tpu.parallel.tensor_parallel import (column_parallel as
                                                jax_column,
                                                row_parallel as jax_row)
from bigdl_tpu.utils.random_generator import \
    RandomGenerator as JaxRandomGenerator
import bigdl_tpu_torch.nn as pnn
import bigdl_tpu_torch.optim as poptim
from bigdl_tpu_torch.dataset import Sample
from bigdl_tpu_torch.models.transformer import (transformer_block,
                                                transformer_lm)
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


def _tp_model(mod, tp, reg=False, **kw):
    if reg:
        regs = (joptim if mod is jnn else poptim).L2Regularizer
        kw = dict(kw, w_regularizer=regs(0.01), b_regularizer=regs(0.02))
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


def _lm_rows(n=8, t=LM["max_len"]):
    return np.random.default_rng(5).integers(
        1, VOCAB + 1, (n, t + 1)).astype(np.float32)


def _normal(seed, *shape):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def _mlp_block(mod, **kw):
    return mod.Sequential().add(mod.Linear(D, D, **kw)).add(mod.Tanh())


def _tp_block(mod, **kw):
    up, down = mod.Linear(D, 2 * D, **kw), mod.Linear(2 * D, D, **kw)
    (jax_column if mod is jnn else column_parallel)(up)
    (jax_row if mod is jnn else row_parallel)(down)
    return mod.Sequential().add(up).add(mod.ReLU()).add(down)


def _t_block(mod, **kw):
    if mod is jnn:
        kw.pop("device", None)
        return jax_block(D, 2, **kw)
    return transformer_block(D, 2, **kw)


def _np_twins(build, seed, **kw):
    """A JAX module with parameters drawn by numpy (shapes from
    ``jax.eval_shape``: its own init compiles a random draw per shape) and
    its port twin: U(-a, a) of variance 1 / fan-in, 1-D weights near 1 and
    biases near 0."""
    jm = build(jnn, **kw)
    rng = np.random.default_rng(seed)

    def draw(path, sd):
        if len(sd.shape) == 1:
            base = 1.0 if path[-1].key == "weight" else 0.0
            return (base + rng.uniform(-0.1, 0.1, sd.shape)).astype(
                np.float32)
        half = np.float32(np.sqrt(3.0 / sd.shape[-2]))
        return (rng.random(sd.shape, dtype=np.float32) * 2 - 1) * half

    params = jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(jm._init_params, jax.random.PRNGKey(0)))
    jm._params = jax.tree_util.tree_map(jnp.asarray, params)
    jm._state = jax.tree_util.tree_map(
        lambda sd: jnp.zeros(sd.shape, sd.dtype),
        jax.eval_shape(jm._init_state))
    jm._grads = jax.tree_util.tree_map(jnp.zeros_like, jm._params)
    if hasattr(jm, "_adopt"):
        jm._adopt()
    return jm, params_from_jax(params, build(pnn, device="cpu", **kw))


def _stages(build, seeds, **kw):
    """The JAX blocks and their port twins, one seed each."""
    pairs = [_np_twins(build, s, **kw) for s in seeds]
    return [j for j, _ in pairs], [p for _, p in pairs]


def _jax_pipe(blocks, x, y, shape, axes, n_micro, data_axis=None, tp=None):
    """The JAX package's pipeline_apply over the same mesh shape: output,
    aux, the MSE loss and each stage's gradients (numpy leaves), forward
    and gradients in one jit."""
    n = int(np.prod(shape))
    mesh = JaxEngine.create_mesh(shape, axes, devices=jax.devices()[:n])
    specs = None
    if tp:
        for b in blocks:
            jpipe.wire_model_parallel(b, tp, mesh)
        specs = jpipe.stage_tp_specs(blocks[0], tp_axis=tp)
    sharded = jpipe.pipeline_shard_params(
        jpipe.stack_stage_params([b.params for b in blocks]), mesh,
        specs=specs)

    def loss_fn(sp):
        out, aux = jpipe.pipeline_apply(blocks[0], sp, x, n_micro, mesh,
                                        data_axis=data_axis, return_aux=True,
                                        param_specs=specs)
        return jnp.mean((out - y) ** 2), (out, aux)

    try:
        (loss, (out, aux)), g = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(sharded)
    finally:
        for b in blocks if tp else []:
            jpipe.wire_model_parallel(b, None)
    return {"out": np.asarray(out), "aux": float(aux), "loss": float(loss),
            "g": [[np.asarray(v) for v in jax.tree_util.tree_leaves(t)]
                  for t in jpipe.unstack_stage_params(g, len(blocks))]}


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

    # ---- GPipe (parallel/pipeline.py) and ring attention ---------------
    from bigdl_tpu_torch.dataset import LocalDataSet
    from bigdl_tpu_torch.engine import bind_axes
    from bigdl_tpu_torch.models.transformer import PositionalEncoding
    from bigdl_tpu_torch.parallel import (
        PipelineOptimizer, pipeline_apply, pipeline_shard_params,
        ring_attention, ring_self_attention, stack_stage_params,
        stage_tp_specs, wire_model_parallel)
    from bigdl_tpu_torch.parallel.distri_optimizer import _gather_dim
    from bigdl_tpu_torch.parallel.ring_attention import _ring_attention_shard
    from bigdl_tpu_torch.parallel.tensor_parallel import named_specs, split_dim
    pp = inp["pp"]
    stage = {axes: Engine.create_mesh((2, 2), axes)
             for axes in (("data", "stage"), ("stage", "model"),
                          ("data", "seq"))}
    stage[("stage",)] = Engine.create_mesh((4,), ("stage",))
    stage[("seq",)] = Engine.create_mesh((4,), ("seq",))
    stage[("data", "stage", "model")] = Engine.create_mesh(
        (1, 2, 2), ("data", "stage", "model"))

    def grads_as_jax(block, grads):
        b = copy.deepcopy(block)
        with torch.no_grad():
            for p, g in zip(b.parameters(), grads):
                p.copy_(g)
        return params_to_jax(b)

    def pipe_leg(leg, key, axes, n_micro, data_axis=None, tp=None,
                 grads=True):
        mesh = stage[axes]
        blocks = copy.deepcopy(pp[key])
        block = blocks[mesh.coord("stage")]
        stacked = stack_stage_params([dict(b.named_parameters())
                                      for b in blocks])
        specs = None
        if tp:
            wire_model_parallel(block, tp, mesh)
            specs = stage_tp_specs(block, tp)
        mine = pipeline_shard_params(stacked, mesh, specs=specs)
        for v in mine.values():
            v.requires_grad_()
        x, y = (torch.from_numpy(a) for a in pp["xy"][key])
        got, aux = pipeline_apply(block, mine, x, n_micro, mesh,
                                  data_axis=data_axis, param_specs=specs,
                                  return_aux=True)
        loss = ((got - y) ** 2).mean()
        out[f"{leg}/out"] = got.detach().numpy()
        out[f"{leg}/aux"] = aux.detach().numpy()
        out[f"{leg}/loss"] = loss.detach().numpy()
        if not grads:
            return
        g = torch.autograd.grad(loss, list(mine.values()))
        if tp:
            full = named_specs(block, tp)
            g = [t if split_dim(full[k], tp) is None else
                 _gather_dim(t, split_dim(full[k], tp), mesh.group(tp),
                             mesh.shape[tp]) for k, t in zip(mine, g)]
        keep(f"{leg}/g", grads_as_jax(block, g))

    pipe_leg("pp4", "mlp4", ("stage",), 4)
    pipe_leg("ppdp", "mlp2", ("data", "stage"), 4, data_axis="data")
    pipe_leg("pptp", "tp2", ("stage", "model"), 4, tp="model")
    for key in ("moe_drop", "moe_free"):
        pipe_leg(key, key, ("data", "stage"), 2, data_axis="data",
                 grads=False)

    def pipe_train(leg, key, axes, ds, steps, method, n_micro, crit=None,
                   aux=None, blocks=None, setup=None):
        RandomGenerator.RNG().set_seed(SEED)
        opt = PipelineOptimizer(blocks or copy.deepcopy(pp[key]), ds,
                                crit or nn.MSECriterion(), mesh=stage[axes],
                                n_micro=n_micro, device="cpu")
        opt.set_optim_method(method).set_end_when(max_iteration(steps))
        if aux is not None:
            opt.set_moe_aux_weight(aux)
        if setup is not None:
            setup(opt)
        opt.optimize()
        out[f"{leg}/loss"] = np.array([h["loss"] for h in opt.history])
        out[f"{leg}/records"] = np.array([h["records"] for h in opt.history])
        keep(f"{leg}/p", params_to_jax(opt.model))
        for fam in sorted(opt.optim_method._slots):
            keep(f"{leg}/{fam}", as_jax(opt.model,
                                        opt.optim_method._slots[fam]))
        return opt

    xs, ys = pp["xy"]["train3d"]
    pipe_train("po_3d", "train3d", ("data", "stage", "model"),
               LocalDataSet([inp["Sample"](a, b) for a, b in zip(xs, ys)])
               .transform(SampleToMiniBatch(8)), 4, SGD(0.2, momentum=0.9),
               2)
    xs, ys = pp["xy"]["sharded"]
    pipe_train("po_dp", "mlp2", ("data", "stage"),
               ShardedDataSet([inp["Sample"](a, b) for a, b in zip(xs, ys)],
                              2).transform(SampleToMiniBatch(64, 2)), 2,
               SGD(0.5), 2)
    # a snapshot of a (stage, model) run of Megatron-tagged stages, resumed
    # on the same mesh and onto a (data, stage) mesh
    def full_batch():      # a ShardedDataSet's shuffles replay on resume
        return ShardedDataSet([inp["Sample"](a, b) for a, b in zip(xs, ys)],
                              1).transform(SampleToMiniBatch(64))

    pckpt = os.path.join(outdir, "pckpt")
    pipe_train("po_ckpt", "tp2", ("stage", "model"), full_batch(), 2,
               SGD(0.5, momentum=0.9), 2,
               setup=lambda o: o.set_checkpoint(pckpt, several_iteration(1)))
    with open(os.path.join(pckpt, "manifest.2")) as f:
        out["pckpt/topology"] = np.array(json.dumps(
            json.load(f)["topology"], sort_keys=True))

    def presumed():
        blocks = copy.deepcopy(pp["tp2"])
        holder = nn.Sequential()
        for b in blocks:
            holder.add(b)
        holder.load_state_dict(load_file(os.path.join(pckpt, "model.2")))
        method = SGD(0.5, momentum=0.9)
        load_payload(method, load_file(os.path.join(pckpt,
                                                    "optimMethod.2")))
        return blocks, method

    blocks, method = presumed()
    pipe_train("po_resumed", "tp2", ("stage", "model"), full_batch(), 4,
               method, 2, blocks=blocks)
    pipe_train("po_straight", "tp2", ("stage", "model"), full_batch(), 4,
               SGD(0.5, momentum=0.9), 2)
    blocks, method = presumed()
    pipe_train("po_moved", "tp2", ("data", "stage"), ShardedDataSet(
        [inp["Sample"](a, b) for a, b in zip(xs, ys)], 2).transform(
            SampleToMiniBatch(64, 2)), 4, method, 2, blocks=blocks)
    xs, ys = pp["xy"]["moe_train"]
    pipe_train("po_moe", "moe_drop", ("data", "stage"),
               LocalDataSet([inp["Sample"](a, b) for a, b in zip(xs, ys)])
               .transform(SampleToMiniBatch(8)), 4, Adam(0.01), 2)

    # ring attention over a seq axis of four, and a (data, seq) mesh
    q, k, v = (torch.from_numpy(a) for a in pp["qkv"])
    for causal in (False, True):
        out[f"ring/{causal}"] = ring_attention(q, k, v, stage[("seq",)],
                                               causal=causal).numpy()
    mha = copy.deepcopy(pp["mha"])
    xa = torch.from_numpy(pp["mha_x"])
    rsa = ring_self_attention(mha, None, xa, stage[("seq",)])
    out["rsa/out"] = rsa.detach().numpy()
    g = torch.autograd.grad((rsa ** 2).sum(), list(mha.parameters()))
    g = [t.clone() for t in g]
    for t in g:
        torch.distributed.all_reduce(t, group=stage[("seq",)].group("seq"))
    keep("rsa/g", grads_as_jax(mha, g))
    mesh = stage[("data", "seq")]
    b4 = [torch.from_numpy(a) for a in pp["qkv_dp"]]
    d_, s_ = mesh.coord("data"), mesh.coord("seq")
    local = [a[2 * d_:2 * d_ + 2, 16 * s_:16 * s_ + 16] for a in b4]
    out["ring_dp"] = _ring_attention_shard(*local, mesh.group("seq"),
                                           False).numpy()
    pe = PositionalEncoding(8, device="cpu").set_sequence_parallel("seq")
    with bind_axes(stage[("seq",)], ["seq"]):
        out["pe"] = pe(torch.zeros(1, 4, 8)).numpy()

    # dp x sp training of the LM, and the regularized dp x tp step
    run("sp_lm", "lm", ("data", "seq"), 8, 3, SGD(0.1, momentum=0.9),
        crit=lm_crit, mesh=stage[("data", "seq")])
    run("tp_reg", "mlp_reg", tp, 64, 4, SGD(0.2, momentum=0.9))

    common = ["--synthetic", "16", "-b", "8", "--seq-len", "8",
              "--d-model", "16", "--heads", "2", "--layers", "1", "-i", "2",
              "--partitions", "2", "--device", "cpu"]
    for leg, flags in (("drv_tp", ["--tensor-parallel", "2"]),
                       ("drv_ep", ["--moe-experts", "4",
                                   "--expert-parallel", "2"]),
                       ("drv_sp", ["--seq-parallel", "2"]),
                       ("drv_pp", ["--pipeline", "2", "--remat", "full"]),
                       ("drv_pptp", ["--pipeline", "2", "--tensor-parallel",
                                     "2", "--partitions", "1"])):
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
    seq = stage[("data", "seq")]
    refusal("seq_mesh", lambda: run("x", "mlp", None, 64, 1, SGD(0.1),
                                    mesh=seq))
    refusal("model_with_seq", lambda: run(
        "x", "mlp", None, 64, 1, SGD(0.1), dp=1, mesh=Engine.create_mesh(
            (1, 2, 2), ("data", "model", "seq"))))
    refusal("time_mixing_under_seq", lambda: run(
        "x", "lm", None, 8, 1, SGD(0.1), crit=lm_crit, mesh=seq,
        model=nn.Sequential().add(nn.Recurrent().add(
            nn.RnnCell(8, 8, device="cpu")))))
    refusal("past_capacity", lambda: run(
        "x", "long", None, 8, 1, SGD(0.1), crit=lm_crit, mesh=seq,
        model=copy.deepcopy(inp["lm"])))
    refusal("flash_under_tp", lambda: run(
        "x", "lm_flash", tp, 8, 1, SGD(0.1), crit=lm_crit))

    # ---- integrity on four data ranks: a replica desync and a minority
    # bitflip, each healed in place by the majority's broadcast ----------
    from bigdl_tpu_torch.parallel import DistriOptimizer as DO
    from bigdl_tpu_torch.telemetry import incident
    from bigdl_tpu_torch.utils import chaos
    for key, value in (("bigdl.integrity.everyN", 1),
                       ("bigdl.failure.retryTimes", 3),
                       ("bigdl.failure.retryTimeInterval", 0),
                       ("bigdl.incident.autoDump", False)):
        config.set_property(key, value)
    mesh4 = Engine.create_mesh((4,), ("data",))
    run("integ_clean", "integ", None, 64, 8, SGD(0.3, momentum=0.9), dp=4,
        mesh=mesh4)
    heal = DO._heal_desync
    for leg, key, value in (("desync", "bigdl.chaos.desyncReplicaAt", "4:3"),
                            ("bitflip", "bigdl.chaos.bitflipParamAt",
                             "4:2")):
        config.set_property(key, value)
        chaos.install()
        seen, since = [], len(incident.events())

        def spy(self, err, flat, seen=seen):
            seen.append((list(err.replicas), err.iteration))
            return heal(self, err, flat)

        DO._heal_desync = spy
        ck = os.path.join(outdir, f"ck_{leg}_{rank}")
        run(leg, "integ", None, 64, 8, SGD(0.3, momentum=0.9), dp=4,
            mesh=mesh4,
            setup=lambda o, ck=ck: o.set_checkpoint(ck,
                                                    several_iteration(1)))
        DO._heal_desync = heal
        chaos.uninstall()
        config.clear_property(key)
        out[f"{leg}/heals"] = np.array(json.dumps(seen))
        out[f"{leg}/events"] = np.array(json.dumps(
            [e["kind"] for e in incident.events()[since:]
             if e["kind"].startswith("optim/")]))
    config.clear_property("bigdl.integrity.everyN")

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


def _jax_integrity_refs(jmodel, x, y):
    """The JAX package's shard_map run over four devices with
    ``bigdl.integrity.everyN`` 1 (``tests/test_integrity.py``'s
    ``_train_shard_map`` at four replicas), which its injected runs match
    within ``_PARITY``."""
    from bigdl_tpu.utils import config as jconfig
    keys = {"bigdl.integrity.everyN": 1, "bigdl.pipeline.depth": 1}
    try:
        for k, v in keys.items():
            jconfig.set_property(k, v)
        return {"integ_clean": _jax_run(jmodel, x, y, 64, 8,
                                        joptim.SGD(0.3, momentum=0.9), (4,),
                                        ("data",))}
    finally:
        for k in keys:
            jconfig.clear_property(k)


def _aux_of(state):
    """The sum of every ``aux_loss`` in a JAX module-state tree."""
    if isinstance(state, dict):
        return sum((v if k == "aux_loss" else _aux_of(v))
                   for k, v in state.items())
    if isinstance(state, (list, tuple)):
        return sum(_aux_of(v) for v in state)
    return 0.0


def _jax_moe_oracle(jpp, x):
    """The MoE stacks run in turn (the JAX tests' oracle), in one jit: with
    capacity drops on each of the four microbatches (2 replicas x 2) with
    the mean aux_loss over the stages' executions, drop-free on the whole
    batch."""
    def fwd(params_drop, params_free, x):
        micro, aux = [], 0.0
        for mb in jnp.split(x, 4):
            for b, p in zip(jpp["moe_drop"], params_drop):
                mb, st = b.apply(p, mb, b.state)
                aux = aux + _aux_of(st)
            micro.append(mb)
        whole = x
        for b, p in zip(jpp["moe_free"], params_free):
            whole, _ = b.apply(p, whole, b.state)
        return jnp.concatenate(micro), aux / 8, whole

    micro, aux, whole = jax.jit(fwd)([b.params for b in jpp["moe_drop"]],
                                     [b.params for b in jpp["moe_free"]],
                                     jnp.asarray(x))
    return {"moe_drop": {"micro": np.asarray(micro), "aux": float(aux)},
            "moe_free": {"whole": np.asarray(whole)}}


def _jax_ring_refs(jmha, qkv, qkv_dp, mha_x):
    """The causal ring on a seq axis of four; full attention, the JAX ring
    tests' oracle, for the rest; the position table."""
    mesh4 = JaxEngine.create_mesh((4,), ("seq",), devices=jax.devices()[:4])
    q, k, v = (jnp.asarray(a) for a in qkv)
    ref = {"ring/True": np.asarray(jax.jit(
        lambda q, k, v: jax_ring(q, k, v, mesh4, causal=True))(q, k, v)),
        "ring/False": np.asarray(jax_attention(q, k, v))}
    xa = jnp.asarray(mha_x)
    loss_full = jax.jit(jax.value_and_grad(lambda p: (lambda o: (
        jnp.sum(o ** 2), o))(jmha.apply(p, xa, {})[0]), has_aux=True))
    (_, out), g = loss_full(jmha.params)
    ref["rsa"] = {"out": np.asarray(out),
                  "g": [np.asarray(t) for t in jax.tree_util.tree_leaves(g)]}
    ref["ring_dp"] = np.asarray(jax_attention(*(jnp.asarray(a)
                                                for a in qkv_dp)))
    ref["pe"] = np.asarray(JaxPE(8).forward(np.zeros((1, 16, 8),
                                                     np.float32)))
    return ref


def _jax_function_refs(pool, jpp, xy, jmha, qkv, qkv_dp, mha_x):
    """The JAX package's pure functions of the GPipe and ring legs, each a
    job of ``pool`` (their compiles run side by side): a future of a dict
    of references for each."""
    jobs = [pool.submit(lambda *a: {a[0]: _jax_pipe(*a[1:])}, leg,
                        jpp[key], *xy[key], shape, axes, n_micro, data_axis,
                        tp)
            for leg, key, shape, axes, n_micro, data_axis, tp in (
                ("pp4", "mlp4", (4,), ("stage",), 4, None, None),
                ("ppdp", "mlp2", (2, 2), ("data", "stage"), 4, "data",
                 None),
                ("pptp", "tp2", (2, 2), ("stage", "model"), 4, None,
                 "model"))]
    jobs.append(pool.submit(_jax_moe_oracle, jpp, xy["moe_drop"][0]))
    jobs.append(pool.submit(_jax_ring_refs, jmha, qkv, qkv_dp, mha_x))
    return jobs


def _jax_trainer_refs(jpp, xy, jlm, rows, jreg, x, y):
    """The JAX package's trainers on the pipeline, sequence-parallel and
    regularized dp x tp legs."""
    ref = {}
    # the 3-D run's oracle: the same stack on one device, full batch
    oracle = jnn.Sequential()
    for b in jpp["train3d"]:
        twin = jax_block(D, 2)
        twin._ensure_init()
        twin.params = jax.tree_util.tree_map(jnp.asarray, b.params)
        oracle.add(twin)
    ref["po_3d"] = _jax_run(oracle, *xy["train3d"], 8, 4,
                            joptim.SGD(0.2, momentum=0.9),
                            crit=jnn.MSECriterion())
    mesh = JaxEngine.create_mesh((2, 2), ("data", "stage"),
                                 devices=jax.devices()[:4])
    samples = [JaxSample(a, b) for a, b in zip(*xy["sharded"])]
    opt = JaxPipelineOptimizer(
        [copy.deepcopy(b) for b in jpp["mlp2"]],
        JaxShardedDataSet(samples, 2).transform(JaxSampleToMiniBatch(64, 2)),
        jnn.MSECriterion(), mesh=mesh, n_micro=2)
    opt.set_optim_method(joptim.SGD(0.5))
    opt.set_end_when(joptim.max_iteration(2))
    JaxRandomGenerator.RNG().set_seed(SEED)
    ref["po_dp"] = {"p": [np.asarray(v) for v in jax.tree_util.tree_leaves(
        opt.optimize().params)], "slots": {}}
    crit = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(),
                                        size_average=True)
    ref["sp_lm"] = _jax_run(copy.deepcopy(jlm), rows[:, :-1], rows[:, 1:],
                            8, 3, joptim.SGD(0.1, momentum=0.9), (2, 2),
                            ("data", "seq"), crit=crit)
    ref["tp_reg"] = _jax_run(jreg, x, y, 64, 4, joptim.SGD(0.2, momentum=0.9),
                             (2, 2), ("data", "model"))
    return ref


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
    jreg, preg = _np_twins(_tp_model, 11, tp=True, reg=True)
    jinteg, pinteg = _np_twins(_tp_model, 11, tp=False)
    jlm_init = copy.deepcopy(jlm)     # the tp_lm reference trains jlm
    x, y = _samples()
    rows = _lm_rows()
    long_rows = _lm_rows(t=2 * LM["max_len"])
    # the pipeline legs: JAX blocks and their port twins, and inputs
    jpp, ppp, xy = {}, {}, {}
    jpp["mlp4"], ppp["mlp4"] = _stages(_mlp_block, range(4))
    jpp["mlp2"], ppp["mlp2"] = _stages(_mlp_block, range(2))
    jpp["tp2"], ppp["tp2"] = _stages(_tp_block, range(2))
    jpp["moe_drop"], ppp["moe_drop"] = _stages(_t_block, range(2),
                                               moe_experts=2)
    jpp["moe_free"], ppp["moe_free"] = _stages(
        _t_block, range(2), moe_experts=2, moe_capacity_factor=2.0)
    jpp["train3d"], ppp["train3d"] = _stages(_t_block, (20, 21), tp=True)
    xy["mlp4"] = (_normal(1, 8, D), _normal(2, 8, D))
    xy["mlp2"] = (_normal(4, 16, D), _normal(5, 16, D))
    xy["tp2"] = (_normal(7, 8, D), _normal(8, 8, D))
    xy["moe_drop"] = xy["moe_free"] = (_normal(9, 8, 6, D),
                                       _normal(10, 8, 6, D))
    xy["train3d"] = (_normal(11, 8, 4, D), _normal(12, 8, 4, D))
    xs = _normal(13, 64, D)
    xy["sharded"] = (xs, np.tanh(xs @ (_normal(14, D, D) * 0.4)))
    xy["moe_train"] = (_normal(15, 16, 6, D), _normal(16, 16, 6, D))
    jmha, pmha = _np_twins(
        lambda mod, **kw: mod.MultiHeadAttention(32, 4, causal=True, **kw),
        3)
    qkv = tuple(_normal(20 + i, 2, 32, 2, 8) for i in range(3))
    qkv_dp = tuple(_normal(30 + i, 4, 32, 2, 8) for i in range(3))
    mha_x = _normal(40, 2, 32, 32)
    torch.save({"seed": SEED, "Sample": Sample, "mlp": pmlp,
                "moe_drop": pdrop, "moe_free": pfree, "lm": plm,
                "mlp_reg": preg, "integ": pinteg,
                "lm_flash": transformer_lm(VOCAB, tp=True, flash=True,
                                           device="cpu", **LM),
                "pp": dict(ppp, xy=xy, qkv=qkv, qkv_dp=qkv_dp, mha=pmha,
                           mha_x=mha_x),
                "data": {"mlp": (x, y), "moe": (x, y), "integ": (x, y),
                         "lm": (rows[:, :-1], rows[:, 1:]),
                         "long": (long_rows[:, :-1], long_rows[:, 1:])}},
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
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=3)
    try:
        jobs = _jax_function_refs(pool, jpp, xy, jmha, qkv, qkv_dp, mha_x)
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
        ref.update(_jax_trainer_refs(jpp, xy, jlm_init, rows, jreg, x, y))
        for job in jobs:
            ref.update(job.result())
        # the integrity keys are global to the JAX package: its
        # integrity run goes last, alone
        ref.update(_jax_integrity_refs(jinteg, x, y))
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
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
    ("ep_drop", "ep_drop"), ("ep_free", "ep_free"), ("tp_lm", "tp_lm"),
    ("sp_lm", "sp_lm"), ("sp_lm", "tp_lm"), ("tp_reg", "tp_reg")])
def test_mesh_leg_matches_jax(ranks, leg, against):
    """Every rank's weights and slots against the JAX package's run of the
    same leg (its dp x tp GSPMD or dp x ep shard_map mesh of the same
    shape, or ``LocalOptimizer`` over the full batch), and the ranks'
    weights bit-identical.  ``sp_lm`` is the tiny LM on a ``("data",
    "seq")`` mesh (ring attention, position offsets; the twin of
    ``tests/test_transformer.py``'s ``test_sp_training_matches_local``;
    its full-batch JAX ``LocalOptimizer`` run is ``tp_lm``'s, whose tags
    change nothing there), ``tp_reg`` the MLP with L2 regularizers under
    the dp x tp step."""
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
                                                     "expert": 2}),
    ("drv_sp", {"data": 2, "seq": 2}), ("drv_pp", {"data": 2, "stage": 2}),
    ("drv_pptp", {"stage": 2, "model": 2})])
def test_lm_driver_trains_on_the_mesh(ranks, leg, mesh):
    """``models/transformer/train.py``'s ``main(argv)`` with
    ``--partitions 2 --tensor-parallel 2``, with ``--moe-experts 4
    --partitions 2 --expert-parallel 2``, with ``--partitions 2
    --seq-parallel 2``, with ``--partitions 2 --pipeline 2 --remat full``
    and with ``--pipeline 2 --tensor-parallel 2``: the mesh the JAX driver
    builds, finite losses, the ranks' weights bit-identical."""
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
    ("seq_mesh", "ValueError: sequence-parallel training needs (N, T, "
                 "...) inputs"),
    ("flash_under_tp", "ValueError: flash kernel is incompatible"),
    ("model_with_seq", "ValueError: the tensor-parallel step composes "
                       "with 'data' only"),
    ("time_mixing_under_seq", "ValueError: sequence-parallel training "
                              "(mesh with a 'seq' axis) shards"),
    ("past_capacity", "ValueError: sequence length 16 exceeds a module's "
                      "position capacity 8")])
def test_mesh_refusals(ranks, name, error):
    """The JAX package's refusals on a mesh, with its error types: a
    ``seq`` mesh takes (N, T, ...) batches (the MLP's labels are not), a
    ``model`` axis composes with ``data`` alone, a recurrent module has no
    ring path, and a sequence past the position table raises rather than
    clamp (``tests/test_transformer.py:326``)."""
    outs, _ = ranks
    for out in outs:
        assert str(out[f"refuse/{name}"]).startswith(error), \
            str(out[f"refuse/{name}"])


# ---------------------------------------------- GPipe and ring attention

#: pipeline_apply: forward and gradients, the JAX package's own tolerances
#: (``tests/test_pipeline.py``: 1e-5 / 1e-6 forward, 1e-4 / 1e-6
#: gradients; MoE blocks 1e-4 / 1e-5)
FWD, GRAD, MOE = (1e-5, 1e-6), (1e-4, 1e-6), (1e-4, 1e-5)
#: which stage each rank runs, by leg
STAGE_OF = {"pp4": lambda r: r, "ppdp": lambda r: r % 2,
            "pptp": lambda r: r // 2}


@pytest.mark.parametrize("leg", ["pp4", "ppdp", "pptp"])
def test_pipeline_apply_matches_jax(ranks, leg):
    """``pipeline_apply`` on a ``stage`` axis of four, ``("data",
    "stage")`` 2 x 2 and ``("stage", "model")`` 2 x 2 (Megatron-split
    stages): every rank's output (the whole batch), loss and its stage's
    gradients against the JAX package's pipeline on the same mesh shape
    (the twins of ``tests/test_pipeline.py:36-330``); dense blocks carry an
    ``aux_loss`` of exactly 0."""
    outs, ref = ranks
    r_ = ref[leg]
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out[f"{leg}/out"], r_["out"],
                                   rtol=FWD[0], atol=FWD[1])
        np.testing.assert_allclose(out[f"{leg}/loss"], r_["loss"],
                                   rtol=FWD[0], atol=FWD[1])
        assert float(out[f"{leg}/aux"]) == 0.0 == r_["aux"]
        got = _port(out, leg, "g")
        want = r_["g"][STAGE_OF[leg](rank)]
        assert len(got) == len(want) and got
        for i, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_allclose(a, b, rtol=GRAD[0], atol=GRAD[1],
                                       err_msg=f"{leg} rank {rank} grad {i}")


@pytest.mark.parametrize("leg,against", [("moe_drop", "micro"),
                                         ("moe_free", "whole")])
def test_pipeline_moe_batch_semantics_and_aux(ranks, leg, against):
    """MoE transformer stages on ``("data", "stage")`` 2 x 2: with capacity
    drops the pipeline equals the JAX stack run in turn on each microbatch;
    drop-free (capacity factor >= experts / top_k) it equals the whole
    batch's forward (``tests/test_pipeline.py``'s MoE cases).  Its
    ``aux_loss`` is the mean over the stages' real microbatch executions
    (checked against the JAX stacks with drops; drop-free, at least 0.99
    at a near-uniform initial router, ``tests/test_parallel_trainers.py:
    361``)."""
    outs, ref = ranks
    for out in outs:
        np.testing.assert_allclose(out[f"{leg}/out"], ref[leg][against],
                                   rtol=MOE[0], atol=MOE[1])
        if leg == "moe_drop":
            np.testing.assert_allclose(out[f"{leg}/aux"], ref[leg]["aux"],
                                       rtol=MOE[0], atol=MOE[1])
    if leg == "moe_free":
        assert all(float(out["moe_free/aux"]) >= 0.99 for out in outs)


@pytest.mark.parametrize("leg", ["po_3d", "po_dp"])
def test_pipeline_optimizer_matches_jax(ranks, leg):
    """``PipelineOptimizer``: ``po_3d`` trains two Megatron-tagged
    transformer blocks on a ``("data", "stage", "model")`` 1 x 2 x 2 mesh
    against the JAX package's single-device oracle (the twin of
    ``test_dp_pp_tp_training_matches_single_device``, rtol 2e-4 / atol
    2e-5); ``po_dp`` trains MLP stages on ``("data", "stage")`` 2 x 2 from
    a two-partition ``ShardedDataSet`` against the JAX package's
    ``PipelineOptimizer`` on the same mesh, each step on the global batch
    of both partitions' minibatches.  Every rank publishes the same whole
    model, bit for bit."""
    outs, ref = ranks
    for rank, out in enumerate(outs):
        _assert_matches(out, leg, ref[leg], f"{leg} rank {rank}")
        assert np.all(np.isfinite(out[f"{leg}/loss"]))
        for a, b in zip(_port(out, leg, "p"), _port(outs[0], leg, "p")):
            assert np.array_equal(a, b)
    if leg == "po_dp":
        assert all(list(out["po_dp/records"]) == [64, 64] for out in outs)


def test_pipeline_optimizer_trains_moe_blocks(ranks):
    """MoE transformer stages train through ``PipelineOptimizer`` with the
    balance term in the objective: finite losses, the same whole model on
    every rank (``tests/test_parallel_trainers.py``'s
    ``test_pipeline_trainer_trains_moe_blocks``)."""
    outs, _ = ranks
    for out in outs:
        assert len(out["po_moe/loss"]) == 4
        assert np.all(np.isfinite(out["po_moe/loss"]))
        for a, b in zip(_port(out, "po_moe", "p"),
                        _port(outs[0], "po_moe", "p")):
            assert np.all(np.isfinite(a)) and np.array_equal(a, b)


#: ring attention: the JAX package's tolerances (``tests/test_attention.py``:
#: 2e-5 / 2e-6 outputs, 5e-4 / 5e-5 gradients)
RING, RING_GRAD = (2e-5, 2e-6), (5e-4, 5e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(ranks, causal):
    """``ring_attention`` on a ``seq`` axis of four, causal and not: each
    rank's slice of the sequence against the JAX package's ring on the
    same mesh (causal) and its full attention (not causal; the oracle of
    ``tests/test_attention.py``'s ring tests)."""
    outs, ref = ranks
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(
            out[f"ring/{causal}"], ref[f"ring/{causal}"][:, 8 * rank:
                                                         8 * rank + 8],
            rtol=RING[0], atol=RING[1])


def test_ring_self_attention_and_its_gradients(ranks):
    """``ring_self_attention`` of a causal ``MultiHeadAttention``: each
    rank's slice of the output, and the weights' gradients summed over the
    ranks (they flow back through ``ring_permute``), against the JAX
    module's full-sequence forward and gradients
    (``test_ring_self_attention_matches_module``,
    ``test_gradients_flow_through_ring``)."""
    outs, ref = ranks
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(
            out["rsa/out"], ref["rsa"]["out"][:, 8 * rank:8 * rank + 8],
            rtol=RING[0], atol=RING[1])
        got = _port(out, "rsa", "g")
        assert len(got) == len(ref["rsa"]["g"]) == 8
        for a, b in zip(got, ref["rsa"]["g"]):
            np.testing.assert_allclose(a, b, rtol=RING_GRAD[0],
                                       atol=RING_GRAD[1])


def test_ring_on_a_data_seq_mesh_and_position_offsets(ranks):
    """On ``("data", "seq")`` 2 x 2 each rank attends its rows' time block
    through the ring (against the JAX package's full attention, as
    ``test_2d_mesh_data_and_seq``); under a bound ``seq`` axis of four each
    ``PositionalEncoding`` shard adds its chunk of the table."""
    outs, ref = ranks
    for rank, out in enumerate(outs):
        d, s = divmod(rank, 2)
        np.testing.assert_allclose(
            out["ring_dp"], ref["ring_dp"][2 * d:2 * d + 2,
                                           16 * s:16 * s + 16],
            rtol=RING[0], atol=RING[1])
        np.testing.assert_allclose(out["pe"],
                                   ref["pe"][:, 4 * rank:4 * rank + 4],
                                   atol=1e-6, rtol=0)


# ---------------------------------------------------- in one process

def _block_mesh(shape, axes):
    """A mesh of ``shape`` seen from rank 0 without a process group: the
    guards below raise before any collective."""
    from bigdl_tpu_torch.engine import Mesh
    return Mesh(shape, axes)


@pytest.mark.parametrize("refusal", [
    "flash_with_seq", "tp_with_seq", "seq_cross_attention",
    "stateful_block", "stochastic_without_rng", "microbatch_guard",
    "stage_count", "ppdp_batch_guard", "unwired_split", "stochastic_pptp",
    "fp32_only", "block_count", "stateful_embed"])
def test_sharding_refusals_in_one_process(refusal):
    """The JAX package's refusals of sequence and pipeline parallelism
    that need no process group, with its error types
    (``bigdl_tpu/nn/attention.py:222-231,327-329``,
    ``parallel/pipeline.py:93-113,160-190,296-342``)."""
    from bigdl_tpu_torch.engine import bind_axes
    from bigdl_tpu_torch.parallel import (PipelineOptimizer, pipeline_apply,
                                          stack_stage_params, stage_tp_specs,
                                          wire_model_parallel)
    mha = pnn.MultiHeadAttention
    blocks = [_mlp_block(pnn, device="cpu") for _ in range(4)]
    stacked = stack_stage_params([dict(b.named_parameters())
                                  for b in blocks])
    stage1 = _block_mesh((1,), ("stage",))
    x = torch.zeros(8, D)
    if refusal == "flash_with_seq":
        for m in (mha(128, 1, flash=True, device="cpu"),
                  jnn.MultiHeadAttention(128, 1, flash=True)):
            with pytest.raises(ValueError, match="mutually exclusive"):
                m.set_sequence_parallel("seq")
    elif refusal == "tp_with_seq":
        with pytest.raises(ValueError, match="pick one of model_parallel"):
            mha(16, 2, device="cpu").set_model_parallel(
                "model").set_sequence_parallel("seq")
        with pytest.raises(ValueError, match="pick one of model_parallel"):
            mha(16, 2, device="cpu").set_sequence_parallel(
                "seq").set_model_parallel("model")
    elif refusal == "seq_cross_attention":
        m = mha(16, 2, device="cpu").set_sequence_parallel("seq")
        with bind_axes(_block_mesh((1,), ("seq",)), ["seq"]):
            with pytest.raises(ValueError, match="self-attention only"):
                m([torch.zeros(1, 4, 16), torch.zeros(1, 6, 16)])
    elif refusal == "stateful_block":
        bn = pnn.Sequential().add(pnn.BatchNormalization(D, device="cpu"))
        with pytest.raises(ValueError, match="stateless"):
            pipeline_apply(bn, stack_stage_params(
                [dict(bn.named_parameters())]), x, 4, stage1)
    elif refusal == "stochastic_without_rng":
        drop = pnn.Sequential().add(pnn.Dropout(0.5))
        with pytest.raises(ValueError, match="needs an rng"):
            pipeline_apply(drop, {}, x, 4, stage1, training=True)
    elif refusal == "microbatch_guard":
        one = stack_stage_params([dict(blocks[0].named_parameters())])
        for xb, n_micro in ((torch.zeros(7, D), 4), (x, 0)):
            with pytest.raises(ValueError, match="microbatch"):
                pipeline_apply(blocks[0], one, xb, n_micro, stage1)
    elif refusal == "stage_count":
        with pytest.raises(ValueError, match="4 stages but the 'stage' "
                                             "axis has 2"):
            pipeline_apply(blocks[0], stacked, x, 4,
                           _block_mesh((2,), ("stage",)))
    elif refusal == "ppdp_batch_guard":
        with pytest.raises(ValueError, match="must divide"):
            pipeline_apply(blocks[0], stacked, torch.zeros(7, D), 1,
                           _block_mesh((2, 4), ("data", "stage")),
                           data_axis="data")
    elif refusal == "unwired_split":
        tp_b = _tp_block(pnn, device="cpu")
        specs = stage_tp_specs(tp_b)
        with pytest.raises(ValueError, match="wire_model_parallel"):
            pipeline_apply(tp_b, stack_stage_params(
                [dict(tp_b.named_parameters())]), x, 4,
                _block_mesh((1, 1), ("stage", "model")), param_specs=specs)
    elif refusal == "stochastic_pptp":
        drop = _tp_block(pnn, device="cpu").add(pnn.Dropout(0.1))
        with pytest.raises(ValueError, match="deterministic"):
            wire_model_parallel(drop, "model")
    elif refusal == "fp32_only":
        opt = PipelineOptimizer(blocks[:1], [], pnn.MSECriterion(),
                                mesh=stage1, device="cpu")
        with pytest.raises(ValueError, match="fp32-only"):
            opt.set_precision("bf16").optimize()
    elif refusal == "block_count":
        with pytest.raises(ValueError, match="one stage per device"):
            PipelineOptimizer(blocks[:2], [], pnn.MSECriterion(),
                              mesh=stage1, device="cpu")
    else:
        bn = pnn.Sequential().add(pnn.BatchNormalization(D, device="cpu"))
        with pytest.raises(ValueError, match="stateless"):
            PipelineOptimizer(blocks[:1], [], pnn.MSECriterion(),
                              mesh=stage1, embed=bn, device="cpu")


def test_bottle_matches_jax_and_the_spec_walk_sees_through_it():
    """``Bottle`` folds the leading dims into one batch dim around its
    module, as the JAX package's (outputs within 1e-6), and the
    tensor-parallel spec walk reaches a tagged ``Linear`` inside it (the
    JAX package's ``[inner]`` entry)."""
    from bigdl_tpu.nn.structural import Bottle as JaxBottle
    from bigdl_tpu.parallel.tensor_parallel import tp_specs as jax_tp_specs
    from bigdl_tpu_torch.parallel.tensor_parallel import tp_specs
    jm, pm = _np_twins(lambda mod, **kw: mod.Sequential().add(
        (JaxBottle if mod is jnn else pnn.Bottle)(
            mod.Linear(4, 3, **kw), 2, 2)).add(mod.Tanh()), 5)
    x = _normal(6, 2, 5, 4)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    want, _ = jm.apply(jm.params, jnp.asarray(x), jm.state)
    assert got.shape == (2, 5, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    up, down = pnn.Linear(4, 8, device="cpu"), pnn.Linear(8, 4, device="cpu")
    jup, jdown = jnn.Linear(4, 8), jnn.Linear(8, 4)
    mine = tp_specs(pnn.Sequential().add(pnn.Bottle(column_parallel(up)))
                    .add(pnn.Bottle(row_parallel(down))))
    theirs = jax_tp_specs(jnn.Sequential().add(JaxBottle(jax_column(jup)))
                          .add(JaxBottle(jax_row(jdown))))
    # the port's Linear weight is (out, in): its split dims are the JAX
    # package's, reversed
    assert [[{k: tuple(reversed(v)) if k == "weight" else tuple(v)
              for k, v in b[0].items()}] for b in mine] == \
        [[{k: tuple(v) for k, v in b[0].items()}] for b in theirs]


def test_convert_round_trips_stacked_stage_trees():
    """``params_from_jax`` loads the JAX package's stacked stage tree
    (``stack_stage_params``) into a list of per-stage port blocks, row i
    into block i, and ``params_to_jax`` of the list gives the stacked tree
    back, bit for bit."""
    from bigdl_tpu_torch.utils.convert import params_to_jax
    jblocks, _ = _stages(_t_block, (1, 2), moe_experts=2)
    stacked = jax.tree_util.tree_map(np.asarray, jpipe.stack_stage_params(
        [b.params for b in jblocks]))
    port = [transformer_block(D, 2, moe_experts=2, device="cpu")
            for _ in range(2)]
    assert params_from_jax(stacked, port) is port
    for i, b in enumerate(port):
        for a, c in zip(jax.tree_util.tree_leaves(params_to_jax(b)),
                        jax.tree_util.tree_leaves(jblocks[i].params),
                        strict=True):
            np.testing.assert_array_equal(a, np.asarray(c))
    for a, c in zip(jax.tree_util.tree_leaves(params_to_jax(port)),
                    jax.tree_util.tree_leaves(stacked), strict=True):
        np.testing.assert_array_equal(a, c)


def test_pipeline_snapshot_resume_and_reshard(ranks):
    """A ``PipelineOptimizer`` snapshot of Megatron-split stages
    (``("stage", "model")`` 2 x 2) holds the whole model and canonical
    slots, with the mesh and ``step="pipeline"`` in its manifest; resumed
    on the same mesh it gives the straight run's bits, and restored onto
    a ``("data", "stage")`` mesh it reshards and trains on."""
    outs, _ = ranks
    for out in outs:
        assert json.loads(str(out["pckpt/topology"])) == {
            "axes": {"model": 2, "stage": 2}, "device_count": 4,
            "slot_axis": None, "step": "pipeline"}
        for a, b in zip(_port(out, "po_resumed", "p") +
                        _port(out, "po_resumed", "dfdx"),
                        _port(out, "po_straight", "p") +
                        _port(out, "po_straight", "dfdx")):
            assert np.array_equal(a, b)
        np.testing.assert_array_equal(out["po_resumed/loss"],
                                      out["po_straight/loss"][2:])
        assert len(out["po_moved/loss"]) == 2
        assert np.all(np.isfinite(out["po_moved/loss"]))


@pytest.mark.parametrize("leg,replica,onset", [("desync", 3, 5),
                                               ("bitflip", 2, 4)])
def test_replica_faults_heal_in_place_as_in_jax(ranks, leg, replica, onset):
    """Four data ranks with ``bigdl.integrity.everyN`` 1 (the twins of
    ``tests/test_integrity.py``'s shard_map cases): ``desyncReplicaAt
    "4:3"`` (rank 3's copy drifts after step 4, seen at step 5) and
    ``bitflipParamAt "4:2"`` (rank 2's copy flips a bit before step 4)
    each raise a ``ReplicaDesyncError`` naming that one rank, heal by the
    majority's broadcast without a restore, and end with the weights of
    the port's uninjected run, bit for bit, and of the JAX package's
    shard_map run within ``tests/test_integrity.py``'s ``_PARITY`` (rtol
    1e-5, atol 1e-7: the JAX test holds its healed runs to that run with
    it)."""
    outs, ref = ranks
    for rank, out in enumerate(outs):
        assert json.loads(str(out[f"{leg}/heals"])) == [[[replica], onset]]
        events = json.loads(str(out[f"{leg}/events"]))
        assert "optim/desync_heal" in events
        assert "optim/retry_restore" not in events
        for a, b in zip(_port(out, leg, "p"), _port(out, "integ_clean",
                                                    "p")):
            assert np.array_equal(a, b), f"{leg} rank {rank}"
        for i, (a, b) in enumerate(zip(_port(out, leg, "p"),
                                       ref["integ_clean"]["p"])):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{leg} rank {rank} {i}")
