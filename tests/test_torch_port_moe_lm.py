"""The MoE LM with remat, its training, the tensor-parallel specs and the
JAX package's refusals.

Split from ``test_torch_port_moe.py``,
whose docstring states what is held against the JAX package and with which
tolerances; the helpers and fixtures come from there.  No test file of the
port holds more than 25 tests: pytest-xdist's ``loadfile`` scheduler hands
out the largest files first (ROADMAP.md, standing rules).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset import (LocalDataSet as JaxLocalDataSet,
                               SampleToMiniBatch as JaxSampleToMiniBatch)
from bigdl_tpu.dataset.sample import Sample as JaxSample
import bigdl_tpu_torch.nn as pnn
import bigdl_tpu_torch.optim as poptim
from bigdl_tpu_torch.dataset import LocalDataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.models.transformer import (transformer_block,
                                                transformer_lm,
                                                transformer_lm_pipeline)
from bigdl_tpu_torch.nn import MixtureOfExperts, MultiHeadAttention, Remat
from bigdl_tpu_torch.optim.optimizer import moe_aux_penalty
from bigdl_tpu_torch.parallel import PipelineOptimizer
from bigdl_tpu_torch.parallel.tensor_parallel import (column_parallel,
                                                      head_count_divisible, P,
                                                      row_parallel, tp_specs,
                                                      zero1_slot_spec)
from bigdl_tpu_torch.utils.convert import params_to_jax

from test_torch_port_moe import (_close, _fwd_bwd, _ids, _lm_twins, _np,
                                 _remat_variants, E, GRAD_ATOL, GRAD_RTOL, LM,
                                 LM1, seeded, VOCAB)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_lm_and_remat_match_jax(top_k):
    """The one-block MoE LM (E4) with its block wrapped in ``Remat`` under each
    policy (None, "nothing", "dots", "save_attn") and unwrapped, a chunked
    attention (chunk 8) inside: log-probs and gradients of a
    training-mode forward, the wrapped models against the unwrapped one
    from the same weights, and at top-1 against the JAX package's LM
    with ``Remat`` (jitted; its policies change what is saved, not the
    numbers).  Top-2 is held against the JAX package by
    :func:`test_moe_lm_trains_like_jax`."""
    jm, wrapped = _lm_twins(LM1, moe_experts=E, moe_top_k=top_k,
                            remat=True)
    ids = _ids()[:, :-1]
    w = np.random.default_rng(1).standard_normal(
        (2, LM["max_len"], VOCAB)).astype(np.float32)
    outs, grads = _fwd_bwd(_remat_variants(wrapped, top_k), ids, w)
    if top_k == 2:
        return

    def jloss(p):
        out = jm.apply(p, jnp.asarray(ids), jm.state, training=True)[0]
        return jnp.sum(out * w), out
    (_, ref), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jm.params)
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)
    got = copy.deepcopy(wrapped)
    with torch.no_grad():
        for p, g in zip(got.parameters(), grads[1]):
            p.copy_(g)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_jax(got)),
                    jax.tree_util.tree_leaves(_np(jg))):
        _close(a, b, GRAD_ATOL, GRAD_RTOL)


def test_moe_lm_trains_like_jax():
    """Three SGD-momentum steps of the MoE LM (top-2, E4) through
    ``Optimizer.create(...).optimize()`` in both packages, the aux penalty
    at the default weight 0.01: the trained weights and every layer's
    aux_loss."""
    jm, pm = _lm_twins(moe_experts=E, moe_top_k=2)
    rows = _ids(2, 8)
    opts = []
    with seeded(9):
        for model, mod, nn_mod, sample, lds, s2b in (
                (jm, joptim, jnn, JaxSample, JaxLocalDataSet,
                 JaxSampleToMiniBatch),
                (pm, poptim, pnn, Sample, LocalDataSet, SampleToMiniBatch)):
            ds = lds([sample(r[:-1], r[1:]) for r in rows]).transform(
                s2b(4))
            crit = nn_mod.TimeDistributedCriterion(nn_mod.ClassNLLCriterion(),
                                                   size_average=True)
            kw = {} if mod is joptim else {"device": "cpu"}
            opt = mod.Optimizer.create(model, ds, crit, **kw)
            assert opt.moe_aux_weight == 0.01
            opt.set_optim_method(mod.SGD(learning_rate=0.1, momentum=0.9))
            opt.set_end_when(mod.max_iteration(3)).optimize()
            opts.append(opt)
    assert all(np.isfinite(h["loss"]) for h in opts[1].history)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_jax(pm)),
                    jax.tree_util.tree_leaves(_np(jm.params))):
        _close(a, b, 1e-5, 0)
    jaux = [float(s[1][1]["aux_loss"]) for s in jm.state[2:4]]
    paux = [float(m.aux_loss) for m in pm.modules()
            if isinstance(m, MixtureOfExperts)]
    np.testing.assert_allclose(paux, jaux, rtol=1e-5)
    assert moe_aux_penalty(pnn.Sequential(), 0.01) is None


def test_remat_policies_and_dropout():
    """An unknown policy raises at construction and Remat wraps one module,
    as in the JAX package; a Dropout inside recomputes the same mask in
    the backward (the gradient equals the unwrapped module's on the same
    stream)."""
    with pytest.raises(ValueError, match="unknown remat policy"):
        Remat(pnn.Identity(), policy="dotz")
    with pytest.raises(ValueError, match="exactly one"):
        Remat(pnn.Identity()).add(pnn.Identity())
    g = torch.Generator().manual_seed(5)
    inner = (pnn.Sequential().add(pnn.Linear(6, 16, device="cpu",
                                             generator=g))
             .add(pnn.Dropout(0.5)).add(pnn.Linear(16, 3, device="cpu",
                                                   generator=g)))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, 6)).astype(np.float32))
    grads = []
    for model in (Remat(copy.deepcopy(inner), "dots"), inner):
        model.train()
        with pnn.random_stream(model, torch.Generator().manual_seed(7)):
            out = model(x)
            grads.append(torch.autograd.grad(out.square().sum(),
                                             list(model.parameters())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_tp_specs_match_jax():
    """The spec tree (the port's Linear is (out, in), so its column split
    is the first dim), the ZeRO-1 slot spec, the head-count and flash
    guards, and the refusal of a split module hidden in a composite."""
    m = (pnn.Sequential()
         .add(MultiHeadAttention(16, 8, causal=True, device="cpu"))
         .add(column_parallel(pnn.Linear(16, 32, device="cpu")))
         .add(pnn.ReLU())
         .add(row_parallel(pnn.Linear(32, 16, device="cpu"))))
    specs = tp_specs(m)
    assert specs[0]["wq"] == P(None, "model")
    assert specs[0]["wo"] == P("model", None)
    assert specs[1] == {"weight": P("model", None), "bias": P("model")}
    assert specs[3] == {"weight": P(None, "model"), "bias": P()}
    assert specs[2] == {}
    assert zero1_slot_spec((32, 16), specs[1]["weight"], 2) == \
        P("model", "data")
    assert zero1_slot_spec((16,), P("model"), 2) == P("model")

    class Mesh8:
        shape = {"model": 8}
    with pytest.raises(ValueError, match="divisible"):
        head_count_divisible(pnn.Sequential().add(
            MultiHeadAttention(12, 3, device="cpu")), Mesh8())
    with pytest.raises(ValueError, match="divisible"):
        tp_specs(pnn.Sequential().add(MultiHeadAttention(12, 3,
                                                         device="cpu")),
                 mesh=Mesh8())

    class Opaque(pnn.Module):
        def __init__(self):
            super().__init__()
            self.inner = MultiHeadAttention(16, 8, device="cpu")
    with pytest.raises(ValueError, match="nested inside composites"):
        tp_specs(pnn.Sequential().add(Opaque()))


@pytest.mark.parametrize("refusal", [
    "flash_chunk", "flash_tp_specs", "flash_head_split", "tp_with_moe",
    "pipeline"])
def test_jax_refusals_are_kept(refusal):
    """The JAX package's refusals, with its error types: flash with chunk,
    flash under the Megatron head split (``tp_specs`` and
    ``set_model_parallel``), tp with MoE in one block, also in the GPipe
    builder; the GPipe trainer without a ``stage`` axis.  (The mesh
    refusals need a process group:
    ``tests/test_torch_port_model_parallel.py``.)"""
    if refusal == "flash_chunk":
        with pytest.raises(ValueError, match="pick one"):
            MultiHeadAttention(128, 1, flash=True, chunk=64, device="cpu")
        with pytest.raises(ValueError, match="pick one"):
            jnn.MultiHeadAttention(128, 1, flash=True, chunk=64)
    elif refusal == "flash_tp_specs":
        with pytest.raises(ValueError, match="flash"):
            tp_specs(pnn.Sequential().add(
                MultiHeadAttention(128, 1, flash=True, device="cpu")))
    elif refusal == "flash_head_split":
        with pytest.raises(ValueError, match="flash"):
            MultiHeadAttention(128, 1, flash=True,
                               device="cpu").set_model_parallel("model")
    elif refusal == "tp_with_moe":
        with pytest.raises(ValueError, match="pick one of tp"):
            transformer_block(16, 2, tp=True, moe_experts=4, device="cpu")
        with pytest.raises(ValueError, match="pick one of tp"):
            transformer_lm(VOCAB, device="cpu", tp=True, moe_experts=4,
                           **LM)
    else:
        with pytest.raises(ValueError, match="pick one of tp"):
            transformer_lm_pipeline(VOCAB, device="cpu", tp=True,
                                    moe_experts=4, **LM)
        blocks = [transformer_block(16, 2, device="cpu")]
        with pytest.raises(ValueError, match="'stage' axis"):
            PipelineOptimizer(blocks, [], pnn.MSECriterion(),
                              device="cpu")
