"""The sharding refusals that need no ranks, ``Bottle`` and the conversion of
stacked stage trees, held against the JAX package.

Split from ``test_torch_port_model_parallel.py``,
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
from bigdl_tpu.parallel import pipeline as jpipe
from bigdl_tpu.parallel.tensor_parallel import (column_parallel as jax_column,
                                                row_parallel as jax_row)
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu_torch.models.transformer import transformer_block
from bigdl_tpu_torch.parallel.tensor_parallel import (column_parallel,
                                                      row_parallel)
from bigdl_tpu_torch.utils.convert import params_from_jax

from test_torch_port_model_parallel import (_block_mesh, _mlp_block, _normal,
                                            _np_twins, _stages, _t_block,
                                            _tp_block, D)


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
