"""The port's ``LMServingEngine`` and paged KV cache held against the JAX
package's.

The tiny LM of ``tests/test_lm_serving.py`` (vocab 32, d_model 16, 2 heads,
2 layers, max_len 64, JAX seed 3) is built in both packages, the JAX
parameters carried over with ``params_from_jax``; a second one has
vocab 48 != d_model, so a ``Linear`` weight read untransposed fails.  The
engines take ``max_batch`` 4, ``max_context`` 32, ``block_size`` 4; the
port's runs with ``device="cpu"``, where the decode step runs eagerly (a
CUDA device replays it as a CUDA graph, which ``chip_smoke.py`` checks).
Prompts come from numpy seeds.

Tolerances, all fp32: attention and positional rows atol 1e-6 (the same
sums); one prefill and one decode step from the same pools, log-probs atol
1e-5 and every pool block but the dump block atol 1e-6; ``generate``
against the JAX package's, identical tokens and log-probs atol 1e-4 (as
``tests/test_torch_port_lm.py``, over up to 12 chained steps); the port's
``generate`` against its own ``generate_sequential``, identical tokens and
rtol/atol 1e-5, as the JAX package asserts of its own.  Every engine is
closed, which joins its scheduler thread.

The int8 tier: ``_quantize_params`` equals the JAX package's bit for bit;
one fp prefill and one int8 decode step from the same pools, log-probs atol
1e-5; int8 ``generate`` against the JAX int8 engine's, identical tokens and
log-probs atol 1e-4; the gate's ``max_abs_diff`` within 1e-5 of JAX's.  The
failure taxonomy runs the same keys and chaos plan through both packages'
engines (``both``; config, chaos and the preemption flag are each
package's own and process-wide, so every test's keys are cleared in both):
the hung-decode watchdog at stallFactor 50 (a decode EMA of a few ms here)
against a 1 s wedge, ``pollInterval`` 0.2 s so the cooldown stays up long
enough to be observed, and streams submitted before ``start()`` so that
the chaos hooks meet the same slots in both.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.transformer import PositionalEncoding as JaxPE
from bigdl_tpu.models.transformer import transformer_lm as jax_lm
from bigdl_tpu import serving as jax_serving
from bigdl_tpu.serving import LMServingEngine as JaxLMServingEngine
from bigdl_tpu.serving import lm as jax_lm_serving
from bigdl_tpu.utils import chaos as jax_chaos
from bigdl_tpu.utils import config as jax_config
from bigdl_tpu.utils import elastic as jax_elastic
import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch import serving as port_serving
from bigdl_tpu_torch.models.transformer import (PositionalEncoding,
                                                PositionOutOfRange,
                                                transformer_lm)
from bigdl_tpu_torch.resources import preflight_pool
from bigdl_tpu_torch.serving import LMServingEngine, Overloaded, PagedKVCache
from bigdl_tpu_torch.serving import lm as port_lm_serving
from bigdl_tpu_torch.serving.engine import OUTCOMES
from bigdl_tpu_torch.serving.kv_cache import DUMP_BLOCK
from bigdl_tpu_torch.utils import chaos, config, elastic
from bigdl_tpu_torch.utils.convert import params_from_jax
from test_torch_port_analysis import port_lock_witness  # noqa: F401

VOCAB = 32
SHAPE = dict(d_model=16, n_head=2, n_layers=2, max_len=64)
ENGINE = dict(max_batch=4, max_context=32, block_size=4, deadline_ms=30000.0)
WEDGE = 1.0       # seconds of every injected wedge
_KEYS = ("bigdl.lm.quantize", "bigdl.lm.stallFactor", "bigdl.lm.warmupSteps",
         "bigdl.lm.pollInterval", "bigdl.lm.quantizeRtol",
         "bigdl.lm.quantizeAtol", "bigdl.chaos.poisonPromptAt",
         "bigdl.chaos.hangDecodeAt", "bigdl.chaos.evictBlockAt")
#: (package name, its serving package, its chaos, its config, its elastic)
PACKAGES = (("jax", jax_serving, jax_chaos, jax_config, jax_elastic),
            ("port", port_serving, chaos, config, elastic))


@pytest.fixture(autouse=True)
def _clean_keys():
    yield
    for _, _, ch, cfg, el in PACKAGES:
        ch.uninstall()
        el.clear_preemption()
        for k in _KEYS:
            cfg.clear_property(k)


def both(**keys):
    """Set ``bigdl.*`` keys (dots as ``__``) in both packages and arm both
    chaos plans."""
    for _, _, ch, cfg, _ in PACKAGES:
        for k, v in keys.items():
            cfg.set_property(k.replace("__", "."), v)
        ch.install()


def _pair_engine(pkg, models, **kw):
    """A fresh engine of either package over the same weights (the JAX
    one compiles its steps at first use: prompts of 4 ids keep that to
    one prefill bucket)."""
    kw = {**ENGINE, **kw}
    if pkg == "jax":
        return JaxLMServingEngine(models[0], **kw)
    return LMServingEngine(models[1], device="cpu", **kw)


def _verdict(s, err=None):
    """(outcome, reason) of one submission: an Overloaded's reason, or the
    terminal error's class name."""
    if s is None:
        return ("rejected", err.reason)
    e = s.error()
    return (s.outcome, type(e).__name__ if e is not None else None)


def _models(vocab=VOCAB, seed=3):
    jm = jax_lm(vocab, **SHAPE)
    jm.reset(jax.random.PRNGKey(seed))
    pm = transformer_lm(vocab, device="cpu", **SHAPE)
    params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), pm)
    return jm, pm


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def jax_engine(models):
    # built once: its steps compile at first use, the file's main cost
    eng = JaxLMServingEngine(models[0], **ENGINE)
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def offline(models):
    """A port engine for the offline paths (never started)."""
    eng = LMServingEngine(models[1], device="cpu", **ENGINE)
    eng.warmup()
    yield eng
    eng.close()


def _engine(model, warm=True, **kw):
    eng = LMServingEngine(model, device="cpu", **{**ENGINE, **kw})
    if warm:
        eng.warmup()
    return eng


def _prompt(n, seed=0, vocab=VOCAB):
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab + 1, size=n).astype(np.int32)


def _identity(stats):
    assert stats["unaccounted"] == 0, stats
    assert sum(stats[o] for o in OUTCOMES) == stats["submitted"], stats


def _np(x):
    return np.asarray(x.detach().cpu().numpy()
                      if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# (a) attention and positional rows
# ---------------------------------------------------------------------------

def test_paged_attention_matches_jax_fully_masked_row_finite():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((3, 1, 2, 8)).astype(np.float32)
    k, v = (rng.standard_normal((3, 12, 2, 8)).astype(np.float32)
            for _ in range(2))
    valid = np.arange(12)[None, :] <= np.array([[4], [11], [-1]])
    ref = jnn.attention.paged_attention(q, k, v, valid)
    got = nn.paged_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             torch.from_numpy(valid))
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_masked_sdpa_matches_jax(causal):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 5, 2, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 7, 2, 8)).astype(np.float32)
            for _ in range(2))
    mask = rng.random((2, 1, 5, 7)) < 0.6
    mask[1, 0, 2] = False                      # one fully masked row
    ref = jnn.attention.scaled_dot_product_attention(q, k, v, causal=causal,
                                                     mask=mask)
    got = nn.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        mask=torch.from_numpy(mask))
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-6, rtol=0)


def test_project_step_and_attend_cached_match_jax():
    jm = jnn.MultiHeadAttention(16, 2, causal=True)
    jm.reset(jax.random.PRNGKey(4))
    pm = nn.MultiHeadAttention(16, 2, causal=True, device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), pm)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 1, 16)).astype(np.float32)
    k_ctx, v_ctx = (rng.standard_normal((3, 8, 2, 8)).astype(np.float32)
                    for _ in range(2))
    valid = np.arange(8)[None, :] <= np.array([[2], [7], [0]])
    with torch.no_grad():
        got = pm.project_step(torch.from_numpy(x))
        for a, b in zip(got, jm.project_step(jm.params, x)):
            np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-6,
                                       rtol=0)
        out = pm.attend_cached(got[0], torch.from_numpy(k_ctx),
                               torch.from_numpy(v_ctx),
                               torch.from_numpy(valid))
    ref = jm.attend_cached(jm.params, np.asarray(got[0]), k_ctx, v_ctx,
                           valid)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-6, rtol=0)


def test_positional_rows_and_offset_match_jax():
    jpe, ppe = JaxPE(16, 64), PositionalEncoding(16, 64, device="cpu")
    np.testing.assert_allclose(_np(ppe.rows([0, 5, 63])),
                               np.asarray(jpe.rows([0, 5, 63])), atol=1e-6)
    np.testing.assert_allclose(
        _np(ppe.rows(torch.tensor([3, 7]))),
        np.asarray(jpe.rows(jnp.asarray([3, 7]))), atol=1e-6)
    x = np.random.default_rng(3).standard_normal((2, 5, 16)).astype(
        np.float32)
    ref, _ = jpe.apply({}, x, {}, offset=3)
    np.testing.assert_allclose(_np(ppe(torch.from_numpy(x), offset=3)),
                               np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("case", ["rows", "offset"])
def test_position_out_of_range(case):
    ppe = PositionalEncoding(16, 64, device="cpu")
    with pytest.raises(PositionOutOfRange) as ei:
        if case == "rows":
            ppe.rows([2, 64])
        else:
            ppe(torch.zeros(1, 5, 16), offset=60)
    assert (ei.value.position, ei.value.max_len) == (64, 64)


# ---------------------------------------------------------------------------
# (b) one prefill and one decode step from the same pools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab", [VOCAB, 48])
def test_prefill_and_decode_steps_match_jax(vocab, request):
    bs, mb, n_blocks = 4, 8, 33
    if vocab == VOCAB:
        # the module's JAX engine steps at these shapes (its pool is (2, 33,
        # 4, 2, 8)); their compiles serve the generate tests too
        (jm, pm), jeng = (request.getfixturevalue("models"),
                          request.getfixturevalue("jax_engine"))
        jdp, j_pre, j_dec = jeng._dp, jeng._prefill, jeng._decode
    else:
        jm, pm = _models(vocab)
        jg = jax_lm_serving._LMGraph(jm)
        jdp = jax_lm_serving._extract_params(jg)
        j_pre = jax.jit(jax_lm_serving._build_prefill_fn(jg, bs))
        j_dec = jax.jit(jax_lm_serving._build_decode_fn(jg, bs, mb))
    pg = port_lm_serving._LMGraph(pm)
    pdp = port_lm_serving._extract_params(pg)
    p_pre = port_lm_serving._build_prefill_fn(pg, bs)
    p_dec = port_lm_serving._build_decode_fn(pg, bs, mb)
    shape = (2, n_blocks, bs, 2, 8)
    jk = jv = jnp.zeros(shape, jnp.float32)
    pk, pv = torch.zeros(shape), torch.zeros(shape)
    # sequence A: 9 ids in blocks 1-3 (bucket 16); B: 5 ids in blocks 4-5
    seqs = [(_prompt(9, 5, vocab), 16, [1, 2, 3]),
            (_prompt(5, 6, vocab), 8, [4, 5])]
    tables, firsts = [], []
    with torch.no_grad():
        for prompt, bucket, blocks in seqs:
            padded = np.ones((1, bucket), np.int32)
            padded[0, :prompt.size] = prompt
            table = np.full((mb,), DUMP_BLOCK, np.int32)
            table[:len(blocks)] = blocks
            jlp, jk, jv = j_pre(jdp, jk, jv, padded, np.int32(prompt.size),
                                table)
            plp = p_pre(pdp, pk, pv, torch.from_numpy(padded).long(),
                        prompt.size, torch.from_numpy(table).long())
            np.testing.assert_allclose(_np(plp), np.asarray(jlp), atol=1e-5,
                                       rtol=0)
            tables.append(table)
            firsts.append(int(np.argmax(np.asarray(jlp))) + 1)
        # decode: A at position 9 in slot 0, B at 5 in slot 2, 1 and 3 idle
        tokens = np.ones((4, 1), np.int32)
        positions = np.zeros((4,), np.int32)
        table_b = np.full((4, mb), DUMP_BLOCK, np.int32)
        active = np.zeros((4,), bool)
        for slot, (prompt, _, _), table, tok in zip((0, 2), seqs, tables,
                                                    firsts):
            tokens[slot, 0], positions[slot] = tok, prompt.size
            table_b[slot], active[slot] = table, True
        jlp, jk, jv = j_dec(jdp, jk, jv, tokens, positions, table_b, active)
        plp = p_dec(pdp, pk, pv, *(torch.from_numpy(a).long() for a in
                                   (tokens, positions, table_b)),
                    torch.from_numpy(active))
    assert plp.shape == (4, vocab)
    np.testing.assert_allclose(_np(plp)[active], np.asarray(jlp)[active],
                               atol=1e-5, rtol=0)
    for got, ref in ((pk, jk), (pv, jv)):
        np.testing.assert_allclose(_np(got)[:, 1:], np.asarray(ref)[:, 1:],
                                   atol=1e-6, rtol=0)
    assert np.abs(_np(pk)[:, 1:6]).max() > 0     # the steps wrote blocks 1-5
    assert not _np(pk)[:, 6:].any()               # and nothing beyond


# ---------------------------------------------------------------------------
# (c) generate: against the JAX package and against generate_sequential
# ---------------------------------------------------------------------------

def test_generate_matches_jax_engine(jax_engine, offline):
    p = _prompt(9, seed=5)
    jt, jl = jax_engine.generate(p, max_new_tokens=12, return_logps=True)
    pt, pl = offline.generate(p, max_new_tokens=12, return_logps=True)
    assert pt == jt and len(pl) == len(jl) == 11
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0)


@pytest.mark.parametrize("n", [1, 3, 8, 17])
def test_mixed_prompt_lengths_match_jax_and_sequential(n, jax_engine,
                                                       offline):
    p = _prompt(n, seed=n)
    got = offline.generate(p, max_new_tokens=4)
    assert got == jax_engine.generate(p, max_new_tokens=4)
    assert got == offline.generate_sequential(p, max_new_tokens=4)


def test_generate_matches_generate_sequential(offline):
    p = _prompt(9, seed=5)
    toks_paged, lp_paged = offline.generate(p, max_new_tokens=12,
                                            return_logps=True)
    toks_full, lp_full = offline.generate_sequential(p, max_new_tokens=12,
                                                     return_logps=True)
    assert toks_paged == toks_full
    # paged log-probs cover tokens 2..N (the prefill's first token has no
    # decode row); sequential covers 1..N
    assert len(lp_paged) == len(lp_full) - 1
    for a, b in zip(lp_paged, lp_full[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert offline.cache.used_blocks == 0
    assert offline.decode_captures == 0      # eager decode on the CPU


# ---------------------------------------------------------------------------
# (d) the paged KV cache's invariants
# ---------------------------------------------------------------------------

def _cache(n_blocks, block_size=4, n_layers=2, n_head=2, head_dim=8):
    return PagedKVCache(n_layers, n_head, head_dim, n_blocks=n_blocks,
                        block_size=block_size, device="cpu")


def test_exhaustion_is_structured_overloaded():
    cache = _cache(4)
    cache.allocate(1, 12)                     # 3 blocks = the pool
    with pytest.raises(Overloaded) as ei:
        cache.allocate(2, 8)
    assert ei.value.retriable
    assert ei.value.blocks_needed == 2 and ei.value.blocks_free == 0
    cache.free_seq(1)
    assert cache.can_allocate(8)


def test_dump_block_never_allocated():
    cache = _cache(5)
    blocks = cache.allocate(1, 16)            # the whole free-list
    assert DUMP_BLOCK not in blocks and sorted(blocks) == [1, 2, 3, 4]


def test_block_reuse_is_zero_scrubbed_bitwise():
    cache = _cache(12)
    blocks = cache.allocate(7, 40)            # 10 blocks
    cache.k[:, blocks] = 1.5
    cache.v[:, blocks] = -2.25
    k_before = cache.k
    cache.free_seq(7)
    assert cache.k is k_before                # scrubbed in place
    for pool in (cache.k, cache.v):
        assert not pool[:, blocks].view(torch.int32).any()   # zero bits
    assert sorted(cache.allocate(8, 40)) == sorted(blocks)


def test_double_allocate_and_idempotent_free():
    cache = _cache(3, block_size=2, n_layers=1, n_head=1, head_dim=4)
    cache.allocate(1, 2)
    with pytest.raises(ValueError, match="already holds"):
        cache.allocate(1, 2)
    assert cache.free_seq(1) == 1
    assert cache.free_seq(1) == 0


def test_pool_needs_room_beyond_the_dump_block():
    with pytest.raises(ValueError, match="dump block"):
        _cache(1, block_size=2)


def test_preflight_passes_through_on_the_cpu():
    assert preflight_pool(1 << 60, "huge", "cpu") == 1 << 60
    assert _cache(5).pool_nbytes == 2 * 2 * 5 * 4 * 2 * 8 * 4


# ---------------------------------------------------------------------------
# (e) the scheduler's contracts
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# (f) the open loop
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# (g) the recompile sentinels, in every configuration
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# (h) the int8 decode tier against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_pair(models):
    """The JAX int8 engine (its gate compiles the fp and int8 decode steps
    and prefill bucket 8) and the port's, neither started."""
    jeng = JaxLMServingEngine(models[0], quantize="int8", **ENGINE)
    peng = LMServingEngine(models[1], quantize="int8", device="cpu",
                           **ENGINE)
    yield jeng, peng
    jeng.close()
    peng.close()


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif tree is not None and not isinstance(tree, float):
        yield path, _np(tree)


# ---------------------------------------------------------------------------
# (i) the failure taxonomy, both packages under the same plan
# ---------------------------------------------------------------------------
