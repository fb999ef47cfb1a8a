"""The port's transformer LM held against the JAX package's.

``transformer_lm(vocab 64, d_model 128, n_head 1, n_layers 2, max_len 256)``
is built in both packages; the JAX parameters are carried over with
``params_from_jax`` (initial weights cannot match across frameworks).  Token
ids (2, 128) come from a numpy seed.

Tolerances: fp32 log-probs atol 1e-4 (the same fp32 sums in other orders
through 2 blocks and a 64-way log-softmax).  bf16 through
``mixed_precision_forward`` against the JAX package's bf16 forward: atol
0.0625, two bf16 steps at the log-probs' magnitude (|log p| in [4, 8), where
bf16's spacing is 1/32): the two frameworks round intermediates to bf16 at
different places.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import PositionOutOfRange as JaxPOR
from bigdl_tpu.models.transformer import _default_remat as jax_default_remat
from bigdl_tpu.models.transformer import transformer_lm as jax_lm
from bigdl_tpu.optim.optimizer import \
    mixed_precision_forward as jax_mixed_precision_forward
from bigdl_tpu_torch.models.transformer import (PositionOutOfRange,
                                                transformer_lm)
from bigdl_tpu_torch.optim.optimizer import mixed_precision_forward
from bigdl_tpu.utils import config as jconfig
from bigdl_tpu_torch.utils import config as pconfig
from bigdl_tpu_torch.utils.convert import params_from_jax

VOCAB, D_MODEL, N_HEAD, N_LAYERS, MAX_LEN = 64, 128, 1, 2, 256
SHAPE = dict(d_model=D_MODEL, n_head=N_HEAD, n_layers=N_LAYERS,
             max_len=MAX_LEN)


@pytest.fixture(scope="module")
def jax_model():
    m = jax_lm(VOCAB, **SHAPE)
    m.reset(jax.random.PRNGKey(0))
    return m


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(0).integers(
        1, VOCAB + 1, (2, 128)).astype(np.float32)


def _port(jm, flash):
    m = transformer_lm(VOCAB, flash=flash, device="cpu", **SHAPE)
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), m)


@pytest.mark.parametrize("flash", [True, False])
def test_log_probs_match_jax(jax_model, ids, flash):
    ref, _ = jax_model.apply(jax_model.params, jnp.asarray(ids),
                             jax_model.state)
    with torch.inference_mode():
        out = _port(jax_model, flash)(torch.from_numpy(ids)).numpy()
    assert out.shape == (2, 128, VOCAB)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("flash", [True, False])
def test_bf16_forward_matches_jax_bf16(jax_model, ids, flash):
    ref, _ = jax_mixed_precision_forward(
        jax_model, jax_model.params, jnp.asarray(ids), jax_model.state,
        "bf16", False, None)
    port = _port(jax_model, flash)
    with torch.inference_mode():
        out = mixed_precision_forward(port, torch.from_numpy(ids), "bf16")
    assert out.dtype == torch.float32
    # the model's own parameters stay fp32
    assert all(p.dtype == torch.float32 for p in port.parameters())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=0.0625,
                               rtol=0)


def test_sequence_past_the_table_raises_in_both(jax_model):
    long_ids = np.ones((1, MAX_LEN + 1), np.float32)
    with pytest.raises(JaxPOR):
        jax_model.apply(jax_model.params, jnp.asarray(long_ids),
                        jax_model.state)
    port = _port(jax_model, flash=False)
    with pytest.raises(PositionOutOfRange) as ei:
        port(torch.from_numpy(long_ids))
    assert ei.value.position == MAX_LEN and ei.value.max_len == MAX_LEN


def test_token_ids_are_one_based_and_clipped_like_jax(jax_model):
    """Ids cast to int, shifted by one and clipped into the table: 0 and
    ids past the vocabulary land on the first and last rows."""
    x = np.resize(np.array([0.0, 1.0, 2.7, VOCAB, VOCAB + 5], np.float32),
                  (1, 128))
    ref, _ = jax_model.apply(jax_model.params, jnp.asarray(x),
                             jax_model.state)
    with torch.inference_mode():
        out = _port(jax_model, flash=True)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("kw", [{"tp": True}, {"moe_experts": 4},
                                {"remat": True}])
def test_options_outside_the_slice_raise(kw):
    with pytest.raises(NotImplementedError):
        transformer_lm(VOCAB, device="cpu", **SHAPE, **kw)


def test_builders_default_to_cuda_and_refuse_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer_lm(VOCAB, **SHAPE)


def test_params_from_jax_refuses_a_mismatched_tree(jax_model):
    port = transformer_lm(VOCAB, device="cpu", d_model=D_MODEL,
                          n_head=N_HEAD, n_layers=N_LAYERS + 1,
                          max_len=MAX_LEN)
    with pytest.raises(ValueError, match="child parameter trees"):
        params_from_jax(jax.tree_util.tree_map(np.asarray, jax_model.params),
                        port)


def test_same_seed_same_weights():
    a, b = (transformer_lm(VOCAB, device="cpu", seed=3, **SHAPE)
            for _ in range(2))
    c = transformer_lm(VOCAB, device="cpu", seed=4, **SHAPE)
    pa, pb, pc = (list(m.parameters()) for m in (a, b, c))
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    assert not all(torch.equal(x, y) for x, y in zip(pa, pc))


REMAT_KEY, REMAT_ENV = "bigdl.remat.policy", "BIGDL_REMAT_POLICY"
REMAT_PRESETS = [None, "off", "none", "false", "nothing", "true", "dots",
                 "save_attn"]


@contextlib.contextmanager
def remat_preset(value, via: str):
    """The ``bigdl.remat.policy`` preset set in both packages, through
    ``set_property`` or through the environment (``None``: unset), and
    every override and the environment restored after."""
    saved = [(mod, REMAT_KEY in mod._OVERRIDES,
              mod._OVERRIDES.get(REMAT_KEY)) for mod in (jconfig, pconfig)]
    env = os.environ.get(REMAT_ENV)
    try:
        if via == "property":
            for mod in (jconfig, pconfig):
                mod.set_property(REMAT_KEY, value)
        else:
            for mod in (jconfig, pconfig):
                mod.clear_property(REMAT_KEY)
            os.environ.pop(REMAT_ENV, None)
            if value is not None:
                os.environ[REMAT_ENV] = value
        yield
    finally:
        for mod, had, old in saved:
            if had:
                mod.set_property(REMAT_KEY, old)
            else:
                mod.clear_property(REMAT_KEY)
        if env is None:
            os.environ.pop(REMAT_ENV, None)
        else:
            os.environ[REMAT_ENV] = env


@pytest.mark.parametrize("via", ["property", "env"])
@pytest.mark.parametrize("preset", REMAT_PRESETS)
def test_remat_preset_raises_where_the_reference_remats(preset, via):
    """The port raises exactly where the JAX package's ``_default_remat``
    resolves the preset to remat, and builds otherwise."""
    with remat_preset(preset, via):
        remats = bool(jax_default_remat(False))
        if remats:
            with pytest.raises(NotImplementedError, match="remat"):
                transformer_lm(VOCAB, device="cpu", **SHAPE)
        else:
            assert transformer_lm(VOCAB, device="cpu", **SHAPE) is not None
    assert remats == (preset in ("nothing", "true", "dots", "save_attn"))


@pytest.mark.parametrize("remat,preset", [(None, "dots"), (True, "off")])
def test_explicit_remat_argument_wins_over_the_preset(remat, preset):
    with remat_preset(preset, "property"):
        assert jax_default_remat(remat) is remat
        if remat:
            with pytest.raises(NotImplementedError, match="remat"):
                transformer_lm(VOCAB, device="cpu", remat=remat, **SHAPE)
        else:
            transformer_lm(VOCAB, device="cpu", remat=remat, **SHAPE)
