"""The LM's remat presets and arguments, held against the JAX package.

Split from ``test_torch_port_lm.py``,
whose docstring states what is held against the JAX package and with which
tolerances; the helpers and fixtures come from there.  No test file of the
port holds more than 25 tests: pytest-xdist's ``loadfile`` scheduler hands
out the largest files first (ROADMAP.md, standing rules).
"""

import pytest

from bigdl_tpu.models.transformer import _default_remat as jax_default_remat
from bigdl_tpu_torch.models.transformer import transformer_lm
from bigdl_tpu_torch.nn import Remat

from test_torch_port_lm import (remat_preset, REMAT_PRESETS, SHAPE, VOCAB)


@pytest.mark.parametrize("via", ["property", "env"])
@pytest.mark.parametrize("preset", REMAT_PRESETS)
def test_remat_preset_raises_where_the_reference_remats(preset, via):
    """The port wraps its blocks in ``Remat`` exactly where the JAX
    package's ``_default_remat`` resolves the preset to remat, with the
    same policy (``Remat`` is ported now; it raised before), and builds
    plain blocks otherwise."""
    with remat_preset(preset, via):
        remats = jax_default_remat(False)
        blocks = transformer_lm(VOCAB, device="cpu", **SHAPE).layers[2:-3]
    assert bool(remats) == (preset in ("nothing", "true", "dots",
                                       "save_attn"))
    if remats:
        policy = None if remats is True else remats
        assert all(isinstance(b, Remat) and b.policy == policy
                   for b in blocks)
    else:
        assert not any(isinstance(b, Remat) for b in blocks)


@pytest.mark.parametrize("remat,preset", [(None, "dots"), (True, "off")])
def test_explicit_remat_argument_wins_over_the_preset(remat, preset):
    with remat_preset(preset, "property"):
        assert jax_default_remat(remat) is remat
        blocks = transformer_lm(VOCAB, device="cpu", remat=remat,
                                **SHAPE).layers[2:-3]
        assert all(isinstance(b, Remat) == bool(remat) for b in blocks)
