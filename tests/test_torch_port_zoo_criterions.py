"""``TimeDistributedCriterion`` and ``ClassNLLCriterion``'s label 0, held
against the JAX package.

Split from ``test_torch_port_zoo_layers.py``,
whose docstring states what is held against the JAX package and with which
tolerances; the helpers and fixtures come from there.  No test file of the
port holds more than 25 tests: pytest-xdist's ``loadfile`` scheduler hands
out the largest files first (ROADMAP.md, standing rules).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu_torch.nn as pnn

from test_torch_port_zoo_layers import (criteria, td_inputs)


@pytest.mark.parametrize("kind", ["nll", "ce", "mse"])
@pytest.mark.parametrize("inner_avg", [True, False])
@pytest.mark.parametrize("outer_avg", [True, False])
def test_time_distributed_criterion_flat_path(kind, inner_avg, outer_avg,
                                              monkeypatch):
    """Unweighted ClassNLL, CrossEntropy and MSE take the flat path, whose
    value equals the unrolled sum over T and the JAX package's."""
    x, y = td_inputs(kind)
    jc, pc = criteria(kind, inner_avg)
    crit = pnn.TimeDistributedCriterion(pc, size_average=outer_avg)
    assert crit._separable()
    calls = []
    real = pc.apply
    monkeypatch.setattr(pc, "apply", lambda a, b: calls.append(1) or
                        real(a, b))
    flat = crit.apply(torch.from_numpy(x), torch.from_numpy(y))
    assert len(calls) == 1
    monkeypatch.setattr(crit, "_separable", lambda: False)
    unrolled = crit.apply(torch.from_numpy(x), torch.from_numpy(y))
    assert len(calls) == 1 + x.shape[1]
    np.testing.assert_allclose(flat.item(), unrolled.item(), rtol=1e-6)
    ref = jnn.TimeDistributedCriterion(jc, size_average=outer_avg).apply(
        jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(flat.item(), float(ref), rtol=1e-6)


def test_time_distributed_criterion_unrolls_weighted_criterions():
    w = np.arange(1, 6, dtype=np.float32)
    for inner in (pnn.ClassNLLCriterion(w), pnn.CrossEntropyCriterion(w)):
        assert not pnn.TimeDistributedCriterion(inner)._separable()
    x, y = td_inputs("nll")
    jc = jnn.TimeDistributedCriterion(jnn.CrossEntropyCriterion(w), True)
    pc = pnn.TimeDistributedCriterion(pnn.CrossEntropyCriterion(w), True)
    np.testing.assert_allclose(
        pc.apply(torch.from_numpy(x), torch.from_numpy(y)).item(),
        float(jc.apply(jnp.asarray(x), jnp.asarray(y))), rtol=1e-6)


def test_class_nll_label_zero_picks_the_last_class_as_jax_does():
    """Fixed-length sentences pad their labels with 0; both packages read
    it as the last class."""
    x, _ = td_inputs("nll")
    y = np.zeros((4, 6), np.float32)
    y[:, :3] = 2
    ref = jnn.ClassNLLCriterion().apply(jnp.asarray(x.reshape(-1, 5)),
                                        jnp.asarray(y.reshape(-1)))
    got = pnn.ClassNLLCriterion().apply(torch.from_numpy(x.reshape(-1, 5)),
                                        torch.from_numpy(y.reshape(-1)))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
