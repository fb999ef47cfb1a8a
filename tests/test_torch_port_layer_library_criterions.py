"""The criterions of the port's layer library, held against the JAX package.

Split from ``test_torch_port_layer_library.py``,
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
import bigdl_tpu_torch.nn as pnn

from test_torch_port_layer_library import (check, CRITERION, CRITERION_CASES,
                                           ints, leaves, to_torch)


@pytest.mark.parametrize("case", CRITERION_CASES,
                         ids=[c[0] for c in CRITERION_CASES])
def test_criterion_matches_jax(case):
    cid, make_crit, make_x, make_t = case
    jc, pc = make_crit(jnn), make_crit(pnn)
    x, t = make_x(), make_t()
    jx = jax.tree_util.tree_map(jnp.asarray, x)
    jt = None if t is None else jax.tree_util.tree_map(jnp.asarray, t)
    loss_j, vjp = jax.vjp(lambda v: jc.apply(v, jt), jx)
    (grad_j,) = vjp(jnp.ones_like(loss_j))
    px = to_torch(x, grad=False)
    pt = None if t is None else to_torch(t, grad=False)
    loss_p = pc.forward(px, pt)
    grad_p = pc.backward(px, pt)
    check(loss_p.detach().numpy(), loss_j, CRITERION, f"{cid} loss")
    for a, b in zip(leaves(grad_p), jax.tree_util.tree_leaves(grad_j),
                    strict=True):
        check(a.numpy(), b, CRITERION, f"{cid} gradient")


def test_time_distributed_separable_criterions():
    """The separable path now also takes ``AbsCriterion`` and an unweighted
    ``BCECriterion``, as the JAX package's does."""
    x = np.random.default_rng(0).uniform(0.1, 0.9, (2, 3, 4)) \
        .astype(np.float32)
    t = ints(2, 3, 4, lo=0, hi=2, seed=1)
    for name in ("AbsCriterion", "BCECriterion"):
        jc = jnn.TimeDistributedCriterion(getattr(jnn, name)(), True)
        pc = pnn.TimeDistributedCriterion(getattr(pnn, name)(), True)
        assert pc._separable()
        check(pc.forward(torch.from_numpy(x), torch.from_numpy(t)).numpy(),
              jc.forward(jnp.asarray(x), jnp.asarray(t)), CRITERION, name)
