"""The table layers and ``Graph`` of the port's layer library, held against
the JAX package.

Split from ``test_torch_port_layer_library.py``,
whose docstring states what is held against the JAX package and with which
tolerances; the helpers and fixtures come from there.  No test file of the
port holds more than 25 tests: pytest-xdist's ``loadfile`` scheduler hands
out the largest files first (ROADMAP.md, standing rules).
"""

import jax
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu_torch.utils.convert import params_from_jax

from test_torch_port_layer_library import (_dag, check, check_module_case,
                                           GRAPH, jax_apply, jax_params,
                                           leaves, normal, port_apply,
                                           TABLE_CASES)


@pytest.mark.parametrize("case", TABLE_CASES, ids=[c[0] for c in TABLE_CASES])
def test_module_matches_jax(case):
    check_module_case(case)


def test_graph_matches_jax():
    jg, pg = _dag(jnn), _dag(pnn)
    assert [type(m).__name__ for m in pg.layers] == \
        [type(m).__name__ for m in jg.children]
    params = jax_params(jg, 0)
    params_from_jax(params, pg)
    x = [normal(3, 4), normal(3, 3, seed=1)]
    gy = [normal(3, 2, seed=2), normal(3, 6, seed=3)]
    out_j, pg_j, xg_j = jax_apply(jg, params, x, gy)
    out_p, xg_p, pg_p = port_apply(pg, x, gy)
    for a, b in zip(leaves(out_p) + list(xg_p), jax.tree_util.tree_leaves(out_j)
                    + jax.tree_util.tree_leaves(xg_j), strict=True):
        check(a.detach().numpy(), b, GRAPH, "graph output / input")
    for a, b in zip(jax.tree_util.tree_leaves(pg_p),
                    jax.tree_util.tree_leaves(pg_j), strict=True):
        check(a, b, GRAPH, "graph parameter gradient")
    # the shell through the graph: the same gradients
    pg.zero_grad_parameters()
    gin = pg.backward([torch.from_numpy(v) for v in x],
                      [torch.from_numpy(v) for v in gy])
    for a, b in zip(gin, xg_p, strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_graph_cycle_raises():
    for nn in (jnn, pnn):
        n1 = nn.Identity().inputs()
        n2 = nn.Identity().inputs(n1)
        n1.inputs(n2)
        with pytest.raises(ValueError, match="cycle"):
            nn.Graph([n1], [n2])
