"""The reshaping and selection layers and the linear family of the port's
layer library, held against the JAX package.

Split from ``test_torch_port_layer_library.py``,
whose docstring states what is held against the JAX package and with which
tolerances; the helpers and fixtures come from there.  No test file of the
port holds more than 25 tests: pytest-xdist's ``loadfile`` scheduler hands
out the largest files first (ROADMAP.md, standing rules).
"""

import pytest

from test_torch_port_layer_library import (check_module_case, LINEAR_CASES,
                                           SHAPE_CASES)

CASES = SHAPE_CASES + LINEAR_CASES


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_module_matches_jax(case):
    check_module_case(case)
