"""The ``bigdl.*`` configuration-property tier of the port.

A copy of ``bigdl_tpu/utils/config.py`` (the port imports nothing of the JAX
package), holding the keys the port reads.  Resolution order: a
:func:`set_property` override, then the environment variable
``BIGDL_<DOTTED_NAME>`` (dots to underscores, upper-cased), then the table
default.  The overrides are this module's own: setting a property here does
not set it for ``bigdl_tpu`` and the other way round.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

_DEFAULTS: Dict[str, Any] = {
    "bigdl.compile.buckets": None,         # "8,16,32": ragged batches pad up
    # serving (bigdl_tpu_torch/serving): bounded queue, per-request
    # deadlines, shedding, poison quarantine, graceful drain
    "bigdl.serving.maxBatch": 16,          # batcher coalesce ceiling
    "bigdl.serving.maxQueueDepth": 128,    # admission queue bound (reject past it)
    "bigdl.serving.deadlineMs": 1000.0,    # default per-request deadline
    "bigdl.serving.admissionDeadlineFactor": 1.0,  # reject when projected wait > f x deadline
    "bigdl.serving.pollInterval": 0.05,    # batcher idle wake period, seconds
    "bigdl.serving.warmupBatches": 3,      # dispatch-EMA warmup (first-call exemption)
    "bigdl.serving.gracePeriod": 5.0,      # drain window for stop, seconds
    # training (bigdl_tpu_torch/optim/optimizer.py)
    "bigdl.divergence.guard": True,          # skip non-finite updates in-step
    "bigdl.divergence.maxBadSteps": 5,       # consecutive bad steps -> DivergenceError
}

_OVERRIDES: Dict[str, Any] = {}


def _env_key(name: str) -> str:
    return name.replace(".", "_").upper()


def get_property(name: str, default: Optional[Any] = None) -> Any:
    """Resolution order: set_property override > env var > table default."""
    if name in _OVERRIDES:
        return _OVERRIDES[name]
    env = os.environ.get(_env_key(name))
    if env is not None:
        return env
    if name in _DEFAULTS and _DEFAULTS[name] is not None:
        return _DEFAULTS[name]
    return default


def get_int(name: str, default: int = 0) -> int:
    return int(get_property(name, default))


def get_float(name: str, default: float = 0.0) -> float:
    return float(get_property(name, default))


def get_bool(name: str, default: bool = False) -> bool:
    v = get_property(name, default)
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes", "on")


def set_property(name: str, value: Any) -> None:
    _OVERRIDES[name] = value


def clear_property(name: str) -> None:
    _OVERRIDES.pop(name, None)
