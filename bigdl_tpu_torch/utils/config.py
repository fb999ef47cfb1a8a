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
    # LM token serving (bigdl_tpu_torch/serving/lm.py): continuous batching
    # over a paged KV cache, one fixed (maxBatch, 1) decode shape (one CUDA
    # graph), a bucketed prefill plan, streamed tokens
    "bigdl.lm.maxBatch": 8,                # concurrent decode slots (the fixed decode batch)
    "bigdl.lm.maxContext": 256,            # prompt + generated tokens ceiling per sequence
    "bigdl.lm.blockSize": 16,              # KV-cache tokens per block
    "bigdl.lm.cacheBlocks": 0,             # KV pool blocks incl. dump block; 0 = derive
    # maxBatch x blocks_per_seq(maxContext) + 1
    "bigdl.lm.prefillBuckets": None,       # "16,32,64": prompt pad-up plan; None = pow2
    # ladder from blockSize to maxContext
    "bigdl.lm.maxNewTokens": 64,           # default generation cap per request
    "bigdl.lm.deadlineMs": 5000.0,         # default end-to-end per-request deadline
    "bigdl.lm.maxQueueDepth": 128,         # admission queue bound (reject past it)
    "bigdl.lm.admissionDeadlineFactor": 0,  # reject when projected wait > f x deadline; 0 off
    "bigdl.lm.stallFactor": 0,             # hung-decode watchdog (not ported: > 0 raises)
    "bigdl.lm.warmupSteps": 3,             # decode-EMA warmup (first-call exemption)
    "bigdl.lm.gracePeriod": 5.0,           # drain window for stop, seconds
    "bigdl.lm.pollInterval": 0.01,         # scheduler idle wake period, seconds
    "bigdl.lm.quantize": "off",            # "int8" tier (not ported: raises)
    # training (bigdl_tpu_torch/optim/optimizer.py)
    "bigdl.divergence.guard": True,          # skip non-finite updates in-step
    "bigdl.divergence.maxBadSteps": 5,       # consecutive bad steps -> DivergenceError
    "bigdl.prefetch.depth": 0,               # batch prefetcher (not ported: > 0 raises)
    # data parallelism (bigdl_tpu_torch/parallel/distri_optimizer.py)
    "bigdl.parallel.overlap": True,          # False = monolithic baseline step
    "bigdl.parallel.overlapBuckets": 4,      # column buckets of the flat vector per step
    "bigdl.elastic.globalShuffle": True,     # one global epoch permutation
    # (ShardedDataSet); False = partition-local blocks shuffled apart
    "bigdl.elastic.handleSignals": False,    # graceful drain + resume (not ported: raises)
    "bigdl.integrity.everyN": 0,             # fingerprints (not ported: > 0 raises)
    "bigdl.chaos.extraAllGather": False,     # audit fault injection (not ported: raises)
    "bigdl.chaos.dropBucketCollective": None,  # audit fault injection (not ported: raises)
    # transformer_lm's remat argument left at its default: "nothing" /
    # "dots" / "save_attn" ask for remat (not ported yet); None = no remat
    "bigdl.remat.policy": None,
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
