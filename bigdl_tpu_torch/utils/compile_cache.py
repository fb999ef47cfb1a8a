"""Shape buckets for ragged batches (``bigdl_tpu/utils/compile_cache.py``).

The JAX package pads every served batch up to a configured bucket so that
arrival patterns only ever hit executables compiled ahead of time.  Eager
PyTorch compiles nothing, and the executable cache and AOT precompile have no
counterpart here; the bucket plan stays so the port serves the same padded
shapes as the reference (and so a later CUDA-graph capture has a closed set
of shapes).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def configured_buckets() -> Optional[List[int]]:
    """The sorted ``bigdl.compile.buckets`` list, or None when bucketing
    is off.  Accepts a comma-separated string (``"8,16,32"``) or a
    sequence of ints."""
    from bigdl_tpu_torch.utils import config
    v = config.get_property("bigdl.compile.buckets")
    if not v:
        return None
    if isinstance(v, (list, tuple)):
        sizes = [int(x) for x in v]
    else:
        sizes = [int(t) for t in str(v).split(",") if t.strip()]
    sizes = sorted(set(s for s in sizes if s > 0))
    return sizes or None


def bucket_size(n: int, buckets: Sequence[int]) -> int:
    """Smallest configured bucket >= ``n``; beyond the largest bucket,
    the next multiple of it."""
    for b in buckets:
        if n <= b:
            return b
    largest = buckets[-1]
    return ((n + largest - 1) // largest) * largest


def pad_batch(x: np.ndarray, n: int, padded_n: int) -> np.ndarray:
    """Pad a host batch from ``n`` to ``padded_n`` rows by repeating the
    last row (edge padding: always-valid values, so padded rows cannot
    produce NaN/inf).  Callers slice outputs back to ``n`` rows."""
    if padded_n == n:
        return x
    x = np.asarray(x)
    reps = np.repeat(x[-1:], padded_n - n, axis=0)
    return np.concatenate([x, reps], axis=0)


def slice_rows(x: np.ndarray, n: int) -> np.ndarray:
    """Undo :func:`pad_batch` on a pulled host output: its first ``n``
    rows (no-op when it already has ``n`` or fewer)."""
    x = np.asarray(x)
    return x[:n] if x.ndim >= 1 and x.shape[0] > n else x
