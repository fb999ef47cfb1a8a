"""The host half of the training-state fingerprint
(``bigdl_tpu/integrity/fingerprint.py``: ``_host_signs`` :64,
``fingerprint_key`` :196, ``_collect_float_leaves`` :213,
``host_fingerprint`` :247).

A fingerprint is a ``[sum, random projection]`` pair over every float
element of an object graph, accumulated in float64 with numpy: the sum
catches gross corruption, the seed-fixed +-1 projection catches
compensating or permuting corruption that the sum cancels.  The signs come
from a multiplicative xorshift hash of each element's position, pure in
``(position, seed)``.  The checkpoint manager records it for each payload
before serialization and recomputes it after reading: corruption in memory
before the write, which the payload's checksum (taken over the corrupt
bytes) cannot see, refuses the snapshot.  Float tensors of any dtype
count, as float64; integer tensors do not.

The projection runs over 64K-element chunks (the hash and the masked sum
stay in cache: three times the JAX package's whole-array speed, which
matters for a snapshot of hundreds of millions of elements).  Its float64
rounding therefore differs from the JAX package's in the last bits; a
fingerprint is only ever compared with one made by this code.
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np
import torch

#: default projection seed (``bigdl.integrity.seed``)
DEFAULT_SEED = 0x51D0

_MIX1 = np.uint32(2654435761)
_MIX2 = np.uint32(2246822519)
_MIX3 = np.uint32(3266489917)
#: per-leaf seed stride (golden-ratio odd constant)
_LEAF_STRIDE = 0x9E3779B9


def _host_signs(n: int, seed: int) -> np.ndarray:
    """+-1 for positions 0..n-1, pure in ``(n, seed)``."""
    i = np.arange(n, dtype=np.uint32)
    with np.errstate(over="ignore"):
        x = (i * _MIX1) ^ np.uint32(seed & 0xFFFFFFFF)
        x = (x ^ (x >> np.uint32(15))) * _MIX2
        x = (x ^ (x >> np.uint32(13))) * _MIX3
        x = x ^ (x >> np.uint32(16))
    return 1.0 - 2.0 * (x >> np.uint32(31)).astype(np.float64)


_CHUNK = 1 << 16


def _signed_sum(v: np.ndarray, seed: int) -> float:
    """``v . _host_signs(v.size, seed)`` computed chunk by chunk, as
    ``sum(v) - 2 * sum(v where the sign is -1)``."""
    total = 0.0
    seed32 = np.uint32(seed & 0xFFFFFFFF)
    base = np.arange(min(_CHUNK, v.size), dtype=np.uint32)
    x = np.empty_like(base)
    y = np.empty_like(base)
    with np.errstate(over="ignore"):
        for off in range(0, v.size, _CHUNK):
            n = min(_CHUNK, v.size - off)
            xi, yi = x[:n], y[:n]
            np.add(base[:n], np.uint32(off), out=xi)
            np.multiply(xi, _MIX1, out=xi)
            np.bitwise_xor(xi, seed32, out=xi)
            for shift, mix in ((15, _MIX2), (13, _MIX3), (16, None)):
                np.right_shift(xi, np.uint32(shift), out=yi)
                np.bitwise_xor(xi, yi, out=xi)
                if mix is not None:
                    np.multiply(xi, mix, out=xi)
            seg = v[off:off + n]
            neg = (xi >> np.uint32(31)).astype(bool)
            total += float(seg.sum()) - 2.0 * float(seg[neg].sum())
    return total


def fingerprint_key(fp) -> str:
    """Bit-exact comparison key of a ``[sum, proj]`` pair: the hex of the
    two IEEE-754 doubles (NaN-safe, sign-of-zero exact)."""
    a = np.asarray(fp, dtype=np.float64).ravel()
    return struct.pack("<2d", float(a[0]), float(a[1])).hex()


def _collect_float_leaves(obj, out: List[np.ndarray], seen: set) -> None:
    """Float tensors, arrays and scalars of an object graph in a fixed
    order: dicts in insertion order, lists and tuples in order, objects
    through ``__dict__``; cycles guarded by id."""
    if obj is None or isinstance(obj, (str, bytes, bool, int)):
        return
    if isinstance(obj, float):
        out.append(np.asarray([obj], dtype=np.float64))
        return
    if isinstance(obj, torch.Tensor):
        if obj.is_floating_point():
            out.append(obj.detach().to("cpu", torch.float64).numpy())
        return
    dt = getattr(obj, "dtype", None)
    if dt is not None:
        if getattr(dt, "kind", "") == "f":
            out.append(np.asarray(obj, dtype=np.float64))
        return
    oid = id(obj)
    if oid in seen:
        return
    if isinstance(obj, dict):
        seen.add(oid)
        for v in obj.values():
            _collect_float_leaves(v, out, seen)
        return
    if isinstance(obj, (list, tuple)):
        seen.add(oid)
        for v in obj:
            _collect_float_leaves(v, out, seen)
        return
    d = getattr(obj, "__dict__", None)
    if isinstance(d, dict):
        seen.add(oid)
        for v in d.values():
            _collect_float_leaves(v, out, seen)


def host_fingerprint(obj: Any, seed: int = DEFAULT_SEED) -> List[float]:
    """``[sum, projection]`` (Python floats, float64 accumulation) over
    every float leaf reachable from ``obj``."""
    leaves: List[np.ndarray] = []
    _collect_float_leaves(obj, leaves, set())
    s = 0.0
    p = 0.0
    for idx, arr in enumerate(leaves):
        v = arr.ravel()
        s += float(v.sum())
        p += _signed_sum(v, seed + _LEAF_STRIDE * (idx + 1))
    return [s, p]
