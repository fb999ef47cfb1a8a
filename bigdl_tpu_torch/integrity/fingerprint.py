"""Training-state fingerprints, on the device and on the host
(``bigdl_tpu/integrity/fingerprint.py``: ``_device_signs`` :54,
``_host_signs`` :64, ``fingerprint_flat`` :75, ``fingerprint_tree`` :99,
``SLOT_SEED_OFF``/``GRAD_SEED_OFF``, ``init_carry`` :120,
``continuity_check`` :130, ``pack_carry`` :159, ``sq_norm``/``sq_norm_diff``
:168-195, ``fingerprint_key`` :196, ``_collect_float_leaves`` :213,
``host_fingerprint`` :247, ``first_nonfinite`` :267, ``nonfinite_names``
:288).

A fingerprint is a ``[sum, random projection]`` pair over every float
element: the sum catches gross corruption, the seed-fixed +-1 projection
catches compensating or permuting corruption that the sum cancels.  The
signs come from a multiplicative xorshift hash of each element's position,
pure in ``(position, seed)``.

**The device half** reduces on the tensors' own device, in float64
(the JAX package accumulates in float32 without x64, so its values and
these agree only within a tolerance; the verdicts built on them are
exact).  The sign stream is the JAX package's bit for bit: the uint32
arithmetic runs in int64, masked to 32 bits after every multiply.  A leaf
is reduced in chunks of :data:`DEVICE_CHUNK` elements, so a 134M-element
leaf needs no gigabyte of int64 hash temporaries.  Continuity compares,
bit for bit, the fingerprint a step takes of its output with the one the
next step takes of its input; both reduce the same tensor with the same
code, chunks and order, so equal bits give equal fingerprints (CUDA's sum
reductions are deterministic for a given shape).  The trainers fingerprint
the fp32 master parameters and the optimizer slots, never a bf16 cast.

**The host half** verifies checkpoint payloads: the checkpoint manager
records it for each payload before serialization and recomputes it after
reading, so corruption in memory before the write, which the payload's
checksum (taken over the corrupt bytes) cannot see, refuses the snapshot.
Float tensors of any dtype count, as float64; integer tensors do not.  Its
projection runs over 64K-element chunks (three times the JAX package's
whole-array speed); its float64 rounding therefore differs from the JAX
package's in the last bits, and a fingerprint is only ever compared with
one made by this code.

Also here: :func:`first_nonfinite`, the divergence guard's finiteness
check that also names the first non-finite leaf.
"""

from __future__ import annotations

import struct
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

#: default projection seed (``bigdl.integrity.seed``)
DEFAULT_SEED = 0x51D0
#: ``first_nonfinite`` index when every leaf is finite
NF_SENTINEL = 2 ** 31 - 1
#: seed offsets separating the fingerprinted trees: parameters, optimizer
#: slots and gradients draw disjoint sign streams
SLOT_SEED_OFF = 0x5D3F9B31
GRAD_SEED_OFF = 0x2B7E1516
#: elements of one leaf reduced at once on the device
DEVICE_CHUNK = 1 << 22

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
_MASK = 0xFFFFFFFF


def _device_signs(n: int, seed: int, device="cpu",
                  offset: int = 0) -> torch.Tensor:
    """+-1 (float64) for positions ``offset .. offset + n - 1`` on
    ``device``: the JAX package's uint32 stream computed in int64 and
    masked after each multiply (a product of two 32-bit values may wrap the
    int64; its low 32 bits stay exact)."""
    i = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    x = ((i * int(_MIX1)) & _MASK) ^ (seed & _MASK)
    x = ((x ^ (x >> 15)) * int(_MIX2)) & _MASK
    x = ((x ^ (x >> 13)) * int(_MIX3)) & _MASK
    x = x ^ (x >> 16)
    return 1.0 - 2.0 * (x >> 31).to(torch.float64)


def fingerprint_flat(vec: torch.Tensor, seed: int) -> torch.Tensor:
    """``(2,)`` float64 ``[sum, projection]`` of one tensor's elements (in
    their flattened order) on its device; no host read.  Zero padding adds
    exactly zero to both."""
    v = vec.detach().reshape(-1)
    s = torch.zeros((), dtype=torch.float64, device=v.device)
    p = torch.zeros((), dtype=torch.float64, device=v.device)
    for off in range(0, v.numel(), DEVICE_CHUNK):
        seg = v[off:off + DEVICE_CHUNK].to(torch.float64)
        signs = _device_signs(seg.numel(), seed, v.device, off)
        s = s + seg.sum()
        p = p + (seg * signs).sum()
    return torch.stack([s, p])


def _float_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _float_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _float_leaves(t)]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return [tree]
    return []


def fingerprint_tree(tree, seed: int) -> torch.Tensor:
    """``(2,)`` fingerprint over every float tensor of a list/tuple/dict
    tree (dicts in insertion order); leaf ``idx`` (1-based) draws the
    stream of ``seed + 0x9E3779B9 * idx``, so values swapped between leaves
    change the projection."""
    leaves = _float_leaves(tree)
    device = leaves[0].device if leaves else "cpu"
    total = torch.zeros(2, dtype=torch.float64, device=device)
    for idx, leaf in enumerate(leaves, 1):
        total = total + fingerprint_flat(leaf, seed + _LEAF_STRIDE * idx)
    return total


def init_carry(device="cpu") -> torch.Tensor:
    """A fresh integrity carry ``[seen, latch, bad_iter, p_sum, p_proj,
    s_sum, s_proj]``, all zero (``seen == 0``: the first step records
    instead of comparing).  Reset after every heal or restore."""
    return torch.zeros(7, dtype=torch.float64, device=device)


def continuity_check(fpc: torch.Tensor, fp_p_in: torch.Tensor,
                     fp_s_in: torch.Tensor, tick, extra_ok=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The step's continuity verdict against the previous step's carry:
    ``(cont_ok, latch, bad_iter)``.  ``cont_ok`` is False when the input
    parameter or slot fingerprints differ from what the previous step
    wrote out; ``latch`` is sticky; ``bad_iter`` keeps the first bad tick.
    ``extra_ok`` (a replica-agreement verdict) folds in, on the first step
    too."""
    seen = fpc[0]
    match = ((fp_p_in[0] == fpc[3]) & (fp_p_in[1] == fpc[4]) &
             (fp_s_in[0] == fpc[5]) & (fp_s_in[1] == fpc[6]))
    cont_ok = (seen == 0) | match
    if extra_ok is not None:
        cont_ok = cont_ok & extra_ok
    zero = torch.zeros((), dtype=fpc.dtype, device=fpc.device)
    latch = torch.maximum(fpc[1], torch.where(cont_ok, zero, zero + 1))
    first_bad = (~cont_ok) & (fpc[2] == 0)
    tick_t = torch.as_tensor(tick, dtype=fpc.dtype, device=fpc.device)
    bad_iter = torch.where(first_bad, tick_t, fpc[2])
    return cont_ok, latch, bad_iter


def pack_carry(latch, bad_iter, fp_p_out, fp_s_out) -> torch.Tensor:
    """The (7,) carry for the next step, from this step's verdicts and
    output fingerprints."""
    one = torch.ones((), dtype=fp_p_out.dtype, device=fp_p_out.device)
    return torch.stack([one, latch, bad_iter, fp_p_out[0], fp_p_out[1],
                        fp_s_out[0], fp_s_out[1]])


def sq_norm(tree) -> torch.Tensor:
    """Sum of squares over every float tensor (float64): the weight-health
    monitor's norms."""
    leaves = _float_leaves(tree)
    device = leaves[0].device if leaves else "cpu"
    total = torch.zeros((), dtype=torch.float64, device=device)
    for leaf in leaves:
        v = leaf.detach().to(torch.float64)
        total = total + (v * v).sum()
    return total


def sq_norm_diff(new_tree, old_tree) -> torch.Tensor:
    """Sum of squared differences over float tensors: the applied
    update's norm."""
    new, old = _float_leaves(new_tree), _float_leaves(old_tree)
    device = new[0].device if new else "cpu"
    total = torch.zeros((), dtype=torch.float64, device=device)
    for n, o in zip(new, old):
        d = n.detach().to(torch.float64) - o.detach().to(torch.float64)
        total = total + (d * d).sum()
    return total


def first_nonfinite(*trees):
    """``(ok, idx)``: ``ok`` is every float tensor of ``trees`` finite (a
    0-dim bool tensor), ``idx`` the int64 position (float-leaf order over
    the trees) of the first leaf holding a non-finite value, or
    :data:`NF_SENTINEL`.  Trees without a float tensor give ``(True,
    NF_SENTINEL)`` as Python values."""
    leaves = [x for t in trees for x in _float_leaves(t)]
    if not leaves:
        return True, NF_SENTINEL
    bad = torch.stack([~torch.isfinite(x).all() for x in leaves])
    any_bad = bad.any()
    first = torch.argmax(bad.to(torch.int32)).to(torch.int64)
    idx = torch.where(any_bad, first,
                      torch.full_like(first, NF_SENTINEL))
    return ~any_bad, idx


def nonfinite_names(*labeled_trees: Tuple[str, Any]) -> List[str]:
    """The names of :func:`first_nonfinite`'s index space: for each
    ``(label, tree)`` in the same order, ``label`` for a scalar and
    ``label:<key>`` per float tensor of a dict (insertion order) or
    ``label:[i]`` of a list."""
    names: List[str] = []
    for label, tree in labeled_trees:
        if isinstance(tree, dict):
            names += [f"{label}:{k}" for k, v in tree.items()
                      if not isinstance(v, torch.Tensor) or
                      v.is_floating_point()]
        elif isinstance(tree, (list, tuple)):
            names += [f"{label}:[{i}]" for i, v in enumerate(tree)
                      if not isinstance(v, torch.Tensor) or
                      v.is_floating_point()]
        else:
            names.append(str(label))
    return names


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
