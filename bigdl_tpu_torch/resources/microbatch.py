"""Microbatch re-planning: the trainers' answer to a device OOM
(``bigdl_tpu/resources/microbatch.py``: ``snap_k`` :24, ``next_k`` :35,
``chunk_leading`` :46, ``scan_mean`` :57).

When a step raises :class:`~bigdl_tpu_torch.resources.errors.
DeviceMemoryError`, running the same step again would fail again.  The
re-plan splits the global batch of B samples into k equal accumulation
chunks: the step runs k forward/backward passes over B/k samples each and
applies ONE optimizer update with the mean gradient.  Peak activation memory
drops roughly k-fold, while the mean of k equal-chunk gradient means is the
full-batch gradient mean; the accumulation uses Kahan compensated summation
per tensor, so the k-term sum keeps the low-order bits a one-pass reduction
would have kept.

The JAX package runs the k chunks as one ``lax.scan`` inside one fused
program, so that the re-planned step stays one compiled signature.  Eager
PyTorch has no such program: :func:`scan_mean` is a Python loop over the k
chunks, each a forward and backward of its own.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def snap_k(batch_size: int, k: int) -> int:
    """Smallest divisor of ``batch_size`` that is >= ``k``: equal chunks
    make the mean of chunk means the full-batch mean."""
    b = max(1, int(batch_size))
    k = max(1, min(int(k), b))
    while b % k:
        k += 1
    return k


def next_k(batch_size: int, current_k: int) -> Optional[int]:
    """The re-plan schedule: 1 -> 2 -> 4 -> ... (snapped to divisors of the
    batch) until per-sample (k == B) has been tried; then None: the model
    does not fit at microbatch 1 and the fault is fatal."""
    b = max(1, int(batch_size))
    cur = max(1, int(current_k))
    if cur >= b:
        return None
    return snap_k(b, cur * 2)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _unflatten(template, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(template)


def chunk_leading(tree, k: int, i: int):
    """Chunk ``i`` of ``k`` along every tensor leaf's leading dimension
    (a view, ``B // k`` rows)."""
    def take(a):
        n = a.shape[0] // k
        return a.narrow(0, i * n, n)

    return _tree_map(take, tree)


def scan_mean(fn: Callable, xs, k: int):
    """Compensated mean of ``fn`` over ``k`` leading-dimension chunks of the
    tree ``xs`` (every tensor leaf's leading dimension divisible by ``k``).

    ``fn(chunk_tree)`` returns a tree of tensors; the result is the same
    tree holding the Kahan-compensated mean over the k chunks, in chunk
    order.  Floating leaves are divided by k; integer leaves floor-divided,
    keeping their dtype (equal-per-chunk values divide back exactly)."""
    first = fn(chunk_leading(xs, k, 0))
    acc = [v.clone() for v in _leaves(first)]
    comp = [torch.zeros_like(v) for v in acc]
    for i in range(1, k):
        vals = _leaves(fn(chunk_leading(xs, k, i)))
        for j, v in enumerate(vals):
            # Kahan step: y = v - comp; t = acc + y; comp = (t - acc) - y
            y = v - comp[j]
            t = acc[j] + y
            comp[j] = (t - acc[j]) - y
            acc[j] = t

    def mean(a):
        if a.is_floating_point() or a.is_complex():
            return a / k
        return torch.div(a, k, rounding_mode="floor").to(a.dtype)

    return _unflatten(first, [mean(a) for a in acc])
