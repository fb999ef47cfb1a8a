"""AllReduceParameter: the flat parameter vector and its collectives
(``bigdl_tpu/parallel/all_reduce.py``: ``AllReduceParameter`` :87-192, the
declared collectives :194-233; reference
``parameters/AllReduceParameter.scala:67``).

The reference slices the model's flattened parameter vector into
``partitionNum`` chunks and runs a reduce-scatter of the gradients, an
update of each chunk where it lives, and an all-gather of the weights; the
JAX package runs that cycle as ``psum_scatter``/``all_gather`` under
``shard_map``.  Here the collectives are ``torch.distributed``'s, on an
explicit process group (NCCL for CUDA tensors, gloo for CPU ones), with one
process per rank.

:meth:`AllReduceParameter.bind` makes the model's parameters views into one
padded flat buffer.  Each parameter's elements lie in the buffer in its own
memory order (a channels-last weight stays channels-last), so the weight
all-gather writes straight into the live weights.  Rank ``r`` owns the slice
``[r * shard_size, (r + 1) * shard_size)``.

As in the JAX package the collectives sum and the caller divides by the rank
count.  ``compression="bf16"`` casts the gradient reduce-scatter's operand to
bf16 before the collective and its result back after (the reference's fp16
wire, ``parameters/FP16CompressedTensor.scala:30-90``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


class Pending:
    """An issued collective.  :meth:`wait` blocks until its result is
    ready (for NCCL: makes the current stream wait for it) and returns it.
    It keeps the collective's operand alive until then."""

    def __init__(self, work, operand: torch.Tensor, result: torch.Tensor,
                 finish: Optional[Callable] = None):
        self._work, self._operand = work, operand
        self._result, self._finish = result, finish

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
        return self._finish(self._result) if self._finish else self._result


def _memory_order(t: torch.Tensor) -> List[int]:
    """``t``'s dimensions from the outermost to the innermost in memory."""
    return sorted(range(t.dim()), key=lambda d: -t.stride(d))


class AllReduceParameter:
    """Flat-vector geometry and collectives for one list of parameters
    (the model's, in ``parameters()`` order), over ``group`` (the default
    group when None)."""

    def __init__(self, params: Sequence[torch.Tensor], n_shards: int,
                 compression: Optional[str] = None,
                 group: Optional[dist.ProcessGroup] = None):
        params = list(params)
        self.size = sum(p.numel() for p in params)
        if self.size == 0:
            raise ValueError("model has no trainable parameters")
        dtypes = {p.dtype for p in params}
        if len(dtypes) != 1:
            raise ValueError(f"parameters of several dtypes {dtypes}: the "
                             "flat vector holds one")
        self.dtype = dtypes.pop()
        self.n_shards = n_shards
        self.padded_size = -(-self.size // n_shards) * n_shards
        self.shard_size = self.padded_size // n_shards
        if compression not in (None, "bf16"):
            raise ValueError(f"unknown compression {compression!r} (only "
                             "'bf16' is supported)")
        self.compression = compression
        self.group = group
        # (shape, memory order, offset) of each parameter in the flat vector
        self._layout = []
        offset = 0
        for p in params:
            self._layout.append((tuple(p.shape), _memory_order(p), offset))
            offset += p.numel()

    # ---- geometry ---------------------------------------------------------

    def flatten(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """Tensors shaped as the parameters (gradients, slots) -> one
        zero-padded flat vector, each in its parameter's memory order."""
        parts = [t.permute(order).reshape(-1)
                 for t, (_, order, _) in zip(tensors, self._layout,
                                             strict=True)]
        pad = self.padded_size - self.size
        if pad:
            parts.append(parts[0].new_zeros(pad))
        return torch.cat(parts)

    def unflatten(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Padded flat vector -> one view per parameter, with the
        parameter's shape and strides."""
        views = []
        for shape, order, offset in self._layout:
            n = 1
            for d in shape:
                n *= d
            inverse = sorted(range(len(order)), key=order.__getitem__)
            views.append(flat[offset:offset + n]
                         .view([shape[d] for d in order]).permute(inverse))
        return views

    def bind(self, params: Sequence[torch.Tensor]) -> torch.Tensor:
        """A new padded flat buffer holding the parameters' values, which
        from then on are views into it; returns the buffer."""
        with torch.no_grad():
            flat = self.flatten([p.detach() for p in params])
            for p, view in zip(params, self.unflatten(flat), strict=True):
                p.data = view
        return flat

    def local_shard(self, flat: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank ``rank``'s slice of a flat vector (a view)."""
        return flat[rank * self.shard_size:(rank + 1) * self.shard_size]

    def bucket_edges(self, n_buckets: int):
        """About equal contiguous [start, stop) column ranges over
        ``shard_size`` (the JAX package's :155-162): at least one column a
        bucket, every column in exactly one."""
        n = max(1, min(int(n_buckets), self.shard_size))
        edges = [round(i * self.shard_size / n) for i in range(n + 1)]
        return [(a, b) for a, b in zip(edges, edges[1:]) if b > a]

    # ---- collectives ------------------------------------------------------

    def _reduce_scatter(self, operand: torch.Tensor, n: int,
                        async_op: bool):
        wire = torch.bfloat16 if self.compression == "bf16" else self.dtype
        operand = operand.to(wire).reshape(-1)
        out = torch.empty(n, dtype=wire, device=operand.device)
        work = dist.reduce_scatter_tensor(out, operand, op=dist.ReduceOp.SUM,
                                          group=self.group,
                                          async_op=async_op)
        finish = None if wire == self.dtype else (
            lambda o: o.to(self.dtype))
        pending = Pending(work, operand, out, finish)
        return pending if async_op else pending.wait()

    def reduce_scatter_gradients(self, flat_grads: torch.Tensor,
                                 async_op: bool = False):
        """Sum the ranks' padded flat gradients; this rank gets its
        ``(shard_size,)`` slice of the sum (reference ``putGradients`` +
        ``aggregateGradientPartition``).  With ``async_op``, a
        :class:`Pending`."""
        return self._reduce_scatter(flat_grads, self.shard_size, async_op)

    def reduce_scatter_bucket(self, columns: torch.Tensor,
                              async_op: bool = False):
        """Reduce-scatter one column block: ``columns`` is the
        ``(n_shards, b - a)`` block of the flat gradient viewed as an
        ``(n_shards, shard_size)`` matrix; this rank gets the ``(b - a,)``
        sum of its row of it."""
        return self._reduce_scatter(columns, columns.shape[1], async_op)

    def all_gather_weights(self, shard: torch.Tensor, out: torch.Tensor,
                           async_op: bool = False):
        """Gather every rank's ``(shard_size,)`` slice into the padded
        flat ``out`` (reference ``getWeights``).  In place when ``shard``
        is this rank's slice of ``out``."""
        work = dist.all_gather_into_tensor(out, shard, group=self.group,
                                           async_op=async_op)
        pending = Pending(work, shard, out)
        return pending if async_op else pending.wait()

    def all_gather_bucket(self, bucket_shard: torch.Tensor,
                          async_op: bool = False):
        """Gather one updated column block: ``(b - a,)`` from each rank ->
        the ``(n_shards, b - a)`` block of the flat weights' matrix
        view."""
        n = bucket_shard.numel()
        out = bucket_shard.new_empty(self.n_shards * n)
        work = dist.all_gather_into_tensor(out, bucket_shard,
                                           group=self.group,
                                           async_op=async_op)
        pending = Pending(work, bucket_shard, out,
                          lambda o: o.view(self.n_shards, n))
        return pending if async_op else pending.wait()


# ---- the declared collectives (the JAX package's :194-233) -----------------
#
# Every collective a trainer's step performs goes through this module, as in
# the JAX package.  Each reduces in place over ``group`` and returns its
# tensor; a mean is a sum then a division, as there.


def axis_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce sum."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def axis_mean(t: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce mean (loss averaging)."""
    return axis_sum(t, group).div_(dist.get_world_size(group))


def axis_min(t: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce minimum (the global divergence verdict: every rank
    applies or skips a step together)."""
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return t


def pmean_floats(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Average the floating tensors over the group in place (BatchNorm's
    running statistics stay equal between ranks); the others pass.  The
    tensors of one dtype travel as one concatenated all-reduce."""
    by_dtype = {}
    for t in tensors:
        if t.is_floating_point():
            by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        buf = axis_mean(torch.cat([t.reshape(-1) for t in same]), group)
        offset = 0
        for t in same:
            t.copy_(buf[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def _peer(group, index: int) -> int:
    """The global rank of member ``index`` of ``group``."""
    return index if group is None else dist.get_global_rank(group, index)


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to member ``(i + step) % n`` and receive from ``(i -
    step) % n``, the send and the receive issued in one batch."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, _peer(group, (i + step) % n), group),
           dist.P2POp(dist.irecv, out, _peer(group, (i - step) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


def ring_permute(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ring shift over ``group`` (the JAX package's ``ppermute`` with
    ``perm = [(i, (i + 1) % n)]``): member i sends ``x`` to member ``(i +
    1) % n`` and returns what member ``(i - 1) % n`` sent.  Differentiable:
    the backward shifts the gradient the other way.  Every member calls it
    with a tensor of the same shape and dtype; with one member (or no
    process group) it is the identity, with no communication."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return x
    return _RingPermute.apply(x, group)


def gather_fingerprints(fp: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``(2,)`` fingerprint as one ``(ranks, 2)`` table, the
    same on every rank (the agreement table of the integrity check)."""
    n = dist.get_world_size(group)
    out = fp.new_empty(n * fp.numel())
    dist.all_gather_into_tensor(out, fp.contiguous(), group=group)
    return out.view(n, fp.numel())
