"""Metrics: named driver-side counters of phase timing
(``bigdl_tpu/optim/metrics.py``; reference ``optim/Metrics.scala:31``:
named counters backed by Spark accumulators, local, aggregated over the
cluster, or a list per node).  A process-local dict with the same
``set``/``add``/``get`` surface; :meth:`Metrics.aggregated` sums over the
process group.

Hot-path contract: :meth:`Metrics.add` takes a device tensor as it is -- a
``float(cuda_scalar)`` per call would be one blocking device round trip
per iteration, the implicit sync the host-sync guard forbids.  Tensors are
parked and pulled in ONE :func:`~bigdl_tpu_torch.analysis.host_pull` when
a reader (:meth:`get` / :meth:`aggregated` / :meth:`summary`) needs host
numbers; past :attr:`Metrics.COMPACT_AT` parked values of one name are
summed on the device (an enqueue, never a sync).
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

import torch

from bigdl_tpu_torch.analysis.hostsync import host_pull
from bigdl_tpu_torch.analysis.lockwitness import make_lock


class Metrics:
    def __init__(self):
        self._scalar: Dict[str, Tuple[float, int]] = {}   # value, parallelism
        self._lists: Dict[str, List[float]] = {}
        self._pending: Dict[str, list] = {}   # device tensors, not pulled yet
        self._lock = make_lock("metrics.optim")
        # serializes flushes and resets: the blocking pull happens outside
        # _lock (a reader must not stall hot-loop adds for a device round
        # trip), so without it a set() could slip between a flush's
        # swap-out and fold-in and have older values folded on top of it
        self._flush_lock = make_lock("metrics.flush")

    def set(self, name: str, value: Union[float, List[float]],
            parallelism: int = 1) -> None:
        with self._flush_lock, self._lock:
            if isinstance(value, (list, tuple)):
                self._lists[name] = list(value)
            else:
                self._pending.pop(name, None)
                self._scalar[name] = (float(value), parallelism)

    #: parked tensors of one name before they are summed into one on the
    #: device: bounds the live buffers of a long run read only at its end
    COMPACT_AT = 256

    def add(self, name: str, value: float) -> None:
        if isinstance(value, torch.Tensor):
            # park the tensor, not synced; one pull at read time
            with self._lock:
                lst = self._pending.setdefault(name, [])
                lst.append(value.detach())
                if len(lst) >= self.COMPACT_AT:
                    self._pending[name] = [torch.stack(lst).sum()]
            return
        with self._lock:
            self._add_host(name, float(value))

    def _add_host(self, name: str, value: float) -> None:
        """Fold one host float in (the caller holds the lock)."""
        if name in self._lists:
            self._lists[name].append(value)
        elif name in self._scalar:
            v, p = self._scalar[name]
            self._scalar[name] = (v + value, p)
        else:
            self._scalar[name] = (value, 1)

    def _flush_pending(self) -> None:
        """Pull every parked tensor in one explicit pull and fold the host
        values in; the pull runs outside ``_lock``, ``_flush_lock`` keeps
        swap-out, pull and fold-in atomic against other readers and
        ``set``."""
        with self._flush_lock:
            with self._lock:
                if not self._pending:
                    return
                pending, self._pending = self._pending, {}
            pulled = host_pull(pending, what="metrics flush")
            with self._lock:
                for name, values in pulled.items():
                    for v in values:
                        self._add_host(name, float(v))

    def get(self, name: str):
        self._flush_pending()
        with self._lock:
            if name in self._scalar:
                v, p = self._scalar[name]
                return v / p
            if name in self._lists:
                return list(self._lists[name])
            raise KeyError(name)

    def aggregated(self, name: str, group=None) -> float:
        """The process group's aggregate of a scalar counter (the
        reference's distributed accumulator): (value, parallelism) summed
        over every rank of ``group`` (default: the world), the global
        mean returned; without a group this is :meth:`get`.  COLLECTIVE:
        every rank calls it with the same name."""
        from bigdl_tpu_torch.engine import allgather_sum

        self._flush_pending()
        with self._lock:
            v, p = self._scalar.get(name, (0.0, 0))
        total_v, total_p = allgather_sum([v, float(p)], group)
        if total_p == 0:
            raise KeyError(name)
        return float(total_v / total_p)

    def summary(self, unit: str = "s", scale: float = 1e9) -> str:
        self._flush_pending()
        with self._lock:
            parts = [f"{k}: {v / p / scale} {unit}"
                     for k, (v, p) in self._scalar.items()]
        return "========== Metrics Summary ==========\n" + \
            "\n".join(parts) + "\n====================================="
