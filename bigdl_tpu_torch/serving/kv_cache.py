"""Paged block-table KV cache for autoregressive decode
(``bigdl_tpu/serving/kv_cache.py``).

One fixed device pool of key/value blocks shaped ``(layer, block,
block_size, head, head_dim)``, a host free-list, and a block table per
sequence mapping its token positions to pool blocks.  Sequences of any
length share the pool; one wastes at most ``block_size - 1`` slots, never a
reservation of the whole context.

Three invariants:

- **Block 0 is the dump block.**  It is never handed out: padded prefill
  positions and inactive decode slots scatter their junk k/v there, so the
  decode step keeps one fixed shape whatever the occupancy, and a stray
  write never lands in another sequence's block.
- **Freed blocks are zero-scrubbed** before they return to the free-list,
  so a reused block carries nothing of the request before.
- **Exhaustion is structured.**  An allocation the free-list cannot meet
  raises the serving taxonomy's retriable :class:`Overloaded` with
  ``blocks_needed`` and ``blocks_free``: the pool is sized once, at
  construction, through :func:`bigdl_tpu_torch.resources.device.
  preflight_pool`, so running out of blocks is an admission answer, never a
  device out-of-memory error.

The JAX package replaces its pools functionally; here :attr:`k` and
:attr:`v` are updated **in place** and never reallocated, which is what lets
the decode step's CUDA graph read and write them at fixed addresses.  The
free-list and tables are host state under a lock.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List

import torch

from bigdl_tpu_torch.engine import DeviceLike, default_device
from bigdl_tpu_torch.resources.device import preflight_pool
from bigdl_tpu_torch.serving.engine import Overloaded

#: the block every padded or inactive-slot scatter targets: reserved at
#: construction, never handed out by the free-list
DUMP_BLOCK = 0


class PagedKVCache:
    """Fixed device pool of (layer, block, block_size, head, head_dim) K/V
    blocks on ``device`` (default ``"cuda"``), a host free-list and a block
    table per sequence."""

    def __init__(self, n_layers: int, n_head: int, head_dim: int,
                 n_blocks: int, block_size: int,
                 dtype: torch.dtype = torch.float32,
                 label: str = "lm_kv_cache", device: DeviceLike = "cuda"):
        if n_blocks < 2:
            raise ValueError(
                f"paged KV cache needs >= 2 blocks (block {DUMP_BLOCK} is "
                f"the reserved dump block), got n_blocks={n_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.device = default_device(device)
        self.n_layers = int(n_layers)
        self.n_head = int(n_head)
        self.head_dim = int(head_dim)
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.dtype = dtype
        self.label = label
        shape = (self.n_layers, self.n_blocks, self.block_size,
                 self.n_head, self.head_dim)
        self.pool_nbytes = 2 * math.prod(shape) * dtype.itemsize
        # gate BEFORE the buffers exist: an over-budget pool is a sizing
        # error answered while device memory is untouched
        preflight_pool(self.pool_nbytes, label, self.device)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self._free: List[int] = list(range(self.n_blocks - 1, 0, -1))  # guarded-by: _lock
        self._tables: Dict[int, List[int]] = {}         # guarded-by: _lock
        self._lock = threading.Lock()

    # -- capacity ---------------------------------------------------------

    @property
    def allocatable_blocks(self) -> int:
        """Blocks the free-list can ever hand out (the pool minus the dump
        block)."""
        return self.n_blocks - 1

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.allocatable_blocks - self.free_blocks

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks a sequence of ``n_tokens`` positions occupies."""
        return max(1, math.ceil(n_tokens / self.block_size))

    def can_allocate(self, n_tokens: int) -> bool:
        with self._lock:
            return self.blocks_for(n_tokens) <= len(self._free)

    # -- allocation -------------------------------------------------------

    def allocate(self, seq_id: int, n_tokens: int) -> List[int]:
        """Reserve the blocks of a sequence of up to ``n_tokens`` positions,
        or raise a retriable :class:`Overloaded`."""
        need = self.blocks_for(n_tokens)
        with self._lock:
            if seq_id in self._tables:
                raise ValueError(f"sequence {seq_id} already holds "
                                 f"{len(self._tables[seq_id])} block(s)")
            if need > len(self._free):
                err = Overloaded(
                    "kv blocks exhausted",
                    queue_depth=self.allocatable_blocks - len(self._free),
                    max_depth=self.allocatable_blocks)
                err.blocks_needed = need
                err.blocks_free = len(self._free)
                raise err
            blocks = [self._free.pop() for _ in range(need)]
            self._tables[seq_id] = blocks
        return list(blocks)

    def table(self, seq_id: int) -> List[int]:
        with self._lock:
            return list(self._tables[seq_id])

    def free_seq(self, seq_id: int) -> int:
        """Return a sequence's blocks to the free-list, zeroing them on the
        device first.  Returns the block count (0 when the sequence holds
        nothing: idempotent)."""
        with self._lock:
            blocks = self._tables.pop(seq_id, None)
            if not blocks:
                return 0
        self._scrub(blocks)
        with self._lock:
            self._free.extend(blocks)
        return len(blocks)

    def _scrub(self, blocks: List[int]) -> None:
        """Zero the named blocks across all layers, in place."""
        idx = torch.tensor(blocks, dtype=torch.int64).to(self.device)
        self.k[:, idx] = 0
        self.v[:, idx] = 0
