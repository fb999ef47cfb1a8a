"""Device-memory preflight of a fixed device pool
(``bigdl_tpu/resources/device.py`` :61 ``preflight_pool``;
``bigdl_tpu/resources/errors.py`` ``DeviceMemoryError``).

The JAX package gates a pool against ``bigdl.resources.deviceMemBudgetMB``.
On a CUDA device the port's budget is what the card has free
(``torch.cuda.mem_get_info``), so an over-budget pool raises before any of
its buffers exist, never as an out-of-memory error halfway through serving.
On the CPU the gate passes through, as the JAX package's does when no budget
is set.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.engine import DeviceLike


class DeviceMemoryError(RuntimeError):
    """A device buffer does not fit device memory.  ``phase`` is
    ``"preflight"`` (found before anything was allocated) or
    ``"dispatch"``."""

    def __init__(self, label: str, peak_bytes: Optional[int],
                 budget_bytes: Optional[int], phase: str = "dispatch"):
        self.label = label
        self.peak_bytes = peak_bytes
        self.budget_bytes = budget_bytes
        self.phase = phase
        peak = "?" if peak_bytes is None else f"{peak_bytes}"
        budget = "?" if budget_bytes is None else f"{budget_bytes}"
        super().__init__(
            f"device memory exhausted ({phase}) on {label!r}: needs {peak} B "
            f"vs budget {budget} B")


def preflight_pool(nbytes: int, label: str, device: DeviceLike) -> int:
    """Gate a fixed pool of ``nbytes`` on ``device`` before it is
    allocated: on a CUDA device, raise :class:`DeviceMemoryError` when the
    card has fewer bytes free.  Returns ``nbytes``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        free, _ = torch.cuda.mem_get_info(dev)
        if nbytes > free:
            raise DeviceMemoryError(label, nbytes, free, phase="preflight")
    return int(nbytes)
