"""Structured resource-exhaustion errors and their classifiers
(``bigdl_tpu/resources/errors.py``).

* :class:`DeviceMemoryError` — a device buffer does not fit device memory,
  found before anything was allocated (``phase="preflight"``,
  :func:`~bigdl_tpu_torch.resources.device.preflight_pool`) or at dispatch.
* :class:`HostMemoryError` — one buffered item exceeds the host-memory
  budget (:meth:`~bigdl_tpu_torch.resources.governor.HostMemoryGovernor.
  check_item`); the trainers treat it as fatal.
* :class:`StorageExhaustedError` — ENOSPC/EDQUOT classified at the
  ``file_io.write_bytes`` choke point.  ``fatal = True`` so the transient
  IO retry refuses to absorb it (re-writing to a full disk yields a full
  disk); the telemetry exports degrade instead
  (:mod:`~bigdl_tpu_torch.resources.storage`).

The module imports only the standard library, so ``utils.file_io`` can
import it.
"""

from __future__ import annotations

import errno
from typing import Optional


class ResourceError(RuntimeError):
    """Base class of the resource faults: exhaustion of device memory, host
    memory or storage, never a numerics problem."""


class DeviceMemoryError(ResourceError):
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


class HostMemoryError(ResourceError):
    """A single buffered item exceeds the host-memory budget: even depth 1
    cannot fit, so the run escalates with the owning account named."""

    def __init__(self, account: str, nbytes: int, budget_bytes: int):
        self.account = account
        self.nbytes = nbytes
        self.budget_bytes = budget_bytes
        super().__init__(
            f"host memory budget exhausted: one item of {nbytes} B in "
            f"buffer {account!r} exceeds "
            f"bigdl.resources.hostMemBudgetMB ({budget_bytes} B) — "
            "even depth 1 cannot fit; lower the batch/record size or "
            "raise the budget")


class StorageExhaustedError(OSError):
    """ENOSPC/EDQUOT classified at the payload-write choke point.
    ``fatal`` makes ``file_io._is_transient`` refuse to retry it."""

    #: never absorbed by the transient-IO retry
    fatal = True

    def __init__(self, path: str, original: Optional[BaseException] = None):
        self.path = path
        self.original = original
        code = getattr(original, "errno", None) or errno.ENOSPC
        super().__init__(code,
                         f"storage exhausted writing {path} "
                         f"({errno.errorcode.get(code, code)})")


#: substrings of an allocation failure's message: XLA's RESOURCE_EXHAUSTED
#: status (which the chaos injector's replica carries), the caching
#: allocator's "CUDA out of memory", and cuBLAS failing to allocate its
#: workspace or handle, the same exhaustion surfacing in another library
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory",
                "out of memory", "OOM when allocating",
                "CUBLAS_STATUS_ALLOC_FAILED")

_STORAGE_ERRNOS = (errno.ENOSPC, errno.EDQUOT)


def is_oom_error(e: BaseException) -> bool:
    """True when ``e`` is a device allocation failure."""
    if isinstance(e, DeviceMemoryError):
        return True
    msg = str(e)
    return any(m in msg for m in _OOM_MARKERS)


def is_storage_exhausted(e: BaseException) -> bool:
    """True when ``e`` is a disk-full class error (already classified, or a
    raw OSError carrying ENOSPC/EDQUOT)."""
    if isinstance(e, StorageExhaustedError):
        return True
    return (isinstance(e, OSError) and
            getattr(e, "errno", None) in _STORAGE_ERRNOS)
