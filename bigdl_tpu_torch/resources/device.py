"""Device-memory preflight of a fixed device pool
(``bigdl_tpu/resources/device.py`` :61 ``preflight_pool``;
``bigdl_tpu/resources/errors.py`` ``DeviceMemoryError``).

The JAX package gates a pool against ``bigdl.resources.deviceMemBudgetMB``,
which the port refuses (``utils/chaos.py`` ``UNHONOURED_KEYS``).  On a CUDA
device the port's budget is what the card has free
(``torch.cuda.mem_get_info``), so an over-budget pool raises before any of
its buffers exist, never as an out-of-memory error halfway through serving.
On the CPU the gate passes through, as the JAX package's does when no budget
is set.

:func:`classify_dispatch_error` (JAX :83) folds an allocation failure raised
by a training step (``torch.cuda.OutOfMemoryError``, a cuBLAS allocation
failure, the chaos injector's ``RESOURCE_EXHAUSTED``) into the structured
:class:`DeviceMemoryError` that the trainers answer with a microbatch
re-plan.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.engine import DeviceLike
from bigdl_tpu_torch.resources.errors import DeviceMemoryError, is_oom_error


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


def classify_dispatch_error(e: BaseException, label: str,
                            device: DeviceLike = "cpu"
                            ) -> "DeviceMemoryError | None":
    """The :class:`DeviceMemoryError` (``phase="dispatch"``, counted in
    ``Resources/device_oom``) that ``e`` is, or None when ``e`` is not an
    allocation failure.  The returned error carries no reference to ``e``
    (its cause and traceback would keep the failed step's activations
    alive); ``str(e)``'s first line goes into its message."""
    if isinstance(e, DeviceMemoryError):
        return e
    if not is_oom_error(e):
        return None
    from bigdl_tpu_torch import telemetry
    telemetry.counter(
        "Resources/device_oom",
        help="device-memory faults (preflight breaches and dispatch "
             "allocation failures)").inc()
    dev = torch.device(device)
    budget = (torch.cuda.mem_get_info(dev)[1] if dev.type == "cuda"
              else None)
    err = DeviceMemoryError(label, None, budget, phase="dispatch")
    err.detail = (str(e).splitlines() or [type(e).__name__])[0]
    return err
