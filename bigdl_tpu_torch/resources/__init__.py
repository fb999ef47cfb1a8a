"""Resource limits of the port (``bigdl_tpu/resources``): the device-memory
preflight of fixed pools, the resource-exhaustion errors and their
classifiers, the microbatch re-plan after a device OOM
(:mod:`~bigdl_tpu_torch.resources.microbatch`), the host-memory governor
(:mod:`~bigdl_tpu_torch.resources.governor`) and the disk-full degradation
of the telemetry exports.  The per-step device preflight against
``bigdl.resources.deviceMemBudgetMB`` is not ported: a budget set there is
refused where the trainers and engines start (``utils/chaos.py``
``UNHONOURED_KEYS``)."""

from bigdl_tpu_torch.resources.device import (classify_dispatch_error,
                                              preflight_pool)
from bigdl_tpu_torch.resources.errors import (DeviceMemoryError,
                                              HostMemoryError, ResourceError,
                                              StorageExhaustedError,
                                              is_oom_error,
                                              is_storage_exhausted)
from bigdl_tpu_torch.resources.governor import (GOVERNOR, Account,
                                                HostMemoryGovernor,
                                                item_nbytes)

__all__ = ["Account", "DeviceMemoryError", "GOVERNOR", "HostMemoryError",
           "HostMemoryGovernor", "ResourceError", "StorageExhaustedError",
           "classify_dispatch_error", "is_oom_error", "is_storage_exhausted",
           "item_nbytes", "preflight_pool"]
