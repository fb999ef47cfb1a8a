"""Resource limits of the port (``bigdl_tpu/resources``): the device-memory
preflight of fixed pools, the resource-exhaustion errors and the disk-full
degradation of the telemetry exports.  The host-memory governor and the
per-step preflight are not ported yet."""

from bigdl_tpu_torch.resources.device import preflight_pool
from bigdl_tpu_torch.resources.errors import (DeviceMemoryError,
                                              HostMemoryError, ResourceError,
                                              StorageExhaustedError,
                                              is_oom_error,
                                              is_storage_exhausted)

__all__ = ["DeviceMemoryError", "HostMemoryError", "ResourceError",
           "StorageExhaustedError", "is_oom_error", "is_storage_exhausted",
           "preflight_pool"]
