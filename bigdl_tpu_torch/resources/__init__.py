"""Resource limits of the port (``bigdl_tpu/resources``): the device-memory
preflight of fixed pools.  The host-memory governor, storage exhaustion and
the per-step preflight are not ported yet."""

from bigdl_tpu_torch.resources.device import DeviceMemoryError, preflight_pool

__all__ = ["DeviceMemoryError", "preflight_pool"]
