"""Checksums of the port (``bigdl_tpu/visualization``): CRC32C.  The
TensorBoard writers are not ported yet."""

from bigdl_tpu_torch.visualization.crc32c import crc32c, masked_crc32c

__all__ = ["crc32c", "masked_crc32c"]
