"""CRC32C (Castagnoli) with TFRecord masking (``bigdl_tpu/visualization/
crc32c.py``; reference ``visualization/tensorboard/netty/Crc32c.java`` and
the masking in ``RecordWriter.scala:30-57``).

Table-driven, polynomial 0x1EDC6F41 (reflected 0x82F63B78).
"""

from __future__ import annotations

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def crc32c(data: bytes, crc: int = 0) -> int:
    crc = crc ^ 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord masking: rotate right by 15 and add a constant."""
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF
