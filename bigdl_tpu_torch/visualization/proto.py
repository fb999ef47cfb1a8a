"""Hand-rolled protobuf wire encoding for TensorFlow Event/Summary messages
(``bigdl_tpu/visualization/proto.py``, byte for byte).

Reference equivalent: the generated ``org.tensorflow.util.Event`` /
``org.tensorflow.framework.Summary`` Java protos consumed by
``visualization/Summary.scala:87-130``.  The rebuild needs only the tiny
subset TensorBoard reads (scalar + histogram events), so the five message
types are encoded directly on the wire format — no protobuf runtime.

Wire format: each field is ``(field_number << 3 | wire_type)`` varint + data.
wire types: 0 varint, 1 fixed64 (double), 2 length-delimited, 5 fixed32.
"""

from __future__ import annotations

import struct
import time
from typing import List, Optional, Sequence


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _string(field: int, v: str) -> bytes:
    return _bytes(field, v.encode("utf-8"))


def _packed_doubles(field: int, vs: Sequence[float]) -> bytes:
    data = b"".join(struct.pack("<d", v) for v in vs)
    return _bytes(field, data)


def encode_histogram(minv: float, maxv: float, num: float, total: float,
                     sum_squares: float, bucket_limits: Sequence[float],
                     buckets: Sequence[float]) -> bytes:
    """HistogramProto: min=1 max=2 num=3 sum=4 sum_squares=5
    bucket_limit=6(packed) bucket=7(packed)."""
    return (_double(1, minv) + _double(2, maxv) + _double(3, num) +
            _double(4, total) + _double(5, sum_squares) +
            _packed_doubles(6, bucket_limits) + _packed_doubles(7, buckets))


def encode_summary_value(tag: str, simple_value: Optional[float] = None,
                         histo: Optional[bytes] = None) -> bytes:
    """Summary.Value: tag=1, simple_value=2(float), histo=5(message)."""
    out = _string(1, tag)
    if simple_value is not None:
        out += _float(2, simple_value)
    if histo is not None:
        out += _bytes(5, histo)
    return out


def encode_summary(values: List[bytes]) -> bytes:
    """Summary: repeated value=1."""
    return b"".join(_bytes(1, v) for v in values)


def encode_event(wall_time: Optional[float] = None, step: Optional[int] = None,
                 file_version: Optional[str] = None,
                 summary: Optional[bytes] = None) -> bytes:
    """Event: wall_time=1(double), step=2(int64), file_version=3(string),
    summary=5(message)."""
    out = _double(1, time.time() if wall_time is None else wall_time)
    if step is not None:
        out += _int64(2, step)
    if file_version is not None:
        out += _string(3, file_version)
    if summary is not None:
        out += _bytes(5, summary)
    return out


# ---------------------------------------------------------------------------
# minimal decoder (test/readback support — reference TrainSummary.readScalar)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int):
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def decode_fields(buf: bytes):
    """Yield (field_number, wire_type, value) triples from one message."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 1:
            v = struct.unpack("<d", buf[pos:pos + 8])[0]
            pos += 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            v = buf[pos:pos + n]
            pos += n
        elif wire == 5:
            v = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


def decode_event(buf: bytes) -> dict:
    """Decode the Event subset written above."""
    out = {"wall_time": None, "step": 0, "file_version": None, "values": []}
    for field, wire, v in decode_fields(buf):
        if field == 1:
            out["wall_time"] = v
        elif field == 2:
            out["step"] = v
        elif field == 3:
            out["file_version"] = v.decode("utf-8")
        elif field == 5:
            for f2, _, v2 in decode_fields(v):
                if f2 == 1:  # Summary.Value
                    val = {"tag": None, "simple_value": None, "histo": None}
                    for f3, w3, v3 in decode_fields(v2):
                        if f3 == 1:
                            val["tag"] = v3.decode("utf-8")
                        elif f3 == 2:
                            val["simple_value"] = v3
                        elif f3 == 5:
                            val["histo"] = v3
                    out["values"].append(val)
    return out
