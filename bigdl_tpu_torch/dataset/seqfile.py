"""Hadoop SequenceFile records, the ImageNet storage format of the reference
(``bigdl_tpu/dataset/seqfile.py`` :132-419; reference
``dataset/DataSet.scala:500-558``).

Two readers: the native one (``native/seqfile.cc`` through
:mod:`bigdl_tpu_torch.dataset.native`, which builds it at first use and
raises if it cannot) and a Python one, which also names the byte offset and
index of a corrupt record and can resync past it
(:func:`read_records_resilient`).  Two writers likewise.  Keys are Hadoop
``Text`` ("name label"), values ``BytesWritable`` (a 4-byte big-endian
length, then the JPEG), byte-compatible with the reference's writer.

Both readers cap a record's length before they allocate
(``MAX_RECORD_BYTES``, 1 GiB): a flipped bit in a length field raises
:class:`CorruptRecordError` instead of asking for gigabytes.  A cap other
than the native reader's compiled-in one reads through the Python reader,
which honours it.
"""

from __future__ import annotations

import ctypes
import io
import struct
from typing import Iterator, List, Optional, Tuple

from bigdl_tpu_torch.dataset.native import load_native

SYNC = bytes(range(16))          # fixed sync marker for files we write

_NATIVE_MAX_RECORD_BYTES = 1 << 30
MAX_RECORD_BYTES = _NATIVE_MAX_RECORD_BYTES


def _read_vlong(f) -> Optional[int]:
    b = f.read(1)
    if not b:
        return None
    first = struct.unpack("b", b)[0]
    if first >= -112:
        return first
    neg = first < -120
    n = -(first + 120) if neg else -(first + 112)
    v = 0
    for byte in f.read(n):
        v = (v << 8) | byte
    return ~v if neg else v


def _write_vlong(f, v: int) -> None:
    if -112 <= v <= 127:
        f.write(struct.pack("b", v))
        return
    length = -112
    if v < 0:
        v = ~v
        length = -120
    tmp, n = v, 0
    while tmp:
        tmp >>= 8
        n += 1
    f.write(struct.pack("b", length - n))
    for i in range(n - 1, -1, -1):
        f.write(bytes([(v >> (8 * i)) & 0xFF]))


def _write_text(f, s: bytes) -> None:
    _write_vlong(f, len(s))
    f.write(s)


def _read_text(f) -> bytes:
    n = _read_vlong(f)
    if n is None or n < 0:
        raise IOError("truncated Text")
    return f.read(n)


class CorruptRecordError(IOError):
    """A structurally corrupt record (bad length field, short read, bad
    sync marker), with the byte offset where its framing broke and its
    0-based index, so that a resilient reader can resync past it."""

    #: corrupt bytes read as corrupt bytes again: never a transient fault
    fatal = True

    def __init__(self, path: str, offset: int, record_index: int,
                 detail: str = "corrupt record"):
        super().__init__(
            f"corrupt SequenceFile record {record_index} at offset "
            f"{offset} in {path}: {detail}")
        self.path = path
        self.offset = int(offset)
        self.record_index = int(record_index)


def _read_header(f, path: str) -> bytes:
    """Consume the header and return the file's sync marker; the stream is
    left at the first record."""
    if f.read(3) != b"SEQ":
        raise IOError(f"{path} is not a SequenceFile")
    version = f.read(1)[0]
    if version < 5:
        raise IOError(f"unsupported SequenceFile version {version}")
    _read_text(f)            # key class
    _read_text(f)            # value class
    compressed, block = f.read(1)[0], f.read(1)[0]
    if compressed or block:
        raise IOError("compressed SequenceFiles are unsupported")
    (meta,) = struct.unpack(">i", f.read(4))
    for _ in range(meta):
        _read_text(f)
        _read_text(f)
    return f.read(16)


def _py_read_from(f, path: str, sync: bytes, cap: int, start_index: int
                  ) -> Iterator[Tuple[bytes, bytes]]:
    """The record loop of the Python readers, from a record boundary."""
    index = start_index
    while True:
        rec_off = f.tell()
        raw = f.read(4)
        if not raw:          # clean end: zero bytes at a boundary
            return
        if len(raw) < 4:
            raise CorruptRecordError(path, rec_off, index,
                                     "truncated length field")
        (rec_len,) = struct.unpack(">i", raw)
        if rec_len == -1:
            if f.read(16) != sync:   # a short read is truncation too
                raise CorruptRecordError(path, rec_off, index,
                                         "bad sync marker")
            continue
        if rec_len < 0 or rec_len > cap:
            raise CorruptRecordError(
                path, rec_off, index,
                f"implausible record length {rec_len} (cap {cap})")
        raw_kl = f.read(4)
        if len(raw_kl) < 4:
            raise CorruptRecordError(path, rec_off, index,
                                     "truncated key-length field")
        (key_len,) = struct.unpack(">i", raw_kl)
        if key_len < 0 or key_len > rec_len:
            raise CorruptRecordError(
                path, rec_off, index,
                f"key length {key_len} outside record length {rec_len}")
        key = f.read(key_len)
        value = f.read(rec_len - key_len)
        if len(key) != key_len or len(value) != rec_len - key_len:
            raise CorruptRecordError(path, rec_off, index,
                                     "record body truncated")
        yield key, value
        index += 1


def py_read_records(path: str, max_record_bytes: Optional[int] = None
                    ) -> Iterator[Tuple[bytes, bytes]]:
    """(key, value) pairs of an uncompressed SequenceFile, read in Python;
    a corrupt record raises :class:`CorruptRecordError`."""
    cap = MAX_RECORD_BYTES if max_record_bytes is None else max_record_bytes
    with open(path, "rb") as f:
        sync = _read_header(f, path)
        yield from _py_read_from(f, path, sync, cap, 0)


def find_next_sync(path: str, offset: int,
                   sync: Optional[bytes] = None) -> Optional[int]:
    """Byte offset of the first sync escape (a ``-1`` length and the file's
    marker) at or after ``offset``, or None."""
    with open(path, "rb") as f:
        if sync is None:
            sync = _read_header(f, path)
        needle = struct.pack(">i", -1) + sync
        pos = max(0, int(offset))
        f.seek(pos)
        carry = b""
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return None
            buf = carry + chunk
            hit = buf.find(needle)
            if hit != -1:
                return pos - len(carry) + hit
            # a needle-sized tail finds a marker split across chunks
            carry = buf[-(len(needle) - 1):]
            pos = f.tell()


def read_records_resilient(path: str, on_skip=None,
                           max_record_bytes: Optional[int] = None
                           ) -> Iterator[Tuple[bytes, bytes]]:
    """(key, value) pairs, resyncing past corrupt records: each skip calls
    ``on_skip(error, resume_offset)`` (``resume_offset`` None when no later
    sync marker exists, and the file ends there); without ``on_skip`` the
    error raises.  Always the Python reader."""
    cap = MAX_RECORD_BYTES if max_record_bytes is None else max_record_bytes
    with open(path, "rb") as f:
        sync = _read_header(f, path)
        index = 0
        while True:
            try:
                for key, value in _py_read_from(f, path, sync, cap, index):
                    index += 1
                    yield key, value
                return
            except CorruptRecordError as e:
                if on_skip is None:
                    raise
                resume = find_next_sync(path, e.offset + 1, sync)
                on_skip(e, resume)
                if resume is None:
                    return
                f.seek(resume)
                index = e.record_index


def py_write_records(path: str, records,
                     key_class: str = "org.apache.hadoop.io.Text",
                     value_class: str = "org.apache.hadoop.io.BytesWritable"
                     ) -> None:
    """Write (key, value) byte pairs in Python, a sync escape every 2000
    bytes or so, as the native writer does."""
    with open(path, "wb") as f:
        f.write(b"SEQ")
        f.write(bytes([6]))
        _write_text(f, key_class.encode())
        _write_text(f, value_class.encode())
        f.write(b"\x00\x00")
        f.write(struct.pack(">i", 0))
        f.write(SYNC)
        since = 0
        for key, value in records:
            if since > 2000:
                f.write(struct.pack(">i", -1))
                f.write(SYNC)
                since = 0
            f.write(struct.pack(">i", len(key) + len(value)))
            f.write(struct.pack(">i", len(key)))
            f.write(key)
            f.write(value)
            since += len(key) + len(value) + 8


def read_records(path: str, max_record_bytes: Optional[int] = None
                 ) -> Iterator[Tuple[bytes, bytes]]:
    """(key, value) pairs through the native reader (the Python one for a
    cap other than the native reader's)."""
    cap = MAX_RECORD_BYTES if max_record_bytes is None else max_record_bytes
    if cap != _NATIVE_MAX_RECORD_BYTES:
        yield from py_read_records(path, max_record_bytes=cap)
        return
    lib = load_native()
    handle = lib.seqfile_open(path.encode())
    if not handle:
        raise IOError(f"cannot open SequenceFile {path}")
    try:
        key_p, val_p = ctypes.c_char_p(), ctypes.c_char_p()
        klen, vlen = ctypes.c_int(), ctypes.c_int()
        while True:
            rc = lib.seqfile_next(handle, ctypes.byref(key_p),
                                  ctypes.byref(klen), ctypes.byref(val_p),
                                  ctypes.byref(vlen))
            if rc == 0:
                return
            if rc < 0:
                # the native reader knows only "corrupt": replay in Python
                # to name the offset and index
                for _ in py_read_records(path, max_record_bytes=cap):
                    pass
                err = IOError(
                    f"corrupt SequenceFile {path} (the native reader failed "
                    "where the Python reader read it clean)")
                err.fatal = True
                raise err
            yield (ctypes.string_at(key_p, klen.value),
                   ctypes.string_at(val_p, vlen.value))
    finally:
        lib.seqfile_close(handle)


def write_records(path: str, records) -> None:
    """Write (key, value) byte pairs through the native writer."""
    lib = load_native()
    handle = lib.seqfile_create(path.encode(), b"org.apache.hadoop.io.Text",
                                b"org.apache.hadoop.io.BytesWritable", SYNC)
    if not handle:
        raise IOError(f"cannot create SequenceFile {path}")
    try:
        for key, value in records:
            lib.seqfile_append(handle, key, len(key), value, len(value))
    finally:
        lib.seqfile_close_writer(handle)


def _text_frame(payload: bytes) -> bytes:
    buf = io.BytesIO()
    _write_text(buf, payload)
    return buf.getvalue()


def _text_unframe(raw: bytes) -> bytes:
    return _read_text(io.BytesIO(raw))


def image_records(entries):
    """(key, value) SequenceFile records of (name, label, image bytes)."""
    for name, label, data in entries:
        yield (_text_frame(f"{name} {label:g}".encode()),
               struct.pack(">i", len(data)) + data)


def write_image_seqfile(path: str, entries: List[Tuple[str, float, bytes]]
                        ) -> None:
    """entries: (name, label, image bytes).  Key ``Text("name label")``,
    value ``BytesWritable``: the reference's ImageNet record, through the
    native writer (``py_write_records(path, image_records(entries))``
    writes the same bytes in Python)."""
    write_records(path, image_records(entries))


def parse_image_record(key: bytes, value: bytes) -> Tuple[str, float, bytes]:
    """(name, label, image bytes) of one record."""
    name, _, label = _text_unframe(key).decode().rpartition(" ")
    (n,) = struct.unpack(">i", value[:4])
    return name, float(label), value[4:4 + n]


def read_image_seqfile(path: str) -> Iterator[Tuple[str, float, bytes]]:
    """(name, label, image bytes) of each record, through the native
    reader."""
    for key, value in read_records(path):
        yield parse_image_record(key, value)


def read_image_seqfile_resilient(path: str, on_skip=None
                                 ) -> Iterator[Tuple[str, float, bytes]]:
    """:func:`read_image_seqfile` over :func:`read_records_resilient`; a
    record whose framing survived but whose key or value prefix no longer
    parses is skipped through the same ``on_skip``."""
    for key, value in read_records_resilient(path, on_skip=on_skip):
        try:
            rec = parse_image_record(key, value)
        except (ValueError, IOError, struct.error,
                UnicodeDecodeError) as e:
            if on_skip is None:
                raise
            on_skip(e, None)
            continue
        yield rec
