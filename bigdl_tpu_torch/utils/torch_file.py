"""Torch7 ``.t7`` binary serialization: reader + writer
(``bigdl_tpu/utils/torch_file.py``: ``load`` :297, ``save`` :303; reference
``utils/TorchFile.scala:67``), byte for byte the JAX package's format.

Format (little-endian): each value is a type tag (int32) followed by the
payload.  Tags: NIL=0, NUMBER=1 (double), STRING=2 (len+bytes), TABLE=3,
TORCH=4 (object: index, version string ``V <n>``, class name, class payload),
BOOLEAN=5.  Objects are memoised by index so aliased tensors/tables
round-trip as aliases.  Tensors serialize as (ndim, sizes, strides,
storage-offset(1-based), Storage object); storages as (size, raw data).

Scope: numbers, booleans, strings, tables (dict/list), Float/Double/Long/
Int/Byte tensors and storages — the subset the reference's model/tensor
files actually contain.  Unknown torch classes raise with the class name.
Tensors are read as numpy arrays, as in the JAX package; the writer takes
numpy arrays or ``torch.Tensor`` s (copied to the host), a tensor written
twice being written once and referenced after, as an array is.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Dict, Optional

import numpy as np
import torch

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5

_TENSOR_CLASSES = {
    "torch.DoubleTensor": np.float64,
    "torch.FloatTensor": np.float32,
    "torch.LongTensor": np.int64,
    "torch.IntTensor": np.int32,
    "torch.ByteTensor": np.uint8,
    "torch.CharTensor": np.int8,
    "torch.ShortTensor": np.int16,
}
_STORAGE_CLASSES = {
    "torch.DoubleStorage": np.float64,
    "torch.FloatStorage": np.float32,
    "torch.LongStorage": np.int64,
    "torch.IntStorage": np.int32,
    "torch.ByteStorage": np.uint8,
    "torch.CharStorage": np.int8,
    "torch.ShortStorage": np.int16,
}
_DTYPE_TO_TENSOR = {np.dtype(v): k for k, v in _TENSOR_CLASSES.items()}
_DTYPE_TO_STORAGE = {np.dtype(v): k for k, v in _STORAGE_CLASSES.items()}


class TorchObject:
    """A torch class instance, kept as (class_name, payload table).

    The reader produces these for any non-tensor torch class (nn modules,
    optim states, …); the writer serializes them back, so module trees
    round-trip.  ``utils/torch_module.py`` converts nn.* trees to Modules."""

    def __init__(self, torch_class: str, payload: Any):
        self.torch_class = torch_class
        self.payload = payload

    def __repr__(self):
        return f"TorchObject({self.torch_class})"


class LongStorage:
    """Marks an int sequence to serialize as ``torch.LongStorage`` (torch
    stores View/Reshape sizes as storages, not tensors)."""

    def __init__(self, values):
        self.values = np.asarray(values, dtype=np.int64).ravel()

    def __repr__(self):
        return f"LongStorage({self.values.tolist()})"


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.memo: Dict[int, Any] = {}

    def _i32(self) -> int:
        return struct.unpack("<i", self.f.read(4))[0]

    def _i64(self) -> int:
        return struct.unpack("<q", self.f.read(8))[0]

    def _f64(self) -> float:
        return struct.unpack("<d", self.f.read(8))[0]

    def read(self) -> Any:
        tag = self._i32()
        if tag == TYPE_NIL:
            return None
        if tag == TYPE_NUMBER:
            v = self._f64()
            import math
            return int(v) if math.isfinite(v) and v == int(v) else v
        if tag == TYPE_STRING:
            n = self._i32()
            return self.f.read(n).decode("utf-8", errors="replace")
        if tag == TYPE_BOOLEAN:
            return self._i32() == 1
        if tag == TYPE_TABLE:
            return self._read_table()
        if tag == TYPE_TORCH:
            return self._read_torch()
        raise ValueError(f"unknown t7 type tag {tag}")

    def _read_table(self) -> Any:
        idx = self._i32()
        if idx in self.memo:
            return self.memo[idx]
        out: Dict[Any, Any] = {}
        self.memo[idx] = out
        n = self._i32()
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        # 1..n integer keys -> python list (lua array-style table)
        if out and all(isinstance(k, int) for k in out) and \
                sorted(out) == list(range(1, len(out) + 1)):
            lst = [out[i] for i in range(1, len(out) + 1)]
            self.memo[idx] = lst
            return lst
        return out

    def _raw_string(self) -> str:
        """Class/version strings inside a TORCH record carry no type tag."""
        n = self._i32()
        return self.f.read(n).decode("utf-8", errors="replace")

    def _read_torch(self) -> Any:
        idx = self._i32()
        if idx in self.memo:
            return self.memo[idx]
        version = self._raw_string()  # "V 1"-style version marker
        if version.startswith("V "):
            cls = self._raw_string()
        else:  # legacy files: no version record, that WAS the class name
            cls = version
        if cls in _TENSOR_CLASSES:
            t = self._read_tensor(np.dtype(_TENSOR_CLASSES[cls]))
            self.memo[idx] = t
            return t
        if cls in _STORAGE_CLASSES:
            s = self._read_storage(np.dtype(_STORAGE_CLASSES[cls]))
            self.memo[idx] = s
            return s
        obj = TorchObject(cls, self.read())
        self.memo[idx] = obj
        return obj

    def _read_tensor(self, dtype) -> np.ndarray:
        ndim = self._i32()
        sizes = [self._i64() for _ in range(ndim)]
        strides = [self._i64() for _ in range(ndim)]
        offset = self._i64() - 1  # 1-based
        storage = self.read()
        if ndim == 0 or storage is None:
            return np.zeros(sizes, dtype=dtype)
        flat = np.asarray(storage, dtype=dtype)
        itemsize = flat.itemsize
        return np.lib.stride_tricks.as_strided(
            flat[offset:], shape=sizes,
            strides=[s * itemsize for s in strides]).copy()

    def _read_storage(self, dtype) -> np.ndarray:
        n = self._i64()
        return np.frombuffer(self.f.read(n * dtype.itemsize),
                             dtype=dtype).copy()


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

class _Writer:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.memo: Dict[int, int] = {}   # id(obj) -> index
        # memoised objects are kept alive so CPython cannot reuse their id
        # for a later, distinct object (which would serialize as an alias)
        self._keep: list = []
        self.next_index = 1

    def _i32(self, v: int) -> None:
        self.f.write(struct.pack("<i", v))

    def _i64(self, v: int) -> None:
        self.f.write(struct.pack("<q", v))

    def _raw_string(self, s: str) -> None:
        data = s.encode("utf-8")
        self._i32(len(data))
        self.f.write(data)

    def write(self, obj: Any) -> None:
        if obj is None:
            self._i32(TYPE_NIL)
        elif isinstance(obj, bool):
            self._i32(TYPE_BOOLEAN)
            self._i32(1 if obj else 0)
        elif isinstance(obj, (int, float)):
            self._i32(TYPE_NUMBER)
            self.f.write(struct.pack("<d", float(obj)))
        elif isinstance(obj, str):
            data = obj.encode("utf-8")
            self._i32(TYPE_STRING)
            self._i32(len(data))
            self.f.write(data)
        elif isinstance(obj, (np.ndarray, torch.Tensor)):
            self._write_tensor(obj)
        elif isinstance(obj, TorchObject):
            self._i32(TYPE_TORCH)
            if self._memoise(obj) is not None:
                return
            self._raw_string("V 1")
            self._raw_string(obj.torch_class)
            self.write(obj.payload)
        elif isinstance(obj, LongStorage):
            self._i32(TYPE_TORCH)
            if self._memoise(obj) is not None:
                return
            self._raw_string("V 1")
            self._raw_string("torch.LongStorage")
            self._i64(obj.values.size)
            self.f.write(obj.values.tobytes())
        elif isinstance(obj, dict):
            self._write_table(obj, obj.items())
        elif isinstance(obj, (list, tuple)):
            self._write_table(obj, ((i + 1, v) for i, v in enumerate(obj)),
                              n=len(obj))
        else:
            raise TypeError(f"cannot serialize {type(obj).__name__} to .t7")

    def _memoise(self, obj) -> Optional[int]:
        """Returns the existing index (after writing it) or None if new."""
        if id(obj) in self.memo:
            self._i32(self.memo[id(obj)])
            return self.memo[id(obj)]
        self.memo[id(obj)] = self.next_index
        self._keep.append(obj)
        self._i32(self.next_index)
        self.next_index += 1
        return None

    def _write_table(self, obj, items, n: Optional[int] = None) -> None:
        self._i32(TYPE_TABLE)
        if self._memoise(obj) is not None:
            return
        self._i32(len(obj) if n is None else n)
        for k, v in items:
            self.write(k)
            self.write(v)

    def _write_tensor(self, obj) -> None:
        arr = (obj.detach().cpu().numpy() if isinstance(obj, torch.Tensor)
               else obj)
        cls = _DTYPE_TO_TENSOR.get(arr.dtype)
        if cls is None:
            arr = arr.astype(np.float32)
            cls = "torch.FloatTensor"
        self._i32(TYPE_TORCH)
        if self._memoise(obj) is not None:
            return
        self._raw_string("V 1")
        self._raw_string(cls)
        arr = np.ascontiguousarray(arr)
        self._i32(arr.ndim)
        for s in arr.shape:
            self._i64(s)
        stride = 1
        strides = []
        for s in reversed(arr.shape):
            strides.append(stride)
            stride *= s
        for s in reversed(strides):
            self._i64(s)
        self._i64(1)  # storage offset, 1-based
        # storage object
        self._i32(TYPE_TORCH)
        self._i32(self.next_index)
        self.next_index += 1
        self._raw_string("V 1")
        self._raw_string(_DTYPE_TO_STORAGE[arr.dtype])
        self._i64(arr.size)
        self.f.write(arr.tobytes())


def load(path: str) -> Any:
    """Read one value from a ``.t7`` file (reference ``TorchFile.load``)."""
    with open(path, "rb") as f:
        return _Reader(f).read()


def save(path: str, obj: Any) -> None:
    """Write one value to a ``.t7`` file (reference ``TorchFile.save``)."""
    with open(path, "wb") as f:
        _Writer(f).write(obj)
