"""Persistence on local paths (``bigdl_tpu/utils/file_io.py``; reference
``utils/File.scala:25``).

Every payload write goes through :func:`write_bytes`: a temporary file in
the destination's directory, then a rename, so that a crash mid-write
never leaves a truncated file under the final name.  :func:`save` and
:func:`load` write and read plain data and tensors with ``torch.save`` and
``torch.load(weights_only=True)``: nothing arbitrary is unpickled.

:func:`retrying` is the JAX package's transient-error policy
(``bigdl.io.retryTimes`` / ``bigdl.io.retryInterval``, capped doubling
waits): an ``OSError`` or ``TimeoutError`` is retried, a state error
(missing file, exists, permission, a directory where a file is wanted) or
anything marked ``fatal`` never is.

Only local paths (plain or ``file://``) are ported.  The JAX package
reaches ``hdfs://``, ``s3://``, ``gs://``, ``memory://`` and the other
fsspec schemes through ``fsspec``, which the card's machine does not
have: a path with such a scheme raises :class:`NotImplementedError`.
"""

from __future__ import annotations

import io
import logging
import os
import re
import tempfile
import time
from typing import Any, List, Optional

import torch

from bigdl_tpu_torch.utils import config

logger = logging.getLogger("bigdl_tpu_torch")

#: OSError subclasses that signal a state problem, not a blip
_NON_TRANSIENT = (FileNotFoundError, FileExistsError, IsADirectoryError,
                  NotADirectoryError, PermissionError)
_SCHEME = re.compile(r"^[A-Za-z][A-Za-z0-9+.-]*://")


def _is_transient(e: BaseException) -> bool:
    if getattr(e, "fatal", False):
        return False
    return (isinstance(e, (OSError, TimeoutError)) and
            not isinstance(e, _NON_TRANSIENT))


def retrying(fn, *args, op: str = ""):
    """``fn(*args)`` with the bounded transient-error retry: up to
    ``bigdl.io.retryTimes`` attempts, waiting ``bigdl.io.retryInterval``
    doubled after each."""
    attempts = max(1, config.get_int("bigdl.io.retryTimes", 3))
    base = config.get_float("bigdl.io.retryInterval", 0.1)
    for attempt in range(1, attempts + 1):
        try:
            return fn(*args)
        except Exception as e:
            if attempt >= attempts or not _is_transient(e):
                raise
            delay = base * (2.0 ** (attempt - 1))
            logger.warning(
                "transient %s failure (attempt %d/%d, retrying in %.2fs): "
                "%r", op or getattr(fn, "__name__", "io"), attempt,
                attempts, delay, e)
            time.sleep(delay)


def _local(path: str) -> str:
    """The local path of ``path``; raises for a remote scheme."""
    if path.startswith("file://"):
        return path[len("file://"):]
    if _SCHEME.match(path):
        raise NotImplementedError(
            f"{path!r}: only local paths are ported; remote schemes "
            "(hdfs://, s3://, gs://, memory://, ...) need fsspec, which the "
            "port does not use yet")
    return path


def makedirs(path: str) -> None:
    os.makedirs(_local(path), exist_ok=True)


def listdir(path: str) -> List[str]:
    """Base names under a directory; [] when it does not exist."""
    path = _local(path)
    return os.listdir(path) if os.path.isdir(path) else []


def join(base: str, *parts: str) -> str:
    if base.startswith("file://"):
        return "/".join([base.rstrip("/")] + [p.strip("/") for p in parts])
    _local(base)
    return os.path.join(base, *parts)


def size(path: str) -> Optional[int]:
    """Byte size of a file, or None when it cannot be read."""
    try:
        return os.path.getsize(_local(path))
    except OSError:
        return None


def modified_time(path: str) -> Optional[float]:
    """Last-modified POSIX time, or None when it cannot be read."""
    try:
        return os.path.getmtime(_local(path))
    except OSError:
        return None


def remove(path: str) -> None:
    """Delete a file; absent is not an error."""
    path = _local(path)
    if os.path.exists(path):
        os.unlink(path)


def write_bytes(path: str, data: bytes, overwrite: bool = True) -> None:
    """Write ``data`` to ``path`` atomically: a temporary file in the same
    directory (``.tmp_bigdl_`` prefix), then a rename.  A full disk
    (ENOSPC/EDQUOT) raises :class:`~bigdl_tpu_torch.resources.errors.
    StorageExhaustedError`, which the transient retry does not absorb."""
    path = _local(path)
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(
            f"{path} already exists and overwrite is False (reference "
            "File.scala overWrite check)")
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_bigdl_")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException as e:
        if os.path.exists(tmp):
            os.unlink(tmp)
        from bigdl_tpu_torch.resources.errors import (StorageExhaustedError,
                                                      is_storage_exhausted)
        if is_storage_exhausted(e) and not isinstance(
                e, StorageExhaustedError):
            raise StorageExhaustedError(path, e) from e
        raise


def read_bytes(path: str) -> bytes:
    with open(_local(path), "rb") as f:
        return f.read()


def dumps(obj: Any) -> bytes:
    """``obj`` (plain data and tensors) as ``torch.save`` bytes."""
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def loads(data: bytes) -> Any:
    """The inverse of :func:`dumps`, with ``weights_only=True``: tensors
    come back on the CPU."""
    return torch.load(io.BytesIO(data), map_location="cpu",
                      weights_only=True)


def save(obj: Any, path: str, overwrite: bool = True) -> None:
    """(reference ``File.save:67``) atomically."""
    write_bytes(path, dumps(obj), overwrite)


def load(path: str) -> Any:
    """(reference ``File.load:162``)."""
    return loads(read_bytes(path))
