"""The host-side native library of the data pipeline: SequenceFile reading
and writing and the multi-threaded batch assembler, built from the C++
sources under ``native/`` (``seqfile.cc``, ``batch.cc``) and bound with
ctypes (``bigdl_tpu/dataset/native.py``: the bindings :47-85,
``REQUIRED_SYMBOLS`` :100).

The library is compiled with ``g++ -O3 -fPIC -shared -std=c++17 -pthread``
into ``build/bigdl_tpu_torch/`` at the root of the checkout (listed in
``.gitignore``), named after a hash of the sources and the flags, so an
unchanged source is built once per checkout and an edit builds a new one.
Nothing is built at import: :func:`load_native` builds at the first call
that needs the library.  A build that fails, or a library that lacks one of
``REQUIRED_SYMBOLS``, raises :class:`RuntimeError`; the port has no numpy
stand-in for the native assembler or reader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO, "native")
SOURCES = ("seqfile.cc", "batch.cc")
BUILD_DIR = os.path.join(_REPO, "build", "bigdl_tpu_torch")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

#: every entry point the port calls
REQUIRED_SYMBOLS = ("seqfile_open", "seqfile_next", "seqfile_close",
                    "seqfile_create", "seqfile_append",
                    "seqfile_close_writer", "assemble_batch",
                    "assemble_batch_u8")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: the last build: (library path, compile seconds, 0.0 when it was built
#: before)
build_info: Optional[tuple] = None


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) on PATH: the native data "
                           "pipeline library cannot be built")
    return cxx


def library_path() -> str:
    """Where the library of the current sources and flags lives."""
    digest = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    digest.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libbigdl_native-{digest.hexdigest()[:16]}.so")


def _build() -> tuple:
    target = library_path()
    if os.path.exists(target):
        return target, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_cxx(), *CXX_FLAGS, "-o", tmp,
           *[os.path.join(NATIVE_DIR, s) for s in SOURCES]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed ({' '.join(cmd)} exited "
                           f"{proc.returncode}):\n{proc.stderr[-2000:]}")
    os.replace(tmp, target)   # atomic: a concurrent builder sees all or none
    return target, time.perf_counter() - t0


def _bind(lib: ctypes.CDLL) -> None:
    c_int_p = ctypes.POINTER(ctypes.c_int)
    lib.seqfile_open.restype = ctypes.c_void_p
    lib.seqfile_open.argtypes = [ctypes.c_char_p]
    lib.seqfile_next.restype = ctypes.c_int
    lib.seqfile_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), c_int_p,
        ctypes.POINTER(ctypes.c_char_p), c_int_p]
    lib.seqfile_close.argtypes = [ctypes.c_void_p]
    lib.seqfile_create.restype = ctypes.c_void_p
    lib.seqfile_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_char_p]
    lib.seqfile_append.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int, ctypes.c_char_p,
                                   ctypes.c_int]
    lib.seqfile_close_writer.argtypes = [ctypes.c_void_p]
    common = [ctypes.POINTER(ctypes.c_void_p),      # images
              c_int_p, c_int_p,                     # heights, widths
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              c_int_p,                              # offsets (y, x)
              ctypes.POINTER(ctypes.c_ubyte)]       # flips
    lib.assemble_batch.argtypes = common + [
        ctypes.POINTER(ctypes.c_float),             # mean
        ctypes.POINTER(ctypes.c_float),             # std
        ctypes.POINTER(ctypes.c_float),             # out
        ctypes.c_int]                               # threads
    lib.assemble_batch_u8.argtypes = common + [
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]


def load_native() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises
    :class:`RuntimeError` when the build fails or a symbol is missing."""
    global _lib, build_info
    with _lock:
        if _lib is not None:
            return _lib
        path, seconds = _build()
        lib = ctypes.CDLL(path)
        missing = [s for s in REQUIRED_SYMBOLS if not hasattr(lib, s)]
        if missing:
            raise RuntimeError(f"native library {path} lacks the symbols "
                               f"{missing}")
        _bind(lib)
        build_info = (path, seconds)
        _lib = lib
        return lib


def loaded() -> bool:
    """The library has been built and loaded in this process."""
    return _lib is not None
