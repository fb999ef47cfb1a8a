"""Build the package's CUDA sources into shared libraries and load them.

Each source under ``bigdl_tpu_torch/csrc`` has a plain C interface and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into ``build/bigdl_tpu_torch/``
at the root of the checkout (listed in ``.gitignore``), then loaded with
``ctypes``.  Nothing here runs at import: a kernel's wrapper builds its library
at its first launch on a CUDA tensor, and ``chip_smoke.py`` builds every source
up front, all at once.  A library is named after a hash of its source, of
every header (``*.cuh``) under ``csrc`` and of the flags, so an unchanged
source is built once per checkout and an edit to a shared header rebuilds
every source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, NamedTuple
from bigdl_tpu_torch.analysis.lockwitness import make_lock

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "bigdl_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = make_lock("kernels.build")
_loaded: Dict[str, ctypes.CDLL] = {}


class Built(NamedTuple):
    """One compiled source: its library, the compile's wall seconds (0.0
    when the library was already built) and the compiler's report
    (``-Xptxas -v``: registers, shared memory and spills per kernel)."""
    path: str
    seconds: float
    log: str


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the "
                           "CUDA kernels can only be built where the CUDA "
                           "toolkit is installed")
    return path


def _headers() -> List[str]:
    """Every header under ``csrc``: a source may include any of them."""
    return sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))


def _target(source: str) -> str:
    digest = hashlib.sha256()
    for name in (source, *_headers()):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def build(sources: List[str]) -> Dict[str, Built]:
    """Compile every source not built yet, one ``nvcc`` each, all started
    together; raise with the compiler's output if any fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out: Dict[str, Built] = {}
    running = {}
    for src in sources:
        target = _target(src)
        if os.path.exists(target):
            out[src] = Built(target, 0.0, "")
            continue
        tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
               os.path.join(CSRC_DIR, src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[src] = (proc, target, tmp, time.perf_counter())
    failed = []
    for src, (proc, target, tmp, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src} (exit {proc.returncode}):"
                          f"\n{log}")
            continue
        os.replace(tmp, target)   # atomic: a concurrent builder sees all or none
        out[src] = Built(target, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(build([source])[source].path)
            _loaded[source] = lib
        return lib
