"""Flash-attention forward: the hand-written Hopper kernel, its wrapper and
its plain PyTorch version.

The kernel (``csrc/flash_attention_fwd.cu``) replaces the TPU kernel
``_flash_attention_impl`` of ``jax/experimental/pallas/ops/tpu/
flash_attention.py`` (its forward ``pallas_call``), which the JAX package
reaches from ``MultiHeadAttention.apply`` with ``flash=True``.  The source
notes its bound on the H100 and its design.

:func:`flash_attention` launches the kernel on CUDA tensors and raises on
anything the kernel does not take; it takes the plain version,
:func:`flash_attention_reference`, only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from bigdl_tpu_torch.kernels import build

SOURCE = "flash_attention_fwd.cu"
HEAD_DIM = 128      # the kernel's compiled head dimension
BLOCK = 64          # query and key tile; T must be a multiple of it

#: kernel launches by kernel name.  The wrapper adds one where it launches a
#: kernel and nowhere else, so a run can show that its path went through them.
launches = {"flash_attention_fwd_fp32": 0, "flash_attention_fwd_bf16": 0}

_KERNEL_OF = {torch.float32: ("flash_attention_fwd_fp32", 0),
              torch.bfloat16: ("flash_attention_fwd_bf16", 1)}

_bind_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _library() -> ctypes.CDLL:
    """The kernel's library with its entry points bound, built and loaded
    at the first launch."""
    global _lib
    with _bind_lock:
        if _lib is None:
            lib = build.load(SOURCE)
            fn = lib.bigdl_flash_attention_fwd
            fn.argtypes = ([ctypes.c_void_p] * 4 +
                           [ctypes.POINTER(ctypes.c_longlong)] +
                           [ctypes.c_int] * 5 +
                           [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.bigdl_cuda_error_string.argtypes = [ctypes.c_int]
            lib.bigdl_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool,
                              sm_scale: float) -> torch.Tensor:
    """The plain version: (B, T, H, Dh) q/k/v -> (B, T, H, Dh) in fp32, by
    ``torch.matmul`` and softmax in fp32.  The causal mask is top-left
    aligned like the TPU kernel's (the same as bottom-right for the
    Tq == Tkv inputs the kernel takes)."""
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        keep = torch.ones(tq, tk, dtype=torch.bool,
                          device=scores.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.matmul(p, vf).transpose(1, 2)


def _check(q, k, v) -> None:
    if not (q.dim() == 4 and q.shape == k.shape == v.shape):
        raise ValueError("flash_attention takes q, k, v of one (B, T, H, Dh) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_OF:
        raise TypeError("flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention takes q, k, v on one device, got "
                         f"{q.device}, {k.device}, {v.device}")
    _, t, _, dh = q.shape
    if dh != HEAD_DIM or t % BLOCK != 0:
        raise ValueError(f"the flash kernel is built for head_dim {HEAD_DIM} "
                         f"and T divisible by {BLOCK}, got T {t}, head_dim "
                         f"{dh}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward yet (the TPU kernel's backward "
            "is not ported): call it under torch.no_grad() or "
            "torch.inference_mode()")


def _check_strides(x: torch.Tensor, name: str) -> None:
    # the bf16 kernel moves 16-byte rows: 8-element aligned strides and base
    if x.stride(-1) != 1:
        raise ValueError(f"flash_attention needs {name}'s head dimension "
                         f"contiguous, got strides {x.stride()}")
    if x.dtype == torch.bfloat16 and (
            x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:3])):
        raise ValueError(f"the bf16 flash kernel needs {name} 16-byte aligned "
                         "with (B, T, H) strides that are multiples of 8, got "
                         f"strides {x.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * sm_scale [causal]) v over (B, T, H, Dh) inputs, in
    the inputs' dtype.  On CUDA tensors this launches the hand kernel (or
    raises); on CPU tensors it runs :func:`flash_attention_reference`."""
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, sm_scale).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_strides(x, name)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    name, dtype_code = _KERNEL_OF[q.dtype]
    strides = (ctypes.c_longlong * 12)(
        *(s for x in (q, k, v, o) for s in x.stride()[:3]))
    b, t, h, dh = q.shape
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.bigdl_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
            b, t, h, dh, dtype_code, float(sm_scale), int(bool(causal)),
            stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.bigdl_cuda_error_string(err).decode()})")
    launches[name] += 1
    return o
