"""Flash attention: the hand-written Hopper kernels, their wrappers, their
plain PyTorch versions and the autograd Function that joins them.

The kernels replace the three TPU kernels of ``jax/experimental/pallas/ops/
tpu/flash_attention.py``, which the JAX package reaches from
``MultiHeadAttention.apply`` with ``flash=True``:

* ``csrc/flash_attention_fwd.cu`` replaces ``_flash_attention_impl`` (the
  forward ``pallas_call``); it also writes each row's log-sum-exp when a
  gradient is needed;
* ``csrc/flash_attention_bwd.cu`` replaces ``_flash_attention_bwd_dkv`` and
  ``_flash_attention_bwd_dq`` (the backward ``pallas_call``\\ s).

The sources note their bounds on the H100 and their design.

:func:`flash_attention` is the entry point.  Under autograd it runs
:class:`FlashAttentionFunction`, whose forward saves ``q, k, v, o, lse`` and
whose backward launches both backward kernels; otherwise it runs the forward
alone and writes no ``lse``.  Every wrapper launches its kernel on CUDA
tensors and raises on anything the kernel does not take; it takes the plain
version (:func:`flash_attention_reference`,
:func:`flash_attention_bwd_reference`) only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from bigdl_tpu_torch.kernels import build

FWD_SOURCE = "flash_attention_fwd.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
SOURCES = (FWD_SOURCE, BWD_SOURCE)
HEAD_DIM = 128      # the kernels' compiled head dimension
BLOCK = 64          # query and key tile; T must be a multiple of it

#: kernel launches by kernel name.  A wrapper adds one where it launches a
#: kernel and nowhere else, so a run can show that its path went through them.
launches = {f"flash_attention_{kind}_{dt}": 0
            for kind in ("fwd", "bwd_dkv", "bwd_dq")
            for dt in ("fp32", "bf16")}

_DTYPES = {torch.float32: ("fp32", 0), torch.bfloat16: ("bf16", 1)}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_SHAPE = [_I] * 5 + [_F, _I, _P]   # B, T, H, Dh, dtype, sm_scale, causal, stream
#: the C entry points of each source and their argument types
_ENTRY_POINTS = {
    FWD_SOURCE: {"bigdl_flash_attention_fwd": [_P] * 5 + [_STRIDES] + _SHAPE},
    BWD_SOURCE: {"bigdl_flash_attention_bwd_dkv": [_P] * 8 + [_STRIDES] + _SHAPE,
                 "bigdl_flash_attention_bwd_dq": [_P] * 7 + [_STRIDES] + _SHAPE},
}

_bind_lock = threading.Lock()
_libs = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _library(source: str) -> ctypes.CDLL:
    """One source's library with its entry points bound, built and loaded
    at its first launch."""
    with _bind_lock:
        lib = _libs.get(source)
        if lib is None:
            lib = build.load(source)
            for fn_name, argtypes in _ENTRY_POINTS[source].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.bigdl_cuda_error_string.argtypes = [ctypes.c_int]
            lib.bigdl_cuda_error_string.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


def _causal_keep(tq: int, tk: int, device) -> torch.Tensor:
    # top-left aligned, like the TPU kernel's mask (the same as bottom-right
    # for the Tq == Tkv inputs the kernels take)
    return torch.ones(tq, tk, dtype=torch.bool, device=device).tril()


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool,
                              sm_scale: float, return_lse: bool = False):
    """The plain forward: (B, T, H, Dh) q/k/v -> (B, T, H, Dh) in fp32, by
    ``torch.matmul`` and softmax in fp32.  With ``return_lse`` also each
    row's log-sum-exp of the scaled scores, (B, H, T) fp32, natural log."""
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    if causal:
        keep = _causal_keep(scores.shape[-2], scores.shape[-1], scores.device)
        scores = scores.masked_fill(~keep, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.matmul(p, vf).transpose(1, 2)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1)
    return out


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor,
                                  causal: bool, sm_scale: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """The plain backward, step by step as the TPU module's
    ``mha_reference_bwd`` writes it (not autograd of the plain forward):
    P from the forward's ``lse``, dV = P^T dO, dP = dO V^T,
    di = rowsum(O * dO), dS = P * (dP - di), dQ = s dS K, dK = s dS^T Q.
    (B, T, H, Dh) inputs, ``lse`` (B, H, T); (dq, dk, dv) in fp32."""
    qf, kf, vf, of, dof = (x.float().transpose(1, 2)
                           for x in (q, k, v, o, do))
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    if causal:
        keep = _causal_keep(scores.shape[-2], scores.shape[-1], scores.device)
        scores = scores.masked_fill(~keep, float("-inf"))
    p = torch.exp(scores - lse.float()[..., None])
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    di = (of * dof).sum(dim=-1, keepdim=True)
    ds = p * (dp - di)
    dq = torch.matmul(ds, kf) * sm_scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * sm_scale
    return tuple(x.transpose(1, 2) for x in (dq, dk, dv))


def _check(q, k, v) -> None:
    if not (q.dim() == 4 and q.shape == k.shape == v.shape):
        raise ValueError("flash_attention takes q, k, v of one (B, T, H, Dh) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError("flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention takes q, k, v on one device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _, t, _, dh = q.shape
    if dh != HEAD_DIM or t % BLOCK != 0:
        raise ValueError(f"the flash kernels are built for head_dim "
                         f"{HEAD_DIM} and T divisible by {BLOCK}, got T {t}, "
                         f"head_dim {dh}")


def _kernel_takes(x: torch.Tensor) -> bool:
    # the head dimension contiguous; the bf16 kernels move 16-byte rows:
    # 8-element aligned strides and base
    return x.stride(-1) == 1 and not (x.dtype == torch.bfloat16 and (
        x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:3])))


def _check_strides(x: torch.Tensor, name: str) -> None:
    if not _kernel_takes(x):
        raise ValueError(f"the flash kernels need {name}'s head dimension "
                         "contiguous and, in bf16, a 16-byte aligned base with "
                         "(B, T, H) strides that are multiples of 8; got "
                         f"strides {x.stride()}")


def _check_cuda(q: torch.Tensor, what: str) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel and takes CUDA "
                         f"tensors, not {q.device} ones")


def _launch(source: str, fn_name: str, kernel: str, tensors, pointers,
            shape_args) -> None:
    """Call one C entry point on the current stream, raise on a refused
    launch, count it.  ``tensors`` give the (B, T, H) strides in order."""
    strides = (ctypes.c_longlong * (3 * len(tensors)))(
        *(s for x in tensors for s in x.stride()[:3]))
    lib = _library(source)
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*pointers, strides, *shape_args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} "
                           f"({lib.bigdl_cuda_error_string(err).decode()})")
    launches[kernel] += 1


def _shape_args(q: torch.Tensor, causal: bool, sm_scale: float):
    b, t, h, dh = q.shape
    return (b, t, h, dh, _DTYPES[q.dtype][1], float(sm_scale),
            int(bool(causal)))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, sm_scale: float, with_lse: bool
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward kernel on CUDA q/k/v: (o, lse), ``lse`` (B, H, T)
    fp32 only ``with_lse`` (else None, and the kernel writes none)."""
    _check_cuda(q, "flash_attention_fwd")
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_strides(x, name)
    b, t, h, _ = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty(b, h, t, dtype=torch.float32, device=q.device)
           if with_lse else None)
    _launch(FWD_SOURCE, "bigdl_flash_attention_fwd",
            f"flash_attention_fwd_{_DTYPES[q.dtype][0]}", (q, k, v, o),
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr() if with_lse else None),
            _shape_args(q, causal, sm_scale))
    return o, lse


def _check_bwd(q, do, lse, di) -> None:
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"flash_attention's backward takes do like q, got "
                         f"{tuple(do.shape)} {do.dtype} on {do.device}")
    b, t, h, _ = q.shape
    for x, name in ((lse, "lse"), (di, "di")):
        if x.shape != (b, h, t) or x.dtype != torch.float32 or \
                not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"flash_attention's backward takes {name} as a "
                             f"contiguous (B, H, T) fp32 tensor on "
                             f"{q.device}, got {tuple(x.shape)} {x.dtype}")


def flash_attention_bwd_dkv(q, k, v, do, lse, di, causal: bool,
                            sm_scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel on CUDA tensors: (dk, dv) in q's dtype."""
    _check_cuda(q, "flash_attention_bwd_dkv")
    _check_bwd(q, do, lse, di)
    for x, name in ((q, "q"), (k, "k"), (v, "v"), (do, "do")):
        _check_strides(x, name)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(BWD_SOURCE, "bigdl_flash_attention_bwd_dkv",
            f"flash_attention_bwd_dkv_{_DTYPES[q.dtype][0]}",
            (q, k, v, do, dk, dv),
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            _shape_args(q, causal, sm_scale))
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, di, causal: bool,
                           sm_scale: float) -> torch.Tensor:
    """Launch the dQ kernel on CUDA tensors: dq in q's dtype."""
    _check_cuda(q, "flash_attention_bwd_dq")
    _check_bwd(q, do, lse, di)
    for x, name in ((q, "q"), (k, "k"), (v, "v"), (do, "do")):
        _check_strides(x, name)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(BWD_SOURCE, "bigdl_flash_attention_bwd_dq",
            f"flash_attention_bwd_dq_{_DTYPES[q.dtype][0]}", (q, k, v, do, dq),
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), di.data_ptr(), dq.data_ptr()),
            _shape_args(q, causal, sm_scale))
    return dq


def attention_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(o * do) in fp32, (B, H, T) contiguous: the backward
    kernels' input that the TPU module also computes outside its kernels."""
    return (o.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool, sm_scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in q's dtype.  On CUDA tensors: di, then the dK/dV and
    dQ kernels (a ``do`` whose layout the kernels do not take is made
    contiguous first).  On CPU tensors: the plain backward."""
    if q.device.type == "cpu":
        return tuple(g.to(q.dtype) for g in flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal, sm_scale))
    if not _kernel_takes(do):
        do = do.contiguous()
    di = attention_di(o, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, causal, sm_scale)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, di, causal, sm_scale)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention under autograd: the forward writes ``lse`` and saves
    ``q, k, v, o, lse``; the backward launches the dK/dV and dQ kernels.
    On CPU tensors both directions run their plain versions.  The backward
    is not itself differentiable (the TPU kernels have no second
    derivative either)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        if q.device.type == "cpu":
            o, lse = flash_attention_reference(q, k, v, causal, sm_scale,
                                               return_lse=True)
            o = o.to(q.dtype)
        else:
            o, lse = flash_attention_fwd(q, k, v, causal, sm_scale,
                                         with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                         ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * sm_scale [causal]) v over (B, T, H, Dh) inputs, in
    the inputs' dtype.  When a gradient is needed this runs
    :class:`FlashAttentionFunction`; otherwise the forward alone.  On CUDA
    tensors the hand kernels run (or the call raises); on CPU tensors their
    plain versions."""
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, sm_scale).to(q.dtype)
    return flash_attention_fwd(q, k, v, causal, sm_scale, with_lse=False)[0]
