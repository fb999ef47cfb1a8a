"""2-D pooling on torch's pooling ops (``bigdl_tpu/ops/pooling.py``:
``pool_out_size`` :31, ``_hi_pad`` :42, ``max_pool2d`` :47, ``avg_pool2d``
:66).

The JAX package pools with ``lax.reduce_window`` over explicit pads: ``pad``
on the low side and, on the high side, what the last window needs
(:func:`hi_pad`), so ceil mode is extra high padding.  Its average with
``count_include_pad`` divides every window by kh*kw, the ceil-mode overhang
included; torch's ``avg_pool2d(ceil_mode=True)`` divides an overhanging
window by less.  So these functions use torch's own padding only where its
windows are the reference's (the same count, starting at ``-pad``, never
past ``in + pad``), and otherwise pad explicitly (-inf for max, 0 for the
average) and pool without padding.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def pool_out_size(in_size: int, k: int, stride: int, pad: int,
                  ceil_mode: bool) -> int:
    rnd = math.ceil if ceil_mode else math.floor
    out = int(rnd((in_size + 2 * pad - k) / stride)) + 1
    if pad > 0 and (out - 1) * stride >= in_size + pad:
        out -= 1  # torch rule: last window must start inside the padded input
    return out


def hi_pad(in_size: int, k: int, stride: int, pad: int,
           ceil_mode: bool) -> int:
    out = pool_out_size(in_size, k, stride, pad, ceil_mode)
    return max(0, (out - 1) * stride + k - in_size - pad)


def _native(x: torch.Tensor, kernel, stride, padding, ceil_mode) -> bool:
    """Torch's symmetric padding (floor mode) gives the reference's windows:
    the same count, and none reaching past ``in + pad``."""
    for in_size, k, s, p in zip(x.shape[-2:], kernel, stride, padding):
        if p > k // 2 or (in_size + 2 * p - k) // s + 1 != \
                pool_out_size(in_size, k, s, p, ceil_mode):
            return False
    return True


def _pads(x: torch.Tensor, kernel, stride, padding, ceil_mode):
    """F.pad's (left, right, top, bottom) of the reference's windows."""
    (h, w), (kh, kw), (sh, sw), (ph, pw) = x.shape[-2:], kernel, stride, \
        padding
    return (pw, hi_pad(w, kw, sw, pw, ceil_mode),
            ph, hi_pad(h, kh, sh, ph, ceil_mode))


def max_pool2d(x: torch.Tensor, kernel: Tuple[int, int],
               stride: Tuple[int, int], padding: Tuple[int, int] = (0, 0),
               ceil_mode: bool = False) -> torch.Tensor:
    if _native(x, kernel, stride, padding, ceil_mode):
        return F.max_pool2d(x, kernel, stride, padding)
    x = F.pad(x, _pads(x, kernel, stride, padding, ceil_mode),
              value=-math.inf)
    return F.max_pool2d(x, kernel, stride)


def avg_pool2d(x: torch.Tensor, kernel: Tuple[int, int],
               stride: Tuple[int, int], padding: Tuple[int, int] = (0, 0),
               ceil_mode: bool = False,
               count_include_pad: bool = True) -> torch.Tensor:
    if _native(x, kernel, stride, padding, ceil_mode):
        return F.avg_pool2d(x, kernel, stride, padding,
                            count_include_pad=count_include_pad)
    pads = _pads(x, kernel, stride, padding, ceil_mode)
    mean = F.avg_pool2d(F.pad(x, pads), kernel, stride)   # sum / (kh*kw)
    if count_include_pad:
        return mean
    ones = F.pad(torch.ones_like(x[..., :1, :, :]), pads)
    return mean / F.avg_pool2d(ones, kernel, stride)
