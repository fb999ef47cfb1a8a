"""2-D convolution on ``torch.nn.functional.conv2d`` (``bigdl_tpu/ops/
convolution.py`` ``conv2d`` :116, ``_same_pad`` :40).

The JAX package lowers through ``lax.conv_general_dilated`` (or, for a few
taps, an im2col matmul); here cuDNN takes both roles.  Kernels are torch's
(out, in/groups, kh, kw); activations are NCHW-shaped in either memory
format, and cuDNN computes in the format the input arrives in.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F


def same_pad(in_size: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """(low, high) padding for SAME output ceil(in / s); the odd pixel goes
    on the high side, as XLA's and TensorFlow's SAME put it."""
    eff_k = (k - 1) * d + 1
    out = -(-in_size // s)
    pad = max(0, (out - 1) * s + eff_k - in_size)
    return pad // 2, pad - pad // 2


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None,
           stride: Tuple[int, int] = (1, 1),
           padding: Union[str, Tuple[int, int]] = (0, 0),
           groups: int = 1) -> torch.Tensor:
    """Cross-correlation of a (N, C, H, W) batch.  ``padding`` is (padH,
    padW) or ``"SAME"``, which may be asymmetric: torch's own
    ``padding="same"`` refuses stride > 1, so an uneven SAME pad is applied
    with ``F.pad`` first."""
    if padding == "SAME":
        (top, bottom), (left, right) = (
            same_pad(x.shape[2], weight.shape[2], stride[0]),
            same_pad(x.shape[3], weight.shape[3], stride[1]))
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            padding = (0, 0)
    return F.conv2d(x, weight, bias, stride, padding, 1, groups)
