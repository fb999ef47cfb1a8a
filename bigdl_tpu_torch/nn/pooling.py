"""Pooling layers (``bigdl_tpu/nn/pooling.py``: ``SpatialMaxPooling`` :16,
``SpatialAveragePooling`` :55; reference ``nn/SpatialMaxPooling.scala``,
``nn/SpatialAveragePooling.scala``).  The window arithmetic is
:mod:`bigdl_tpu_torch.ops.pooling`'s; a 3-D input is one unbatched image."""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops import pooling
from bigdl_tpu_torch.analysis.contracts import ModuleContract


class SpatialMaxPooling(Module):
    """2-D max pooling; ``ceil()``/``floor()`` pick the output rounding."""

    #: image maps in, float compute (analysis/contracts.py)
    contract = ModuleContract(input_ndim=(3, 4), dtypes="float")

    layout_role = "spatial"

    def __init__(self, kw: int, kh: int, dw: Optional[int] = None,
                 dh: Optional[int] = None, pad_w: int = 0, pad_h: int = 0,
                 format: str = "NCHW"):
        super().__init__()
        self.kw, self.kh = kw, kh
        self.dw = dw if dw is not None else kw
        self.dh = dh if dh is not None else kh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.ceil_mode = False
        self.format = format

    def ceil(self) -> "SpatialMaxPooling":
        self.ceil_mode = True
        return self

    def floor(self) -> "SpatialMaxPooling":
        self.ceil_mode = False
        return self

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return pooling.max_pool2d(input, (self.kh, self.kw),
                                  (self.dh, self.dw),
                                  (self.pad_h, self.pad_w), self.ceil_mode)


class SpatialAveragePooling(Module):
    """2-D average pooling.  ``count_include_pad`` divides every window by
    kh*kw (the reference's rule, ceil-mode overhang included), otherwise by
    its count of input pixels; ``divide=False`` returns the sums;
    ``global_pooling`` pools each whole map."""

    #: image maps in, float compute (analysis/contracts.py)
    contract = ModuleContract(input_ndim=(3, 4), dtypes="float")

    layout_role = "spatial"

    def __init__(self, kw: int, kh: int, dw: int = 1, dh: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 global_pooling: bool = False,
                 ceil_mode: bool = False, count_include_pad: bool = True,
                 divide: bool = True, format: str = "NCHW"):
        super().__init__()
        self.kw, self.kh = kw, kh
        self.dw, self.dh = dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.global_pooling = global_pooling
        self.ceil_mode = ceil_mode
        self.count_include_pad = count_include_pad
        self.divide = divide
        self.format = format

    def ceil(self) -> "SpatialAveragePooling":
        self.ceil_mode = True
        return self

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        kh, kw = (tuple(input.shape[-2:]) if self.global_pooling
                  else (self.kh, self.kw))
        out = pooling.avg_pool2d(input, (kh, kw), (self.dh, self.dw),
                                 (self.pad_h, self.pad_w), self.ceil_mode,
                                 self.count_include_pad)
        return out if self.divide else out * (kh * kw)
