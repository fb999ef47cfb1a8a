"""Convolution layers (``bigdl_tpu/nn/conv.py`` ``SpatialConvolution``
:30-120; reference ``nn/SpatialConvolution.scala:42``).

BigDL's argument order is (kernelW, kernelH, strideW, strideH, padW, padH);
``pad = -1`` means SAME padding.  The weight is torch's (out, in/groups, kh,
kw); the JAX package stores HWIO (kh, kw, in/groups, out), and
:func:`bigdl_tpu_torch.utils.convert.params_from_jax` transposes between
the two.  ``format`` records the memory format the layer computes in
(:mod:`bigdl_tpu_torch.nn.layout`): ``"NHWC"`` keeps the weight in
``torch.channels_last``, as cuDNN wants beside channels-last activations.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bigdl_tpu_torch.nn.init import RandomUniform, redraw as _redraw
from bigdl_tpu_torch.nn.module import Module, make_generator
from bigdl_tpu_torch.ops import convolution as _conv


class SpatialConvolution(Module):
    """2-D convolution (reference ``nn/SpatialConvolution.scala:42``),
    weight and bias drawn U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with fan_in =
    in/groups * kh * kw, unless ``init_weight``/``init_bias`` are given (the
    weight as (out, in/groups, kh, kw), or as the reference's
    (groups, out/groups, in/groups, kh, kw)).  A 3-D input is one unbatched
    image."""

    layout_role = "spatial"

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, propagate_back: bool = True,
                 w_regularizer=None, b_regularizer=None,
                 init_weight=None, init_bias=None,
                 with_bias: bool = True, format: str = "NCHW",
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"{n_input_plane} input and {n_output_plane} "
                             f"output planes must be multiples of {n_group} "
                             "groups")
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.n_group = n_group
        self.propagate_back = propagate_back
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        self.with_bias = with_bias
        g = make_generator(generator)
        shape = (n_output_plane, n_input_plane // n_group, kernel_h, kernel_w)
        fan_in, _ = self._fans
        draw = RandomUniform()
        self._given = (init_weight is not None, init_bias is not None)
        if init_weight is not None:
            w = torch.as_tensor(init_weight,
                                dtype=torch.float32).reshape(shape)
        else:
            w = draw(shape, fan_in, generator=g)
        self.weight = nn.Parameter(w.to(device))
        if with_bias:
            b = (torch.as_tensor(init_bias, dtype=torch.float32)
                 if init_bias is not None
                 else draw((n_output_plane,), fan_in, generator=g))
            self.bias = nn.Parameter(b.to(device))
        else:
            self.register_parameter("bias", None)
        self.format = "NCHW"
        self.set_format(format)

    @property
    def _fans(self):
        """(fan_in, fan_out) of the JAX package's layer (``conv.py:71``)."""
        taps = self.kernel_h * self.kernel_w
        return (self.n_input_plane // self.n_group * taps,
                self.n_output_plane // self.n_group * taps)

    @torch.no_grad()
    def set_init_method(self, weight_init=None, bias_init=None,
                        generator: Optional[torch.Generator] = None
                        ) -> "SpatialConvolution":
        """Redraw the weight with ``weight_init`` and the bias with
        ``bias_init`` (each ``(shape, fan_in, fan_out, generator)``, e.g.
        :class:`~bigdl_tpu_torch.nn.init.Xavier`) from ``generator``, the
        weight first; a tensor given at construction is kept.  The JAX
        package draws lazily, at its first forward; here parameters exist
        from construction, so they are drawn again."""
        _redraw(self, weight_init, bias_init, generator, self._fans,
                self._given)
        return self

    def set_format(self, format: str) -> "SpatialConvolution":
        super().set_format(format)
        fmt = (torch.channels_last if format == "NHWC"
               else torch.contiguous_format)
        with torch.no_grad():
            self.weight.data = self.weight.data.contiguous(memory_format=fmt)
        return self

    def _padding(self):
        if self.pad_w == -1 or self.pad_h == -1:
            return "SAME"
        return (self.pad_h, self.pad_w)

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        squeeze = input.dim() == 3
        x = input[None] if squeeze else input
        out = _conv.conv2d(x, self.weight, self.bias,
                           (self.stride_h, self.stride_w), self._padding(),
                           self.n_group)
        return out[0] if squeeze else out
