"""Layers of the port (``bigdl_tpu/nn``): the module shell and the layers the
transformer LM is built from."""

from bigdl_tpu_torch.nn.activation import LogSoftMax, ReLU
from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                          scaled_dot_product_attention)
from bigdl_tpu_torch.nn.linear import Linear, LookupTable
from bigdl_tpu_torch.nn.module import Container, Module, Sequential

__all__ = ["Container", "Linear", "LogSoftMax", "LookupTable", "Module",
           "MultiHeadAttention", "ReLU", "Sequential",
           "scaled_dot_product_attention"]
