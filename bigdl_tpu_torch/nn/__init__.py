"""Layers of the port (``bigdl_tpu/nn``): the module and criterion shells,
the layers the transformer LM is built from and its loss."""

from bigdl_tpu_torch.nn.activation import LogSoftMax, ReLU
from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                          paged_attention,
                                          scaled_dot_product_attention)
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.linear import Linear, LookupTable
from bigdl_tpu_torch.nn.module import Container, Criterion, Module, Sequential

__all__ = ["ClassNLLCriterion", "Container", "Criterion", "Linear",
           "LogSoftMax", "LookupTable", "Module", "MultiHeadAttention",
           "ReLU", "Sequential", "TimeDistributedCriterion",
           "paged_attention", "scaled_dot_product_attention"]
