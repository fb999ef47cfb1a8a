"""Layers of the port (``bigdl_tpu/nn``): the module and criterion shells,
the layers the transformer LM and the convnet zoo (ResNet, LeNet, AlexNet,
VGG, Inception) are built from, the device-side ingest head
(``DeviceAugment``, ``ChannelNormalize``), their initialisers, the channels-last
layout pass, conv + BN folding and the losses."""

from bigdl_tpu_torch.nn import init
from bigdl_tpu_torch.nn.activation import (Dropout, LogSoftMax, ReLU, Tanh,
                                           Threshold)
from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                          paged_attention,
                                          scaled_dot_product_attention)
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.fuse import fold_conv_bn
from bigdl_tpu_torch.nn.init import (InitializationMethod, RandomNormal,
                                     RandomUniform, Xavier, Zeros)
from bigdl_tpu_torch.nn.layout import (NCHWToNHWC, NHWCToNCHW, apply_layout,
                                       to_channels_last)
from bigdl_tpu_torch.nn.linear import Linear, LookupTable
from bigdl_tpu_torch.nn.module import (Container, Criterion, Module,
                                       Sequential, is_stochastic,
                                       random_stream)
from bigdl_tpu_torch.nn.normalization import (BatchNormalization,
                                              SpatialBatchNormalization,
                                              SpatialCrossMapLRN)
from bigdl_tpu_torch.nn.pooling import (SpatialAveragePooling,
                                        SpatialMaxPooling)
from bigdl_tpu_torch.nn.structural import (ChannelNormalize, DeviceAugment,
                                          Identity, MulConstant, Reshape,
                                          View)
from bigdl_tpu_torch.nn.table import CAddTable, Concat, ConcatTable

__all__ = ["BatchNormalization", "CAddTable", "ChannelNormalize",
           "ClassNLLCriterion", "Concat", "ConcatTable", "Container",
           "Criterion", "DeviceAugment", "Dropout", "Identity",
           "InitializationMethod", "Linear", "LogSoftMax", "LookupTable",
           "Module", "MulConstant", "MultiHeadAttention", "NCHWToNHWC",
           "NHWCToNCHW", "RandomNormal", "RandomUniform", "ReLU", "Reshape",
           "Sequential", "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialConvolution", "SpatialCrossMapLRN", "SpatialMaxPooling",
           "Tanh", "Threshold", "TimeDistributedCriterion", "View", "Xavier",
           "Zeros", "apply_layout", "fold_conv_bn", "init", "is_stochastic",
           "paged_attention", "random_stream", "scaled_dot_product_attention",
           "to_channels_last"]
