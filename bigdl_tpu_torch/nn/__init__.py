"""Layers of the port (``bigdl_tpu/nn``): the module and criterion shells,
the layers the transformer LM (dense, MoE, tensor-parallel and
rematerialised), the convnet zoo (ResNet, LeNet, AlexNet,
VGG, Inception), the recurrent models (the RNN and LSTM language models,
the TreeLSTM), the autoencoder and the text classifier are built from,
the device-side ingest head (``DeviceAugment``, ``ChannelNormalize``),
their initialisers, the channels-last layout pass, conv + BN folding and
the losses."""

from bigdl_tpu_torch.nn import init
from bigdl_tpu_torch.nn.activation import (Dropout, LogSoftMax, ReLU,
                                           Sigmoid, Tanh, Threshold)
from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                          chunked_attention,
                                          paged_attention,
                                          scaled_dot_product_attention)
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          CrossEntropyCriterion, MSECriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.fuse import fold_conv_bn
from bigdl_tpu_torch.nn.init import (InitializationMethod, RandomNormal,
                                     RandomUniform, Xavier, Zeros)
from bigdl_tpu_torch.nn.layout import (NCHWToNHWC, NHWCToNCHW, apply_layout,
                                       to_channels_last)
from bigdl_tpu_torch.nn.linear import Linear, LookupTable
from bigdl_tpu_torch.nn.module import (Container, Criterion, Module,
                                       Sequential, collect_diagnostics,
                                       is_stochastic, random_stream,
                                       semantic_state_leaves)
from bigdl_tpu_torch.nn.moe import MixtureOfExperts
from bigdl_tpu_torch.nn.normalization import (BatchNormalization,
                                              SpatialBatchNormalization,
                                              SpatialCrossMapLRN)
from bigdl_tpu_torch.nn.pooling import (SpatialAveragePooling,
                                        SpatialMaxPooling)
from bigdl_tpu_torch.nn.recurrent import (GRU, LSTM, BiRecurrent,
                                          BinaryTreeLSTM, Cell,
                                          ConvLSTMPeephole,
                                          ConvLSTMPeephole3D, LSTMPeephole,
                                          Recurrent, RnnCell, TimeDistributed,
                                          TreeLSTM)
from bigdl_tpu_torch.nn.structural import (Bottle, ChannelNormalize,
                                          DeviceAugment, Identity,
                                          MulConstant, Remat, Reshape, Select,
                                          Transpose, View)
from bigdl_tpu_torch.nn.table import CAddTable, Concat, ConcatTable

__all__ = ["BatchNormalization", "BiRecurrent", "BinaryTreeLSTM", "Bottle",
           "CAddTable",
           "Cell", "ChannelNormalize", "ClassNLLCriterion", "Concat",
           "ConcatTable", "Container", "ConvLSTMPeephole",
           "ConvLSTMPeephole3D", "Criterion", "CrossEntropyCriterion",
           "DeviceAugment", "Dropout", "GRU", "Identity",
           "InitializationMethod", "LSTM", "LSTMPeephole", "Linear",
           "LogSoftMax", "LookupTable", "MSECriterion", "MixtureOfExperts",
           "Module",
           "MulConstant", "MultiHeadAttention", "NCHWToNHWC", "NHWCToNCHW",
           "RandomNormal", "RandomUniform", "ReLU", "Recurrent", "Remat",
           "Reshape",
           "RnnCell", "Select", "Sequential", "Sigmoid",
           "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialConvolution", "SpatialCrossMapLRN", "SpatialMaxPooling",
           "Tanh", "Threshold", "TimeDistributed", "TimeDistributedCriterion",
           "Transpose", "TreeLSTM", "View", "Xavier", "Zeros", "apply_layout",
           "chunked_attention", "collect_diagnostics", "fold_conv_bn", "init",
           "is_stochastic", "paged_attention", "random_stream",
           "scaled_dot_product_attention", "semantic_state_leaves",
           "to_channels_last"]
