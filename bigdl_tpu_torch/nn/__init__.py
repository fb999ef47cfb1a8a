"""Layers of the port (``bigdl_tpu/nn``): the module and criterion shells
with the imperative API, the Torch-style layer library (activations,
tables, structural layers, the linear family, criterions, initialisers),
the ``Graph`` container, the layers the transformer LM (dense, MoE,
tensor-parallel and rematerialised), the convnet zoo (ResNet, LeNet,
AlexNet, VGG, Inception), the recurrent models (the RNN and LSTM language
models, the TreeLSTM), the autoencoder and the text classifier are built
from, the device-side ingest head (``DeviceAugment``,
``ChannelNormalize``), the channels-last layout pass and conv + BN
folding."""

from bigdl_tpu_torch.nn import init
from bigdl_tpu_torch.nn.activation import (
    ELU, Abs, Clamp, Dropout, Exp, GaussianDropout, GaussianNoise,
    HardShrink, HardTanh, L1Penalty, LeakyReLU, Log, LogSigmoid, LogSoftMax,
    Negative, Power, PReLU, ReLU, ReLU6, RReLU, Sigmoid, SoftMax, SoftMin,
    SoftPlus, SoftShrink, SoftSign, Sqrt, Square, Tanh, TanhShrink,
    Threshold)
from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                          chunked_attention,
                                          paged_attention,
                                          scaled_dot_product_attention)
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.criterion import (
    AbsCriterion, BCECriterion, ClassNLLCriterion, ClassSimplexCriterion,
    CosineDistanceCriterion, CosineEmbeddingCriterion, CrossEntropyCriterion,
    DiceCoefficientCriterion, DistKLDivCriterion, HingeEmbeddingCriterion,
    L1Cost, L1HingeEmbeddingCriterion, MarginCriterion,
    MarginRankingCriterion, MSECriterion, MultiCriterion,
    MultiLabelMarginCriterion, MultiLabelSoftMarginCriterion,
    MultiMarginCriterion, ParallelCriterion, SmoothL1Criterion,
    SmoothL1CriterionWithWeights, SoftMarginCriterion, SoftmaxWithCriterion,
    TimeDistributedCriterion)
from bigdl_tpu_torch.nn.fuse import fold_conv_bn
from bigdl_tpu_torch.nn.graph import Graph, Input, ModuleNode
from bigdl_tpu_torch.nn.init import (BilinearFiller, ConstInitMethod,
                                     InitializationMethod, MsraFiller, Ones,
                                     RandomNormal, RandomUniform, Xavier,
                                     Zeros)
from bigdl_tpu_torch.nn.layout import (NCHWToNHWC, NHWCToNCHW, apply_layout,
                                       to_channels_last)
from bigdl_tpu_torch.nn.linear import (Add, Bilinear, CAdd, CMul, Cosine,
                                       Euclidean, Linear, LookupTable, Mul)
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
from bigdl_tpu_torch.nn.structural import (
    MM, MV, AddConstant, Bottle, ChannelNormalize, Contiguous,
    DeviceAugment, DotProduct, Echo, GradientReversal, Identity, Index,
    InferReshape, MaskedSelect, Max, Mean, Min, MulConstant, Narrow, Pack,
    Padding, Remat, Replicate, Reshape, Reverse, Scale, Select,
    SpatialZeroPadding, Squeeze, Sum, Transpose, Unsqueeze, View)
from bigdl_tpu_torch.nn.table import (
    CAddTable, CDivTable, CMaxTable, CMinTable, CMulTable, Concat,
    ConcatTable, CosineDistance, CSubTable, FlattenTable, JoinTable,
    MapTable, MixtureTable, NarrowTable, PairwiseDistance, ParallelTable,
    SelectTable, SplitTable)

__all__ = [name for name in dir() if not name.startswith("_")]
