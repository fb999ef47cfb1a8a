"""Model builders of the port (``bigdl_tpu/models``)."""

from bigdl_tpu_torch.models.alexnet import alexnet, alexnet_owt
from bigdl_tpu_torch.models.autoencoder import autoencoder
from bigdl_tpu_torch.models.inception import (inception_v1,
                                              inception_v1_no_aux_classifier,
                                              inception_v2,
                                              inception_v2_no_aux_classifier)
from bigdl_tpu_torch.models.lenet import lenet5
from bigdl_tpu_torch.models.resnet import (DatasetType, ShortcutType,
                                           model_init, resnet)
from bigdl_tpu_torch.models.rnn import lstm_lm, simple_rnn
from bigdl_tpu_torch.models.textclassifier import text_classifier
from bigdl_tpu_torch.models.transformer import transformer_lm
from bigdl_tpu_torch.models.treelstm import tree_lstm_sentiment
from bigdl_tpu_torch.models.vgg import vgg16, vgg19, vgg_for_cifar10

__all__ = ["DatasetType", "ShortcutType", "alexnet", "alexnet_owt",
           "autoencoder", "inception_v1", "inception_v1_no_aux_classifier",
           "inception_v2", "inception_v2_no_aux_classifier", "lenet5",
           "lstm_lm", "model_init", "resnet", "simple_rnn",
           "text_classifier", "transformer_lm", "tree_lstm_sentiment",
           "vgg16", "vgg19", "vgg_for_cifar10"]
