"""Model builders of the port (``bigdl_tpu/models``)."""

from bigdl_tpu_torch.models.lenet import lenet5
from bigdl_tpu_torch.models.resnet import (DatasetType, ShortcutType,
                                           model_init, resnet)
from bigdl_tpu_torch.models.transformer import transformer_lm

__all__ = ["DatasetType", "ShortcutType", "lenet5", "model_init", "resnet",
           "transformer_lm"]
