"""Training data of the port (``bigdl_tpu/dataset``): records, batches, the
transformers between them and the in-memory dataset."""

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet, LocalDataSet
from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample
from bigdl_tpu_torch.dataset.transformer import (ChainedTransformer,
                                                 SampleToMiniBatch,
                                                 Transformer)

__all__ = ["AbstractDataSet", "ChainedTransformer", "LocalDataSet",
           "MiniBatch", "Sample", "SampleToMiniBatch", "Transformer"]
