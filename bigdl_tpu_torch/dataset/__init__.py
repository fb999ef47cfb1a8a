"""Training data of the port (``bigdl_tpu/dataset``): records, batches, the
transformers between them, and the in-memory and partition-sharded
datasets."""

from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, LocalDataSet,
                                             ShardedDataSet)
from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample
from bigdl_tpu_torch.dataset.transformer import (ChainedTransformer,
                                                 SampleToMiniBatch,
                                                 Transformer)

__all__ = ["AbstractDataSet", "ChainedTransformer", "LocalDataSet",
           "MiniBatch", "Sample", "SampleToMiniBatch", "ShardedDataSet",
           "Transformer"]
