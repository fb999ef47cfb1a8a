"""Training data of the port (``bigdl_tpu/dataset``): records, batches, the
transformers between them, the in-memory and partition-sharded datasets and
their factory, and the real-data path (SequenceFiles of JPEGs, the
multi-threaded assembler, the stage-pipelined ``StreamingIngest``).  The
native library that reads SequenceFiles and assembles batches is built at
its first use, never at import."""

from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, DataSet,
                                             LocalDataSet, ShardedDataSet)
from bigdl_tpu_torch.dataset.ingest import (ShardedSeqFileReader,
                                            StreamingIngest)
from bigdl_tpu_torch.dataset.sample import MiniBatch, PaddingParam, Sample
from bigdl_tpu_torch.dataset.transformer import (ChainedTransformer,
                                                 FuncTransformer, Identity,
                                                 SampleToBatch,
                                                 SampleToMiniBatch,
                                                 Transformer)

__all__ = ["AbstractDataSet", "ChainedTransformer", "DataSet",
           "FuncTransformer", "Identity", "LocalDataSet", "MiniBatch",
           "PaddingParam", "Sample", "SampleToBatch", "SampleToMiniBatch",
           "ShardedDataSet", "ShardedSeqFileReader", "StreamingIngest",
           "Transformer"]
