"""The distributed training half of the port (``bigdl_tpu/parallel``):
data-parallel SGD over ``torch.distributed`` (reference ``parameters/`` and
``optim/DistriOptimizer.scala``).  Pipeline, tensor, sequence and expert
parallelism are not ported yet."""

from bigdl_tpu_torch.parallel.all_reduce import AllReduceParameter
from bigdl_tpu_torch.parallel.distri_optimizer import DistriOptimizer

__all__ = ["AllReduceParameter", "DistriOptimizer"]
