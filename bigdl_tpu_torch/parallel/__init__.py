"""The distributed training half of the port (``bigdl_tpu/parallel``):
data-parallel SGD over ``torch.distributed`` (reference ``parameters/`` and
``optim/DistriOptimizer.scala``), with tensor parallelism (the Megatron
split over a mesh's ``model`` axis) and expert parallelism (MoE's
``all_to_all`` dispatch over its ``expert`` axis) through
:meth:`DistriOptimizer.set_mesh`.  Pipeline and sequence parallelism
(``PipelineOptimizer``, ring attention) are not ported yet."""

from bigdl_tpu_torch.parallel.all_reduce import AllReduceParameter
from bigdl_tpu_torch.parallel.distri_optimizer import DistriOptimizer
from bigdl_tpu_torch.parallel.expert_parallel import (ep_shard_params,
                                                      expert_parallel_apply)
from bigdl_tpu_torch.parallel.tensor_parallel import (column_parallel,
                                                      head_count_divisible,
                                                      row_parallel,
                                                      tp_shard_params,
                                                      tp_specs)


class PipelineOptimizer:
    """GPipe over a ``stage`` mesh axis (the JAX package's
    ``parallel/pipeline.py``) is not ported: building one raises
    :class:`NotImplementedError`."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("PipelineOptimizer (GPipe) is not ported "
                                  "yet")


__all__ = ["AllReduceParameter", "DistriOptimizer", "PipelineOptimizer",
           "column_parallel", "ep_shard_params", "expert_parallel_apply",
           "head_count_divisible", "row_parallel", "tp_shard_params",
           "tp_specs"]
