"""The distributed training half of the port (``bigdl_tpu/parallel``):
data-parallel SGD over ``torch.distributed`` (reference ``parameters/`` and
``optim/DistriOptimizer.scala``), with tensor parallelism (the Megatron
split over a mesh's ``model`` axis), expert parallelism (MoE's
``all_to_all`` dispatch over its ``expert`` axis) and sequence parallelism
(ring attention over its ``seq`` axis) through
:meth:`DistriOptimizer.set_mesh`, and GPipe over a ``stage`` axis
(:class:`PipelineOptimizer`)."""

from bigdl_tpu_torch.parallel.all_reduce import (AllReduceParameter,
                                                 ring_permute)
from bigdl_tpu_torch.parallel.distri_optimizer import DistriOptimizer
from bigdl_tpu_torch.parallel.expert_parallel import (ep_shard_params,
                                                      expert_parallel_apply)
from bigdl_tpu_torch.parallel.pipeline import (PipelineOptimizer,
                                               pipeline_apply,
                                               pipeline_shard_params,
                                               stack_stage_params,
                                               stage_tp_specs,
                                               unstack_stage_params,
                                               wire_model_parallel)
from bigdl_tpu_torch.parallel.ring_attention import (ring_attention,
                                                     ring_self_attention)
from bigdl_tpu_torch.parallel.tensor_parallel import (column_parallel,
                                                      head_count_divisible,
                                                      row_parallel,
                                                      tp_shard_params,
                                                      tp_specs)

__all__ = ["AllReduceParameter", "DistriOptimizer", "PipelineOptimizer",
           "column_parallel", "ep_shard_params", "expert_parallel_apply",
           "head_count_divisible", "pipeline_apply", "pipeline_shard_params",
           "ring_attention", "ring_permute", "ring_self_attention",
           "row_parallel", "stack_stage_params", "stage_tp_specs",
           "tp_shard_params", "tp_specs", "unstack_stage_params",
           "wire_model_parallel"]
