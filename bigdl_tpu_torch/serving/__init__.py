"""Serving of the port (``bigdl_tpu/serving``): the micro-batching
``ServingEngine``; ``LMServingEngine``, which streams tokens from a
transformer LM through a paged KV cache with its decode step captured as one
CUDA graph (an int8 decode tier beside it); their failure taxonomy (the
hung-dispatch watchdog, the drain on preemption, the admission governor,
the chaos hooks); and the open-loop load generators that drive both."""

from bigdl_tpu_torch.serving.engine import (DeadlineExceeded,
                                            HungDispatchError, Overloaded,
                                            RequestHandle, ServingDataError,
                                            ServingEngine, ServingError,
                                            ServingInfraError)
from bigdl_tpu_torch.serving.kv_cache import PagedKVCache
from bigdl_tpu_torch.serving.lm import (LMServingEngine,
                                        QuantizationGateError, TokenStream,
                                        UnsupportedModelError)
from bigdl_tpu_torch.serving.loadgen import (run_lm_open_loop, run_open_loop,
                                             sample_lm_workload)

__all__ = ["DeadlineExceeded", "HungDispatchError", "LMServingEngine",
           "Overloaded", "PagedKVCache", "QuantizationGateError",
           "RequestHandle", "ServingDataError", "ServingEngine",
           "ServingError", "ServingInfraError", "TokenStream",
           "UnsupportedModelError", "run_lm_open_loop", "run_open_loop",
           "sample_lm_workload"]
