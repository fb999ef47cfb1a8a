"""Serving of the port (``bigdl_tpu/serving``): the micro-batching
``ServingEngine``.  ``LMServingEngine`` with its paged KV cache comes later."""

from bigdl_tpu_torch.serving.engine import (DeadlineExceeded, Overloaded,
                                            RequestHandle, ServingDataError,
                                            ServingEngine, ServingError,
                                            ServingInfraError)

__all__ = ["DeadlineExceeded", "Overloaded", "RequestHandle",
           "ServingDataError", "ServingEngine", "ServingError",
           "ServingInfraError"]
