"""Training and inference of the port (``bigdl_tpu/optim``): the optimizer
and its training loop, optimization methods, triggers and regularizers.  The
inference side (``evaluator``, ``predictor``) is imported from its modules."""

from bigdl_tpu_torch.optim.optim_method import (SGD, Adam, Default,
                                                LearningRateSchedule,
                                                OptimMethod)
from bigdl_tpu_torch.optim.optimizer import (DivergenceError, LocalOptimizer,
                                             Optimizer)
from bigdl_tpu_torch.optim.regularizer import (L1L2Regularizer,
                                               L1Regularizer, L2Regularizer,
                                               Regularizer)
from bigdl_tpu_torch.optim.trigger import (Trigger, every_epoch, max_epoch,
                                           max_iteration, max_score,
                                           min_loss, several_iteration)

__all__ = ["Adam", "Default", "DivergenceError", "L1L2Regularizer",
           "L1Regularizer", "L2Regularizer", "LearningRateSchedule",
           "LocalOptimizer", "OptimMethod", "Optimizer", "Regularizer", "SGD",
           "Trigger", "every_epoch", "max_epoch", "max_iteration",
           "max_score", "min_loss", "several_iteration"]
