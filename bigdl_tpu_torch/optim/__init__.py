"""Training and inference of the port (``bigdl_tpu/optim``): the optimizer
and its training loop, optimization methods, triggers, regularizers, the
evaluator with its metrics, and the predictor."""

from bigdl_tpu_torch.optim.evaluator import Evaluator
from bigdl_tpu_torch.optim.optim_method import (SGD, Adam, Default,
                                                LearningRateSchedule,
                                                OptimMethod)
from bigdl_tpu_torch.optim.optimizer import (DivergenceError, LocalOptimizer,
                                             Optimizer)
from bigdl_tpu_torch.optim.predictor import Predictor
from bigdl_tpu_torch.optim.regularizer import (L1L2Regularizer,
                                               L1Regularizer, L2Regularizer,
                                               Regularizer)
from bigdl_tpu_torch.optim.trigger import (Trigger, every_epoch, max_epoch,
                                           max_iteration, max_score,
                                           min_loss, several_iteration)
from bigdl_tpu_torch.optim.validation_method import (Loss, Top1Accuracy,
                                                     Top5Accuracy,
                                                     ValidationMethod,
                                                     ValidationResult)

__all__ = ["Adam", "Default", "DivergenceError", "Evaluator",
           "L1L2Regularizer", "L1Regularizer", "L2Regularizer",
           "LearningRateSchedule", "LocalOptimizer", "Loss", "OptimMethod",
           "Optimizer", "Predictor", "Regularizer", "SGD", "Top1Accuracy",
           "Top5Accuracy", "Trigger", "ValidationMethod", "ValidationResult",
           "every_epoch", "max_epoch", "max_iteration", "max_score",
           "min_loss", "several_iteration"]
