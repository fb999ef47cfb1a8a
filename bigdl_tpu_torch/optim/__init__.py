"""Training and inference of the port (``bigdl_tpu/optim``): the optimizer
and its training loop with validation, checkpoints and retry, optimization
methods and learning-rate schedules, triggers, regularizers, the evaluator
and validators with their metrics, and the predictor."""

from bigdl_tpu_torch.optim.evaluator import (DistriValidator, Evaluator,
                                             LocalValidator, Validator,
                                             evaluate_dataset)
from bigdl_tpu_torch.optim.optim_method import (LBFGS, SGD, Adadelta,
                                                Adagrad, Adam, Adamax,
                                                Default, EpochDecay,
                                                EpochSchedule, EpochStep,
                                                Exponential,
                                                LearningRateSchedule,
                                                MultiStep, NaturalExp,
                                                OptimMethod, Plateau, Poly,
                                                Regime, RMSprop, Step)
from bigdl_tpu_torch.optim.optimizer import (Checkpoint, DivergenceError,
                                             LocalOptimizer, Optimizer)
from bigdl_tpu_torch.optim.predictor import Predictor
from bigdl_tpu_torch.optim.regularizer import (L1L2Regularizer,
                                               L1Regularizer, L2Regularizer,
                                               Regularizer)
from bigdl_tpu_torch.optim.trigger import (Trigger, every_epoch, max_epoch,
                                           max_iteration, max_score,
                                           min_loss, several_iteration)
from bigdl_tpu_torch.optim.validation_method import (MAE, Loss, Top1Accuracy,
                                                     Top5Accuracy,
                                                     TreeNNAccuracy,
                                                     ValidationMethod,
                                                     ValidationResult)

__all__ = ["Adadelta", "Adagrad", "Adam", "Adamax", "Checkpoint", "Default",
           "DistriValidator", "DivergenceError", "EpochDecay",
           "EpochSchedule", "EpochStep", "Evaluator", "Exponential",
           "L1L2Regularizer", "L1Regularizer", "L2Regularizer", "LBFGS",
           "LearningRateSchedule", "LocalOptimizer", "LocalValidator",
           "Loss", "MAE", "MultiStep", "NaturalExp", "OptimMethod",
           "Optimizer", "Plateau", "Poly", "Predictor", "RMSprop", "Regime",
           "Regularizer", "SGD", "Step", "Top1Accuracy", "Top5Accuracy",
           "TreeNNAccuracy", "Trigger", "ValidationMethod",
           "ValidationResult", "Validator", "evaluate_dataset",
           "every_epoch", "max_epoch", "max_iteration", "max_score",
           "min_loss", "several_iteration"]
