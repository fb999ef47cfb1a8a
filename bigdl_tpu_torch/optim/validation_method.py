"""Evaluation metrics with a mergeable result (``bigdl_tpu/optim/
validation_method.py``: ``ValidationResult`` :21, ``Top1Accuracy`` :68,
``Top5Accuracy`` :82, ``Loss`` :96; reference
``optim/ValidationMethod.scala:170,218,312``).

``apply(output, target)`` takes host arrays (the evaluator pulls each
batch's outputs once) with 1-based labels and returns a
:class:`ValidationResult`; results add, as per-shard partials reduce in the
reference.
"""

from __future__ import annotations

import numpy as np
import torch


class ValidationResult:
    """Mergeable (result, count) pair (reference ``ContiguousResult``)."""

    def __init__(self, result: float, count: int, name: str = ""):
        self.result = float(result)
        self.count = int(count)
        self.name = name

    def __add__(self, other: "ValidationResult") -> "ValidationResult":
        return ValidationResult(self.result + other.result,
                                self.count + other.count, self.name)

    def final_result(self) -> float:
        return self.result / max(self.count, 1)

    def __repr__(self):
        return (f"{self.final_result():.6f} ({self.name}: "
                f"{self.result}/{self.count})")


class ValidationMethod:
    """Base; ``apply(output, target) -> ValidationResult`` on host arrays."""

    name = "ValidationMethod"

    def apply(self, output, target) -> ValidationResult:
        raise NotImplementedError(type(self).__name__)

    def __call__(self, output, target) -> ValidationResult:
        return self.apply(output, target)

    def __repr__(self):
        return self.name


def _rows(output) -> np.ndarray:
    out = np.asarray(output)
    return out[None, :] if out.ndim == 1 else out


class Top1Accuracy(ValidationMethod):
    """Share of rows whose argmax is the label."""

    name = "Top1Accuracy"

    def apply(self, output, target) -> ValidationResult:
        tgt = np.asarray(target).reshape(-1)
        pred = _rows(output).argmax(axis=-1) + 1
        correct = int((pred == tgt.astype(np.int64)).sum())
        return ValidationResult(correct, tgt.shape[0], self.name)


class Top5Accuracy(ValidationMethod):
    """Share of rows whose five largest outputs hold the label."""

    name = "Top5Accuracy"

    def apply(self, output, target) -> ValidationResult:
        tgt = np.asarray(target).reshape(-1).astype(np.int64)
        top5 = np.argsort(-_rows(output), axis=-1)[:, :5] + 1
        correct = int((top5 == tgt[:, None]).any(axis=1).sum())
        return ValidationResult(correct, tgt.shape[0], self.name)


class Loss(ValidationMethod):
    """A criterion's value as a metric, weighted by the rows of each batch
    (default ``ClassNLLCriterion``)."""

    name = "Loss"

    def __init__(self, criterion=None):
        if criterion is None:
            from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
            criterion = ClassNLLCriterion()
        self.criterion = criterion

    def apply(self, output, target) -> ValidationResult:
        loss = float(self.criterion.apply(torch.as_tensor(np.asarray(output)),
                                          torch.as_tensor(np.asarray(target))))
        n = np.asarray(target).reshape(-1).shape[0]
        return ValidationResult(loss * n, n, self.name)
