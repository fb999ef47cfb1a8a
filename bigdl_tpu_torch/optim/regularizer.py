"""Regularizers: L1/L2/L1L2 penalties (``bigdl_tpu/optim/regularizer.py``;
reference ``optim/Regularizer.scala:87,175,186``).

As in the JAX package, a regularizer contributes a penalty term that the
training loss adds, so its gradient comes through autograd (the same as the
reference's in-place gradient update for L2; for L1 the subgradient at 0 is
sign(0) = 0, the reference's convention).
"""

from __future__ import annotations

from typing import Iterable

import torch


class Regularizer:
    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        self.l1 = l1
        self.l2 = l2

    def penalty(self, params: Iterable[torch.Tensor]) -> torch.Tensor:
        """l1 * sum|p| + l2/2 * sum p^2 over ``params``, a scalar on their
        device (0 for no parameters)."""
        total = None
        for p in params:
            if self.l1:
                term = self.l1 * p.abs().sum()
                total = term if total is None else total + term
            if self.l2:
                term = 0.5 * self.l2 * (p * p).sum()
                total = term if total is None else total + term
        return total if total is not None else torch.zeros(())


class L1Regularizer(Regularizer):
    def __init__(self, l1: float):
        super().__init__(l1=l1)


class L2Regularizer(Regularizer):
    def __init__(self, l2: float):
        super().__init__(l2=l2)


class L1L2Regularizer(Regularizer):
    pass
