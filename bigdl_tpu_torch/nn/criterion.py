"""Loss functions (``bigdl_tpu/nn/criterion.py``: ``ClassNLLCriterion``
:26-46, ``CrossEntropyCriterion`` :49-57, ``MSECriterion`` :60,
``TimeDistributedCriterion`` :428-476).

Conventions kept from the reference and Torch: class labels are 1-based
floats; ``size_average=True`` divides by the batch size (or by the sum of
the picked class weights, or by the element count for ``MSECriterion``);
``apply(input, target)`` is a scalar tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from bigdl_tpu_torch.nn.module import Criterion


def _to_index(target) -> torch.Tensor:
    """1-based float labels -> 0-based int64 (truncating, as the JAX
    package's int cast)."""
    return torch.as_tensor(target).to(torch.int64) - 1


class ClassNLLCriterion(Criterion):
    """NLL over log-probabilities with 1-based targets
    (reference ``nn/ClassNLLCriterion.scala``).  ``weights`` scale each
    class; with ``size_average`` the sum is divided by the picked weights'
    sum (or by N without weights).  A label of 0, which padding leaves
    (``dataset/text.py``'s fixed-length sentences), picks the last class,
    as the JAX package's gather wraps the index -1."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = None if weights is None else torch.as_tensor(
            np.asarray(weights), dtype=torch.float32)
        self.size_average = size_average

    def apply(self, input: torch.Tensor, target) -> torch.Tensor:
        logp = input if input.dim() >= 2 else input.reshape(1, -1)
        idx = _to_index(target).to(logp.device).reshape(-1)
        idx = torch.where(idx < 0, idx + logp.shape[1], idx)
        picked = logp.gather(1, idx[:, None])[:, 0]
        if self.weights is not None:
            w = self.weights.to(device=logp.device, dtype=logp.dtype)[idx]
            loss = -(picked * w).sum()
            denom = w.sum()
        else:
            loss = -picked.sum()
            denom = logp.shape[0]
        return loss / denom if self.size_average else loss


class CrossEntropyCriterion(Criterion):
    """LogSoftMax over the last axis, then ClassNLL (reference
    ``nn/CrossEntropyCriterion.scala``)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.nll = ClassNLLCriterion(weights, size_average)

    def apply(self, input: torch.Tensor, target) -> torch.Tensor:
        return self.nll.apply(torch.log_softmax(input, dim=-1), target)


class MSECriterion(Criterion):
    """Sum of squared differences (reference ``nn/MSECriterion.scala``),
    divided by the element count with ``size_average``."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def apply(self, input: torch.Tensor, target) -> torch.Tensor:
        d = input - torch.as_tensor(target, device=input.device)
        s = (d * d).sum()
        return s / input.numel() if self.size_average else s


class TimeDistributedCriterion(Criterion):
    """Apply a criterion at every timestep of (N, T, ...) input
    (reference ``nn/TimeDistributedCriterion.scala``).

    A separable inner criterion (of those ported: an unweighted
    ``ClassNLLCriterion``, a ``CrossEntropyCriterion`` whose ``nll`` is
    unweighted, ``MSECriterion``) takes one call on the time-flattened
    batch, scaled back to the unrolled sum of per-timestep means; any other
    is unrolled over T.  ``size_average`` then divides by T."""

    def __init__(self, critrn: Criterion, size_average: bool = False):
        super().__init__()
        self.critrn = critrn
        self.size_average = size_average

    def _separable(self) -> bool:
        c = self.critrn
        if isinstance(c, MSECriterion):
            return True
        if isinstance(c, ClassNLLCriterion):
            return c.weights is None
        if isinstance(c, CrossEntropyCriterion):
            return c.nll.weights is None
        return False

    def _inner_size_average(self) -> bool:
        c = self.critrn
        # CrossEntropy delegates to its NLL: the constructor's flag lives
        # there, not on the base class's default
        if isinstance(c, CrossEntropyCriterion):
            return c.nll.size_average
        return getattr(c, "size_average", False)

    def apply(self, input: torch.Tensor, target) -> torch.Tensor:
        t_steps = input.shape[1]
        target = torch.as_tensor(target)
        if self._separable():
            flat_in = input.reshape((-1,) + tuple(input.shape[2:]))
            flat_tgt = target.reshape((-1,) + tuple(target.shape[2:]))
            total = self.critrn.apply(flat_in, flat_tgt)
            # the flat mean divides by N*T (or N*T*D); the unrolled sum of
            # per-timestep means divides by N (or N*D): scale back
            if self._inner_size_average():
                total = total * t_steps
        else:
            total = 0.0
            for t in range(t_steps):
                total = total + self.critrn.apply(input[:, t], target[:, t])
        return total / t_steps if self.size_average else total
