"""Loss functions (``bigdl_tpu/nn/criterion.py``: ``ClassNLLCriterion``
:26-46, ``TimeDistributedCriterion`` :428-476).

Conventions kept from the reference and Torch: class labels are 1-based
floats; ``size_average=True`` divides by the batch size (or by the sum of
the picked class weights); ``apply(input, target)`` is a scalar tensor.
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
    sum (or by N without weights)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = None if weights is None else torch.as_tensor(
            np.asarray(weights), dtype=torch.float32)
        self.size_average = size_average

    def apply(self, input: torch.Tensor, target) -> torch.Tensor:
        logp = input if input.dim() >= 2 else input.reshape(1, -1)
        idx = _to_index(target).to(logp.device).reshape(-1)
        picked = logp.gather(1, idx[:, None])[:, 0]
        if self.weights is not None:
            w = self.weights.to(device=logp.device, dtype=logp.dtype)[idx]
            loss = -(picked * w).sum()
            denom = w.sum()
        else:
            loss = -picked.sum()
            denom = logp.shape[0]
        return loss / denom if self.size_average else loss


class TimeDistributedCriterion(Criterion):
    """Apply a criterion at every timestep of (N, T, ...) input
    (reference ``nn/TimeDistributedCriterion.scala``).

    A separable inner criterion (of those ported: an unweighted
    ``ClassNLLCriterion``) takes one call on the time-flattened batch, scaled
    back to the unrolled sum of per-timestep means; any other is unrolled
    over T.  ``size_average`` then divides by T."""

    def __init__(self, critrn: Criterion, size_average: bool = False):
        super().__init__()
        self.critrn = critrn
        self.size_average = size_average

    def _separable(self) -> bool:
        c = self.critrn
        return isinstance(c, ClassNLLCriterion) and c.weights is None

    def apply(self, input: torch.Tensor, target) -> torch.Tensor:
        t_steps = input.shape[1]
        target = torch.as_tensor(target)
        if self._separable():
            flat_in = input.reshape((-1,) + tuple(input.shape[2:]))
            flat_tgt = target.reshape((-1,) + tuple(target.shape[2:]))
            total = self.critrn.apply(flat_in, flat_tgt)
            # the flat mean divides by N*T; the unrolled sum of
            # per-timestep means divides by N: scale back
            if getattr(self.critrn, "size_average", False):
                total = total * t_steps
        else:
            total = 0.0
            for t in range(t_steps):
                total = total + self.critrn.apply(input[:, t], target[:, t])
        return total / t_steps if self.size_average else total
