"""Loss functions (``bigdl_tpu/nn/criterion.py``: ``ClassNLLCriterion``
:26-46, ``CrossEntropyCriterion`` :49-57, ``MSECriterion`` :60, then
``AbsCriterion`` to ``ClassSimplexCriterion`` :67-425 in the JAX package's
order, ``MultiCriterion`` :178, ``ParallelCriterion`` :197,
``SmoothL1CriterionWithWeights`` :299, ``SoftmaxWithCriterion`` :322,
``ClassSimplexCriterion`` :398, ``TimeDistributedCriterion`` :428-476).

Conventions kept from the reference and Torch: class labels are 1-based
floats; ``size_average=True`` (every criterion's default, as there) divides
by the batch size (or by the sum of the picked class weights, or by the
element count where Torch does); ``apply(input, target)`` is a scalar
tensor, computed op for op as the JAX package computes it.  A floating
target is taken in the input's dtype and on its device.  Where the JAX
package takes ``max(0, v)``, so does the port (``torch.maximum``, whose
gradient at a tie is split as JAX's is).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Criterion


def _to_index(target) -> torch.Tensor:
    """1-based float labels -> 0-based int64 (truncating, as the JAX
    package's int cast)."""
    return torch.as_tensor(target).to(torch.int64) - 1


def _like(target, x: torch.Tensor) -> torch.Tensor:
    """A target as a tensor on ``x``'s device, in ``x``'s dtype."""
    return torch.as_tensor(target).to(device=x.device, dtype=x.dtype)


def _relu(v: torch.Tensor) -> torch.Tensor:
    return torch.maximum(v, torch.zeros_like(v))


def _reduce(l: torch.Tensor, size_average: bool) -> torch.Tensor:
    return l.mean() if size_average else l.sum()


def _cosine(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Row-wise cosine over the last dim, the norms' product floored at
    1e-12."""
    norms = torch.linalg.vector_norm(x, dim=-1) * \
        torch.linalg.vector_norm(t, dim=-1)
    return (x * t).sum(dim=-1) / torch.clamp(norms, min=1e-12)


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


class AbsCriterion(Criterion):
    """Sum of absolute differences (reference ``nn/AbsCriterion.scala``),
    divided by the element count with ``size_average``."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def apply(self, input, target):
        s = torch.abs(input - _like(target, input)).sum()
        return s / input.numel() if self.size_average else s


class BCECriterion(Criterion):
    """Binary cross entropy on probabilities clipped to [1e-12, 1 - 1e-12]
    (reference ``nn/BCECriterion.scala``), times ``weights``."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = None if weights is None else torch.as_tensor(
            np.asarray(weights), dtype=torch.float32)
        self.size_average = size_average

    def apply(self, input, target):
        eps = 1e-12
        t = _like(target, input)
        x = torch.clamp(input, eps, 1.0 - eps)
        l = -(t * torch.log(x) + (1.0 - t) * torch.log(1.0 - x))
        if self.weights is not None:
            l = l * self.weights.to(device=l.device, dtype=l.dtype)
        s = l.sum()
        return s / input.numel() if self.size_average else s


class DistKLDivCriterion(Criterion):
    """KL(target || input) with the input log-probabilities (reference
    ``nn/DistKLDivCriterion.scala``), divided by the element count with
    ``size_average``."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def apply(self, input, target):
        t = _like(target, input)
        l = torch.where(t > 0, t * (torch.log(torch.clamp(t, min=1e-30))
                                    - input), torch.zeros_like(input))
        s = l.sum()
        return s / input.numel() if self.size_average else s


class CosineEmbeddingCriterion(Criterion):
    """A table [x1, x2] and targets of +-1: 1 - cos for +1, max(0, cos -
    margin) for -1 (reference ``nn/CosineEmbeddingCriterion.scala``)."""

    def __init__(self, margin: float = 0.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        x1, x2 = torch.atleast_2d(input[0]), torch.atleast_2d(input[1])
        y = _like(target, x1).reshape(-1)
        cos = _cosine(x1, x2)
        l = torch.where(y > 0, 1.0 - cos, _relu(cos - self.margin))
        return _reduce(l, self.size_average)


class HingeEmbeddingCriterion(Criterion):
    """x for target +1, max(0, margin - x) for -1 (reference
    ``nn/HingeEmbeddingCriterion.scala``)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        t = _like(target, input)
        l = torch.where(t > 0, input, _relu(self.margin - input))
        return _reduce(l, self.size_average)


class L1HingeEmbeddingCriterion(Criterion):
    """A table [x1, x2]: their L1 distance d for target +1, max(0, margin
    - d) for -1 (reference ``nn/L1HingeEmbeddingCriterion.scala``)."""

    def __init__(self, margin: float = 1.0):
        super().__init__()
        self.margin = margin

    def apply(self, input, target):
        d = torch.abs(input[0] - input[1]).sum()
        y = _like(target, d).reshape(-1)[0]
        return torch.where(y > 0, d, _relu(self.margin - d))


class MarginCriterion(Criterion):
    """The hinge max(0, margin - x * y) (reference
    ``nn/MarginCriterion.scala``)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        l = _relu(self.margin - input * _like(target, input))
        return _reduce(l, self.size_average)


class MarginRankingCriterion(Criterion):
    """A table [x1, x2]: max(0, -y * (x1 - x2) + margin) (reference
    ``nn/MarginRankingCriterion.scala``)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        x1, x2 = input[0].reshape(-1), input[1].reshape(-1)
        y = _like(target, x1).reshape(-1)
        l = _relu(-y * (x1 - x2) + self.margin)
        return _reduce(l, self.size_average)


class MultiCriterion(Criterion):
    """The weighted sum of criterions of the same (input, target)
    (reference ``nn/MultiCriterion.scala``)."""

    def __init__(self):
        super().__init__()
        self.criterions: List[Criterion] = []
        self.weights: List[float] = []

    def add(self, criterion: Criterion, weight: float = 1.0):
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def apply(self, input, target):
        return sum(w * c.apply(input, target)
                   for c, w in zip(self.criterions, self.weights))


class ParallelCriterion(Criterion):
    """The weighted sum of criterion i over input i and target i (target
    itself for each with ``repeat_target``; reference
    ``nn/ParallelCriterion.scala``)."""

    def __init__(self, repeat_target: bool = False):
        super().__init__()
        self.repeat_target = repeat_target
        self.criterions: List[Criterion] = []
        self.weights: List[float] = []

    def add(self, criterion: Criterion, weight: float = 1.0):
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def apply(self, input, target):
        total = 0.0
        for i, (c, w) in enumerate(zip(self.criterions, self.weights)):
            t = target if self.repeat_target else target[i]
            total = total + w * c.apply(input[i], t)
        return total


class MultiLabelMarginCriterion(Criterion):
    """Multi-class multi-label hinge (reference
    ``nn/MultiLabelMarginCriterion.scala``): each target row lists 1-based
    labels, 0 as padding; for each label j and each class k not among the
    labels, max(0, 1 - (x_j - x_k)), summed and divided by the classes."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def apply(self, input, target):
        x = torch.atleast_2d(input)
        t = torch.atleast_2d(torch.as_tensor(target)).to(
            device=x.device, dtype=torch.int64)
        c = x.shape[1]
        valid = t > 0
        idx = torch.clamp(t - 1, 0, c - 1)
        is_target = (F.one_hot(idx, c).to(torch.bool) &
                     valid[..., None]).any(dim=1)
        tscores = torch.where(valid, x.gather(1, idx),
                              torch.full(idx.shape, math.inf, dtype=x.dtype,
                                         device=x.device))
        margins = _relu(1.0 - (tscores[:, :, None] - x[:, None, :]))
        mask = valid[:, :, None] & ~is_target[:, None, :]
        l = torch.where(mask, margins, torch.zeros_like(margins)) \
            .sum(dim=(1, 2)) / c
        return _reduce(l, self.size_average)


class MultiLabelSoftMarginCriterion(Criterion):
    """One-vs-all logistic loss over the classes (reference
    ``nn/MultiLabelSoftMarginCriterion.scala``), times ``weights``."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = None if weights is None else torch.as_tensor(
            np.asarray(weights), dtype=torch.float32)
        self.size_average = size_average

    def apply(self, input, target):
        t = _like(target, input)
        l = t * F.logsigmoid(input) + (1.0 - t) * F.logsigmoid(-input)
        if self.weights is not None:
            l = l * self.weights.to(device=l.device, dtype=l.dtype)
        s = -l.sum() / input.shape[-1]
        n = input.shape[0] if input.dim() > 1 else 1
        return s / n if self.size_average else s


class MultiMarginCriterion(Criterion):
    """Multi-class hinge max(0, margin - x_y + x_k) ** p over the classes k
    other than the 1-based target y, divided by the classes (reference
    ``nn/MultiMarginCriterion.scala``)."""

    def __init__(self, p: int = 1, weights=None, margin: float = 1.0,
                 size_average: bool = True):
        super().__init__()
        self.p = p
        self.weights = None if weights is None else torch.as_tensor(
            np.asarray(weights), dtype=torch.float32)
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        x = torch.atleast_2d(input)
        idx = _to_index(target).to(x.device).reshape(-1)
        c = x.shape[1]
        tgt = x.gather(1, idx[:, None])
        margins = _relu(self.margin - tgt + x) ** self.p
        if self.weights is not None:
            w = self.weights.to(device=x.device, dtype=x.dtype)[idx]
            margins = margins * w[:, None]
        onehot = F.one_hot(idx, c).to(torch.bool)
        l = torch.where(onehot, torch.zeros_like(margins), margins) \
            .sum(dim=1) / c
        return _reduce(l, self.size_average)


class SmoothL1Criterion(Criterion):
    """0.5 d^2 where |d| < 1, else |d| - 0.5 (reference
    ``nn/SmoothL1Criterion.scala``), divided by the element count with
    ``size_average``."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def apply(self, input, target):
        d = torch.abs(input - _like(target, input))
        s = torch.where(d < 1.0, 0.5 * d * d, d - 0.5).sum()
        return s / input.numel() if self.size_average else s


class SmoothL1CriterionWithWeights(Criterion):
    """Fast R-CNN's smooth L1 with inside and outside weights (reference
    ``nn/SmoothL1CriterionWithWeights.scala``): the target is a tensor or
    a table [target, inside weights, outside weights]; the sum is divided
    by ``num`` when it is positive."""

    def __init__(self, sigma: float = 1.0, num: int = 0):
        super().__init__()
        self.sigma2 = sigma * sigma
        self.num = num

    def apply(self, input, target):
        if isinstance(target, (list, tuple)):
            t, inw, outw = (_like(v, input) for v in target[:3])
        else:
            t, inw, outw = _like(target, input), 1.0, 1.0
        d = (input - t) * inw
        ad = torch.abs(d)
        l = torch.where(ad < 1.0 / self.sigma2, 0.5 * self.sigma2 * d * d,
                        ad - 0.5 / self.sigma2)
        s = (l * outw).sum()
        return s / self.num if self.num > 0 else s


class SoftmaxWithCriterion(Criterion):
    """Caffe's SoftmaxWithLoss over (N, C, H, W) logits and (N, H, W) or
    (N, 1, H, W) 1-based labels (reference
    ``nn/SoftmaxWithCriterion.scala``): ``ignore_label`` drops its pixels;
    ``normalize_mode`` ``"VALID"`` divides by the pixels kept,
    ``"BATCH_SIZE"`` by N, ``"FULL"`` by every pixel, anything else not at
    all."""

    def __init__(self, ignore_label: Optional[int] = None,
                 normalize_mode: str = "VALID"):
        super().__init__()
        self.ignore_label = ignore_label
        self.normalize_mode = normalize_mode

    def apply(self, input, target):
        logp = torch.log_softmax(input, dim=1)
        idx = _to_index(target).to(input.device)
        if idx.dim() == input.dim():
            idx = idx[:, 0]
        picked = logp.gather(1, idx[:, None])[:, 0]
        if self.ignore_label is not None:
            valid = (idx + 1) != self.ignore_label
            picked = torch.where(valid, picked, torch.zeros_like(picked))
            count = valid.sum()
        else:
            count = picked.numel()
        loss = -picked.sum()
        if self.normalize_mode == "VALID":
            return loss / (torch.clamp(count, min=1)
                           if isinstance(count, torch.Tensor)
                           else max(count, 1))
        if self.normalize_mode == "BATCH_SIZE":
            return loss / input.shape[0]
        if self.normalize_mode == "FULL":
            return loss / picked.numel()
        return loss


class SoftMarginCriterion(Criterion):
    """log(1 + exp(-y * x)) (reference ``nn/SoftMarginCriterion.scala``)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def apply(self, input, target):
        l = torch.log1p(torch.exp(-input * _like(target, input)))
        return _reduce(l, self.size_average)


class L1Cost(Criterion):
    """The sum of the input's absolute values; the target is unused
    (reference ``nn/L1Cost.scala``)."""

    def apply(self, input, target=None):
        return torch.abs(input).sum()


class CosineDistanceCriterion(Criterion):
    """1 - cos(input, target), row-wise (reference
    ``nn/CosineDistanceCriterion.scala``)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def apply(self, input, target):
        x = torch.atleast_2d(input)
        l = 1.0 - _cosine(x, torch.atleast_2d(_like(target, input)))
        return _reduce(l, self.size_average)


class DiceCoefficientCriterion(Criterion):
    """1 - 2 (|x t| + eps) / (|x| + |t| + 2 eps), row-wise (reference
    ``nn/DiceCoefficientCriterion.scala``)."""

    def __init__(self, size_average: bool = True, epsilon: float = 1.0):
        super().__init__()
        self.size_average = size_average
        self.epsilon = epsilon

    def apply(self, input, target):
        x = torch.atleast_2d(input)
        t = torch.atleast_2d(_like(target, input))
        inter = (x * t).sum(dim=-1)
        union = x.sum(dim=-1) + t.sum(dim=-1)
        l = 1.0 - 2.0 * (inter + self.epsilon) / (union + 2 * self.epsilon)
        return _reduce(l, self.size_average)


class ClassSimplexCriterion(Criterion):
    """The squared distance to the target class's vertex of a regular
    simplex, averaged over the batch (reference
    ``nn/ClassSimplexCriterion.scala``): the rows of the identity less their
    centroid, normalised, in float32 as the JAX package builds them."""

    def __init__(self, n_classes: int):
        super().__init__()
        self.n_classes = n_classes
        m = np.eye(n_classes, dtype=np.float32)
        m = m - m.mean(axis=0, keepdims=True)
        m = m / np.linalg.norm(m, axis=1, keepdims=True)
        self.simplex = torch.from_numpy(m)

    def apply(self, input, target):
        idx = _to_index(target).reshape(-1)
        x = torch.atleast_2d(input)
        t = self.simplex.to(device=x.device, dtype=x.dtype)[idx.to(x.device)]
        d = x - t
        return (d * d).sum(dim=-1).mean()


class TimeDistributedCriterion(Criterion):
    """Apply a criterion at every timestep of (N, T, ...) input
    (reference ``nn/TimeDistributedCriterion.scala``).

    A separable inner criterion (an unweighted ``ClassNLLCriterion`` or
    ``BCECriterion``, a ``CrossEntropyCriterion`` whose ``nll`` is
    unweighted, ``MSECriterion``, ``AbsCriterion``) takes one call on the
    time-flattened batch, scaled back to the unrolled sum of per-timestep
    means; any other is unrolled over T.  ``size_average`` then divides by T."""

    def __init__(self, critrn: Criterion, size_average: bool = False):
        super().__init__()
        self.critrn = critrn
        self.size_average = size_average

    def _separable(self) -> bool:
        c = self.critrn
        if isinstance(c, (MSECriterion, AbsCriterion)):
            return True
        if isinstance(c, (ClassNLLCriterion, BCECriterion)):
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
