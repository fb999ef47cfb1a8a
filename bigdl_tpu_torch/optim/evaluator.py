"""Evaluation over a dataset (``bigdl_tpu/optim/evaluator.py``:
``_eval_forward`` :33, ``evaluate_dataset`` :98, ``Evaluator`` :244;
reference ``optim/Evaluator.scala:37-74``).

The JAX package memoizes a compiled eval forward on the model; eager
PyTorch needs none, so the forward runs under ``torch.inference_mode`` in
eval mode, where BatchNorm normalises with its running statistics.  Each
batch's outputs come to the host once, and every metric reads that host
array.  The caller's train/eval mode is put back afterwards.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Callable, Iterable, Iterator, List, Sequence, Tuple

import torch

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
from bigdl_tpu_torch.engine import (DeviceLike, check_on_device,
                                    default_device, to_device)
from bigdl_tpu_torch.optim.validation_method import (ValidationMethod,
                                                     ValidationResult)


def _eval_forward(model: torch.nn.Module) -> Callable:
    """Put ``model`` in eval mode and return its inference forward."""
    model.eval()

    def fwd(inputs):
        with torch.inference_mode():
            return model(inputs)

    return fwd


@contextlib.contextmanager
def eval_mode(model: torch.nn.Module):
    """The model in eval mode for the block; its own mode after."""
    was_training = model.training
    try:
        yield _eval_forward(model)
    finally:
        model.train(was_training)


def minibatches(dataset, batch_size: int) -> Iterator:
    """The MiniBatches of a dataset (``data(train=False)``) or iterable:
    Samples are grouped by ``SampleToMiniBatch(batch_size)``, MiniBatches
    pass as they are."""
    it = (dataset.data(train=False) if isinstance(dataset, AbstractDataSet)
          else iter(dataset))
    first = next(it, None)
    if first is None:
        return iter(())
    it = itertools.chain([first], it)
    return SampleToMiniBatch(batch_size)(it) if isinstance(first, Sample) \
        else it


def evaluate_dataset(model: torch.nn.Module, batches: Iterable,
                     methods: Sequence[ValidationMethod],
                     device: torch.device
                     ) -> List[Tuple[ValidationMethod, ValidationResult]]:
    """Every metric over every MiniBatch of ``batches``, merged with the
    results' ``+``.  Raises :class:`ValueError` on an empty dataset."""
    totals: List = [None] * len(methods)
    with eval_mode(model) as fwd:
        for batch in batches:
            out = fwd(to_device(batch.get_input(), device)).cpu().numpy()
            tgt = batch.get_target()
            for i, m in enumerate(methods):
                r = m.apply(out, tgt)
                totals[i] = r if totals[i] is None else totals[i] + r
    if methods and all(t is None for t in totals):
        raise ValueError("evaluate_dataset got an empty dataset: no batches "
                         "to score")
    return [(m, t) for m, t in zip(methods, totals) if t is not None]


class Evaluator:
    """Metrics of a model over a dataset (reference
    ``optim/Evaluator.scala:37``), with the model on ``device``."""

    def __init__(self, model: torch.nn.Module, device: DeviceLike = "cuda"):
        self.device = default_device(device)
        check_on_device(model, self.device)
        self.model = model

    def test(self, dataset, methods: Sequence[ValidationMethod],
             batch_size: int = 32
             ) -> List[Tuple[ValidationMethod, ValidationResult]]:
        """``dataset``: a ``LocalDataSet`` or an iterable of Samples (or of
        MiniBatches)."""
        return evaluate_dataset(self.model, minibatches(dataset, batch_size),
                                methods, self.device)
