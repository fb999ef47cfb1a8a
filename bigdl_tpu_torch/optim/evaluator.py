"""Evaluation over a dataset (``bigdl_tpu/optim/evaluator.py``:
``_eval_forward`` :33, ``evaluate_dataset`` :98,
``_merge_partials_across_processes`` :224, ``Evaluator`` :244,
``Validator``/``LocalValidator``/``DistriValidator`` :258-270; reference
``optim/Evaluator.scala:37-74``, ``optim/Validator.scala``,
``DistriValidator.scala:35``).

The JAX package memoizes a compiled eval forward on the model; eager
PyTorch needs none, so the forward runs under ``torch.inference_mode`` in
eval mode, where BatchNorm normalises with its running statistics.  Each
batch's outputs come to the host once, and every metric reads that host
array.  The caller's train/eval mode is put back afterwards.

Distributed evaluation: with a :class:`ShardedDataSet` in a process group
of more than one rank, rank r scores the partitions p with p mod N = r
(its own, where there are as many partitions as ranks) and the partial
sums (result, count) of every metric are summed over the group with one
``all_reduce``: every rank returns the same global metrics, as the
reference reduces ``metric +`` across executors.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
from typing import Callable, Iterator, List, Sequence, Tuple

import torch
import torch.distributed as dist

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet, ShardedDataSet
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
from bigdl_tpu_torch.engine import (DeviceLike, allgather_sum,
                                    check_on_device, default_device,
                                    tree_to_device)
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


def _distributed(dataset, group) -> bool:
    return (isinstance(dataset, ShardedDataSet) and dist.is_available()
            and dist.is_initialized() and dist.get_world_size(group) > 1)


def evaluate_dataset(model: torch.nn.Module, dataset,
                     methods: Sequence[ValidationMethod],
                     device: torch.device, group=None
                     ) -> List[Tuple[ValidationMethod, ValidationResult]]:
    """Every metric over a dataset of MiniBatches (its
    ``data(train=False)``) or an iterable of them, merged with the
    results' ``+``.  A :class:`ShardedDataSet` in a process group of
    several ranks scores this rank's partitions (:func:`_rank_partitions`)
    and sums the partials over ``group`` (a collective: every rank calls
    it).  Raises
    :class:`ValueError` on an empty dataset (on every rank, in the
    distributed case)."""
    distributed = _distributed(dataset, group)
    if (isinstance(dataset, ShardedDataSet) and
            getattr(dataset, "dropped_records", 0)):
        logging.getLogger("bigdl_tpu_torch").warning(
            "evaluating a ShardedDataSet that dropped %d tail record(s) to "
            "equalize %d partitions: metrics cover %d records",
            dataset.dropped_records, dataset.partition_num, dataset.size())
    if distributed:
        batches = itertools.chain.from_iterable(
            dataset.shard_data(p, train=False)
            for p in _rank_partitions(dataset, group))
    elif isinstance(dataset, AbstractDataSet):
        batches = dataset.data(train=False)
    else:
        batches = iter(dataset)
    totals: List = [None] * len(methods)
    with eval_mode(model) as fwd:
        for batch in batches:
            out = fwd(tree_to_device(batch.get_input(), device)).cpu().numpy()
            tgt = batch.get_target()
            for i, m in enumerate(methods):
                r = m.apply(out, tgt)
                totals[i] = r if totals[i] is None else totals[i] + r
    if distributed:
        totals = _merge_partials_across_processes(methods, totals, group)
    if methods and all(t is None for t in totals):
        raise ValueError("evaluate_dataset got an empty dataset: no batches "
                         "to score")
    return [(m, t) for m, t in zip(methods, totals) if t is not None]


def _rank_partitions(dataset: ShardedDataSet, group) -> List[int]:
    """The partitions this rank scores: p mod N = rank.  Raises
    :class:`ValueError` when the dataset does not hold one of them."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    mine = [p for p in range(dataset.partition_num) if p % world == rank]
    missing = [p for p in mine if p not in dataset.local_partitions]
    if missing:
        raise ValueError(f"rank {rank} scores partitions {mine}, but the "
                         f"dataset holds only {dataset.local_partitions}")
    return mine


def _merge_partials_across_processes(methods, totals, group=None):
    """Sum the ranks' partial results into the global metrics with one
    ``all_reduce`` (float64) over ``group``: a collective."""
    local = [[t.result, t.count] if t is not None else [0.0, 0.0]
             for t in totals]
    summed = allgather_sum(local, group)
    merged = []
    for m, t, (r, c) in zip(methods, totals, summed):
        if c == 0:
            merged.append(None)
            continue
        name = t.name if t is not None else m.name
        merged.append(ValidationResult(r, int(c), name))
    return merged


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


class Validator:
    """Metrics of a model over a MiniBatch dataset (reference
    ``optim/Validator.scala``); a :class:`ShardedDataSet` in a process
    group of several ranks is scored by every rank together
    (``DistriValidator``)."""

    def __init__(self, model: torch.nn.Module, dataset,
                 device: DeviceLike = "cuda"):
        self.device = default_device(device)
        check_on_device(model, self.device)
        self.model = model
        self.dataset = dataset

    def test(self, methods: Sequence[ValidationMethod]):
        return evaluate_dataset(self.model, self.dataset, methods,
                                self.device)


LocalValidator = Validator
DistriValidator = Validator
