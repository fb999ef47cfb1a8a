"""DataSet: the training-data abstraction (``bigdl_tpu/dataset/dataset.py``
:34-93; reference ``dataset/DataSet.scala:46,110,251-299``).

``LocalDataSet`` keeps the records in memory with a separately shuffled index
array: the training iterator loops over the index forever, and ``shuffle()``
permutes the index in place, so every transformed view of the dataset sees
each epoch's order.  The shuffle draws from the thread-local
:class:`~bigdl_tpu_torch.utils.random_generator.RandomGenerator`, so one seed
gives the JAX package's order.  ``ShardedDataSet`` comes with the
distributed trainer.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.utils.random_generator import RandomGenerator


class AbstractDataSet:
    """(reference ``AbstractDataSet``, ``dataset/DataSet.scala:46``)."""

    def data(self, train: bool) -> Iterator:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self) -> None:
        raise NotImplementedError

    def transform(self, transformer: Transformer) -> "AbstractDataSet":
        raise NotImplementedError


class LocalDataSet(AbstractDataSet):
    """In-memory records + shuffled index (reference ``LocalArrayDataSet``
    and the CachedDistriDataSet index-shuffle protocol)."""

    def __init__(self, records: Sequence[Any],
                 transformers: Optional[List[Transformer]] = None):
        self.records = list(records)
        self.index = np.arange(len(self.records))
        self.transformers: List[Transformer] = list(transformers or [])

    def size(self) -> int:
        return len(self.records)

    def shuffle(self, rng: Optional[RandomGenerator] = None) -> None:
        (rng if rng is not None else RandomGenerator.RNG()).shuffle(
            self.index)

    def transform(self, transformer: Transformer) -> "LocalDataSet":
        ds = LocalDataSet.__new__(LocalDataSet)
        ds.records = self.records
        ds.index = self.index      # shared: shuffle() visible through views
        ds.transformers = self.transformers + [transformer]
        return ds

    def _raw(self, train: bool) -> Iterator:
        if train:
            # looped-infinite, re-reading the (possibly re-shuffled) index
            def gen():
                while True:
                    for i in self.index:
                        yield self.records[i]
            return gen()
        return (self.records[i] for i in self.index)

    def data(self, train: bool) -> Iterator:
        it = self._raw(train)
        for t in self.transformers:
            it = t(it)
        return it
