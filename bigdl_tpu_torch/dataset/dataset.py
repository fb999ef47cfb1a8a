"""DataSet: the training-data abstraction (``bigdl_tpu/dataset/dataset.py``
:34-93, ``ShardedDataSet`` :116-307; reference
``dataset/DataSet.scala:46,110,240-314``).

``LocalDataSet`` keeps the records in memory with a separately shuffled index
array: the training iterator loops over the index forever, and ``shuffle()``
permutes the index in place, so every transformed view of the dataset sees
each epoch's order.  The shuffle draws from the thread-local
:class:`~bigdl_tpu_torch.utils.random_generator.RandomGenerator`, so one seed
gives the JAX package's order.

``ShardedDataSet`` splits the records into ``partition_num`` partitions, one
per data-parallel rank.  Its shuffle permutes one global index as a pure
function of ``(RandomGenerator.RNG().get_seed(), round)`` with the JAX
package's seed arithmetic, so every rank (and the JAX package) derives the
same epoch order without exchanging anything; partition ``p`` streams the
slice ``index[p*per:(p+1)*per]``.  ``global_shuffle=False`` (or
``bigdl.elastic.globalShuffle=false``) keeps partition-local blocks instead,
each shuffled apart, pure in ``(seed, round, partition)``.

``DataSet`` is the factory namespace (reference ``object DataSet``,
``dataset/DataSet.scala:319-558``): in-memory arrays, SequenceFile folders
of JPEG records and label-per-directory image folders.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.utils import config
from bigdl_tpu_torch.utils.random_generator import RandomGenerator

logger = logging.getLogger("bigdl_tpu_torch")


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

    def __rshift__(self, transformer: Transformer) -> "AbstractDataSet":
        return self.transform(transformer)


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


class _ShardView(LocalDataSet):
    """One partition's window onto its :class:`ShardedDataSet`: the record
    list (shared, not copied) and a slice view of the parent's global
    index, which the parent permutes in place."""

    def __init__(self, records: Sequence[Any], index_view: np.ndarray,
                 transformers: Optional[List[Transformer]] = None):
        self.records = records
        self.index = index_view
        self.transformers = list(transformers or [])

    def size(self) -> int:
        return len(self.index)

    def transform(self, transformer: Transformer) -> "_ShardView":
        return _ShardView(self.records, self.index,
                          self.transformers + [transformer])


class ShardedDataSet(AbstractDataSet):
    """Partition-sharded dataset (reference ``CachedDistriDataSet``,
    ``dataset/DataSet.scala:240-314``): ``partition_num`` partitions of
    ``len(records) // partition_num`` records each (a remainder is
    dropped, ``dropped_records``, with a warning under the global
    shuffle).  A rank builds only its ``local_partitions`` (default: all)
    and reads them with :meth:`shard_data`; :meth:`size` is the global
    count, so epoch accounting agrees between ranks."""

    def __init__(self, records: Sequence[Any], partition_num: int,
                 transformers: Optional[List[Transformer]] = None,
                 local_partitions: Optional[Sequence[int]] = None,
                 global_shuffle: Optional[bool] = None):
        if global_shuffle is None:
            global_shuffle = config.get_bool("bigdl.elastic.globalShuffle",
                                             True)
        self.global_shuffle = bool(global_shuffle)
        self.partition_num = partition_num
        n = len(records)
        if n < partition_num:
            raise ValueError(f"{n} records < {partition_num} partitions")
        if local_partitions is None:
            local_partitions = range(partition_num)
        self.local_partitions = sorted(set(local_partitions))
        if not self.local_partitions or not all(
                0 <= p < partition_num for p in self.local_partitions):
            raise ValueError(
                f"local_partitions {self.local_partitions} must be a "
                f"non-empty subset of range({partition_num})")
        self._per = n // partition_num
        self.dropped_records = n - self._per * partition_num
        if self.global_shuffle and self.dropped_records:
            logger.warning(
                "ShardedDataSet drops %d remainder record(s) at "
                "partition_num=%d: the epoch permutation is over the "
                "truncated count, so the batch stream is NOT "
                "partition-count-invariant across a topology change",
                self.dropped_records, partition_num)
        self._shuffle_round = [0]      # shared by every transform() view
        self.shards: Dict[int, _ShardView] = {}
        if self.global_shuffle:
            self._records = list(records)
            #: the one global epoch permutation; shards hold slice views
            self.index = np.arange(self._per * partition_num)
            for p in self.local_partitions:
                view = self.index[p * self._per:(p + 1) * self._per]
                self.shards[p] = _ShardView(self._records, view,
                                            transformers)
        else:
            # partition-local: a shard keeps its own block of records only
            self._records = None
            self.index = None
            for p in self.local_partitions:
                block = list(records[p * self._per:(p + 1) * self._per])
                self.shards[p] = _ShardView(block, np.arange(self._per),
                                            transformers)

    def size(self) -> int:
        """The global record count, over every partition."""
        return self._per * self.partition_num

    def shuffle(self) -> None:
        """Permute the global index in place as a pure function of
        ``(RandomGenerator.RNG().get_seed(), round)``: each round starts
        from the identity order, so every rank, and any partition count,
        derives the same epoch order (reference aligned per-partition
        RNGs, ``dataset/DataSet.scala:262``)."""
        base = RandomGenerator.RNG().get_seed()
        self._shuffle_round[0] += 1
        rnd = self._shuffle_round[0]
        if not self.global_shuffle:
            for p, shard in self.shards.items():
                seed = (base + 0x9E3779B1 * rnd +
                        0x85EBCA77 * (p + 1)) % (2 ** 32)
                idx = np.arange(len(shard.index))
                np.random.RandomState(seed).shuffle(idx)
                shard.index[:] = idx
            return
        seed = (base + 0x9E3779B1 * rnd) % (2 ** 32)
        idx = np.arange(len(self.index))
        np.random.RandomState(seed).shuffle(idx)
        self.index[:] = idx     # in place: the shards' views follow

    def set_shuffle_round(self, round_: int) -> None:
        """Set the round counter: the next :meth:`shuffle` draws round
        ``round_ + 1``'s permutation."""
        self._shuffle_round[0] = int(round_)

    def transform(self, transformer: Transformer) -> "ShardedDataSet":
        ds = ShardedDataSet.__new__(ShardedDataSet)
        ds.__dict__.update(self.__dict__)
        ds.shards = {p: s.transform(transformer)
                     for p, s in self.shards.items()}
        return ds

    def shard_data(self, shard: int, train: bool) -> Iterator:
        if shard not in self.shards:
            raise ValueError(
                f"partition {shard} is not local to this process "
                f"(local_partitions={self.local_partitions})")
        return self.shards[shard].data(train)

    def data(self, train: bool) -> Iterator:
        """The local partitions' streams interleaved, one element each in
        turn (the training stream loops; the evaluation one ends with the
        last partition's last element)."""
        its = [self.shards[p].data(train) for p in self.local_partitions]
        if train:
            while True:
                for it in its:
                    yield next(it)
        live = list(its)
        while live:
            for it in list(live):
                try:
                    yield next(it)
                except StopIteration:
                    live.remove(it)


class DataSet:
    """Factory namespace (``bigdl_tpu/dataset/dataset.py`` :309-358,
    reference ``object DataSet``, ``dataset/DataSet.scala:319-558``)."""

    @staticmethod
    def array(records: Sequence[Any],
              partition_num: Optional[int] = None) -> AbstractDataSet:
        if partition_num is None or partition_num <= 1:
            return LocalDataSet(records)
        return ShardedDataSet(records, partition_num)

    @staticmethod
    def seq_file_folder(path: str, shards: Optional[int] = None,
                        decode: bool = True) -> LocalDataSet:
        """Every ``*.seq`` SequenceFile under ``path`` (reference
        ``SeqFileFolder.files``, ``dataset/DataSet.scala:500-558``), read
        through :class:`~bigdl_tpu_torch.dataset.ingest.ShardedSeqFileReader`
        (``shards`` reader threads, default ``bigdl.ingest.shards``; the
        records keep the sorted-walk order).  The records hold the
        compressed bytes (:class:`~bigdl_tpu_torch.dataset.image.
        LabeledImageBytes`).  With ``decode`` (the JAX package's behaviour)
        the dataset decodes them to BGR ``LabeledImage`` records on each pass;
        ``decode=False`` keeps the bytes, for a transformer that decodes
        them itself (``StreamingIngest``, ``MTLabeledBGRImgToBatch``)."""
        from bigdl_tpu_torch.dataset.image import BytesToBGRImg
        from bigdl_tpu_torch.dataset.ingest import ShardedSeqFileReader
        records = list(ShardedSeqFileReader(path, shards=shards))
        return LocalDataSet(records, [BytesToBGRImg()] if decode else [])

    @staticmethod
    def image_folder(path: str, scale_to: int = 256) -> LocalDataSet:
        """Label-per-subdirectory image tree (reference ``ImageFolder.paths``,
        ``dataset/DataSet.scala:419``): 1-based float labels in
        subdirectory sort order; records are
        records of :class:`~bigdl_tpu_torch.dataset.image.LocalImgPath`
        (decode them with ``LocalImgReader``).  ``scale_to`` is kept for the
        reference's signature."""
        import os
        from bigdl_tpu_torch.dataset.image import LocalImgPath
        classes = sorted(d for d in os.listdir(path)
                         if os.path.isdir(os.path.join(path, d)))
        records = []
        for label, cls in enumerate(classes, start=1):
            d = os.path.join(path, cls)
            for f in sorted(os.listdir(d)):
                if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                    records.append(LocalImgPath(os.path.join(d, f),
                                                float(label)))
        return LocalDataSet(records)
