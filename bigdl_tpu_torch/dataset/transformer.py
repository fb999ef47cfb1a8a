"""Transformer: composable iterator-to-iterator data transforms
(``bigdl_tpu/dataset/transformer.py`` :19-105; reference
``dataset/Transformer.scala:44``).  Chaining composes with ``>>`` (or
``chain``)."""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional

from bigdl_tpu_torch.dataset.sample import MiniBatch, PaddingParam, Sample


class Transformer:
    """Base: subclasses implement ``__call__(iterator) -> iterator``."""

    def __call__(self, it: Iterator) -> Iterator:
        raise NotImplementedError(type(self).__name__)

    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        return ChainedTransformer(self, other)

    def chain(self, other: "Transformer") -> "ChainedTransformer":
        """The reference's ``prev -> next``."""
        return self >> other

    def apply_single(self, item):
        """Run on one element."""
        return next(iter(self([item])))


class ChainedTransformer(Transformer):
    """(reference ``ChainedTransformer``, ``dataset/Transformer.scala:86``)."""

    def __init__(self, *stages: Transformer):
        flat: List[Transformer] = []
        for s in stages:
            if isinstance(s, ChainedTransformer):
                flat.extend(s.stages)
            else:
                flat.append(s)
        self.stages = flat

    def __call__(self, it: Iterator) -> Iterator:
        for s in self.stages:
            it = s(it)
        return it


class Identity(Transformer):
    def __call__(self, it: Iterator) -> Iterator:
        return iter(it)


class FuncTransformer(Transformer):
    """Wrap a per-element function."""

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def __call__(self, it: Iterator) -> Iterator:
        return (self.fn(x) for x in it)


class SampleToMiniBatch(Transformer):
    """Group a Sample stream into MiniBatches (reference
    ``SampleToMiniBatch``, ``dataset/Transformer.scala:309``).

    ``total_batch`` is the global batch size; each iterator's batch is
    ``total_batch / partition_num``, as the reference divides per partition
    (``dataset/Utils.scala:25``).  An incomplete trailing batch is emitted
    (the looped training iterator never produces one).  Ragged samples are
    padded by ``feature_padding``/``label_padding``
    (:class:`~bigdl_tpu_torch.dataset.sample.PaddingParam`; without one, to
    the longest of the batch with zeros)."""

    def __init__(self, total_batch: int, partition_num: int = 1,
                 feature_padding: Optional[PaddingParam] = None,
                 label_padding: Optional[PaddingParam] = None):
        if total_batch % partition_num != 0:
            raise ValueError(
                f"total batch size {total_batch} must be divisible by "
                f"partition number {partition_num} (reference "
                "dataset/Utils.scala:25)")
        self.batch_per_partition = total_batch // partition_num
        self.feature_padding = feature_padding
        self.label_padding = label_padding

    def __call__(self, it: Iterator[Sample]) -> Iterator[MiniBatch]:
        buf: List[Sample] = []
        for s in it:
            buf.append(s)
            if len(buf) == self.batch_per_partition:
                yield MiniBatch.from_samples(buf, self.feature_padding,
                                             self.label_padding)
                buf = []
        if buf:
            yield MiniBatch.from_samples(buf, self.feature_padding,
                                         self.label_padding)


#: the reference's older name
SampleToBatch = SampleToMiniBatch
