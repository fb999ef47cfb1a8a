"""Transformer: composable iterator-to-iterator data transforms
(``bigdl_tpu/dataset/transformer.py`` :19-105; reference
``dataset/Transformer.scala:44``).  Chaining composes with ``>>`` (or
``chain``)."""

from __future__ import annotations

from typing import Iterator, List

from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample


class Transformer:
    """Base: subclasses implement ``__call__(iterator) -> iterator``."""

    def __call__(self, it: Iterator) -> Iterator:
        raise NotImplementedError(type(self).__name__)

    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        return ChainedTransformer(self, other)


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


class SampleToMiniBatch(Transformer):
    """Group a Sample stream into MiniBatches of ``batch_size``
    (reference ``SampleToMiniBatch``, ``dataset/Transformer.scala:309``).
    An incomplete trailing batch is emitted (the looped training iterator
    never produces one).  The per-partition split of a global batch comes
    with ``ShardedDataSet``."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size

    def __call__(self, it: Iterator[Sample]) -> Iterator[MiniBatch]:
        buf: List[Sample] = []
        for s in it:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield MiniBatch.from_samples(buf)
                buf = []
        if buf:
            yield MiniBatch.from_samples(buf)
