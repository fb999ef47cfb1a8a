"""Sample and MiniBatch: the record and batch abstractions
(``bigdl_tpu/dataset/sample.py``: ``Sample`` :31, ``PaddingParam`` :66,
``MiniBatch`` :104; reference ``dataset/Sample.scala:31``,
``dataset/MiniBatch.scala:33,522-566``).

Records and batches stay host-side numpy; the trainer moves a batch to its
device as it takes it.  Ragged samples are padded to the longest of the
batch, or to a fixed length, by :class:`PaddingParam`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np


def _to_list(x) -> List[np.ndarray]:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return [np.asarray(t) for t in x]
    return [np.asarray(x)]


class Sample:
    """One record: feature array(s) + label array(s)
    (reference ``ArraySample``, ``dataset/Sample.scala:129``)."""

    __slots__ = ("features", "labels")

    def __init__(self, features, labels=None):
        self.features: List[np.ndarray] = _to_list(features)
        self.labels: List[np.ndarray] = _to_list(labels)

    @property
    def feature(self) -> np.ndarray:
        return self.features[0]

    @property
    def label(self) -> np.ndarray:
        return self.labels[0]

    def feature_size(self):
        return [f.shape for f in self.features]

    def label_size(self):
        return [l.shape for l in self.labels]

    def num_feature(self) -> int:
        return len(self.features)

    def num_label(self) -> int:
        return len(self.labels)

    def __repr__(self):
        return (f"Sample(features={[f.shape for f in self.features]}, "
                f"labels={[l.shape for l in self.labels]})")


class PaddingParam:
    """Padding of variable-length samples (reference
    ``dataset/MiniBatch.scala:522-566``): ``padding_value`` fills, and
    ``fixed_length`` gives per-dimension target lengths (None pads each
    dimension to the longest sample of the batch)."""

    def __init__(self, padding_value: float = 0.0,
                 fixed_length: Optional[Sequence[int]] = None):
        self.padding_value = padding_value
        self.fixed_length = fixed_length


def _stack_padded(arrays: List[np.ndarray],
                  param: Optional[PaddingParam]) -> np.ndarray:
    """Stack along a new batch dimension, padding ragged records."""
    shapes = {a.shape for a in arrays}
    if len(shapes) == 1 and (param is None or param.fixed_length is None):
        return np.stack(arrays)
    if param is None:
        param = PaddingParam()
    ndim = arrays[0].ndim
    longest = [max(a.shape[d] for a in arrays) for d in range(ndim)]
    if param.fixed_length is not None:
        for d, fl in enumerate(param.fixed_length[:ndim]):
            if fl is not None and fl > 0:
                if fl < longest[d]:
                    raise ValueError(
                        f"fixed_length {fl} < longest sample {longest[d]}")
                longest[d] = fl
    out = np.full([len(arrays)] + longest, param.padding_value,
                  dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[(i,) + tuple(slice(0, s) for s in a.shape)] = a
    return out


class MiniBatch:
    """A batch of samples (reference ``ArrayTensorMiniBatch``,
    ``dataset/MiniBatch.scala:33``).

    ``inputs``/``targets`` are lists of numpy arrays whose dim 0 is the batch
    dimension.  ``get_input()``/``get_target()`` return a single array when
    there is exactly one (the reference's Tensor-vs-Table Activity
    collapse)."""

    def __init__(self, inputs, targets=None):
        self.inputs: List[np.ndarray] = _to_list(inputs)
        self.targets: List[np.ndarray] = _to_list(targets)

    @staticmethod
    def from_samples(samples: Sequence[Sample],
                     feature_padding: Optional[PaddingParam] = None,
                     label_padding: Optional[PaddingParam] = None
                     ) -> "MiniBatch":
        n_feat = samples[0].num_feature()
        n_lab = samples[0].num_label()
        inputs = [_stack_padded([s.features[i] for s in samples],
                                feature_padding) for i in range(n_feat)]
        targets = [_stack_padded([s.labels[i] for s in samples],
                                 label_padding) for i in range(n_lab)]
        return MiniBatch(inputs, targets)

    def size(self) -> int:
        return self.inputs[0].shape[0] if self.inputs else 0

    @property
    def nbytes(self) -> int:
        """Host bytes the batch holds."""
        return int(sum(int(getattr(a, "nbytes", 0))
                       for a in self.inputs + self.targets))

    def slice(self, offset: int, length: int) -> "MiniBatch":
        """Sub-batch [offset, offset + length), 0-based."""
        return MiniBatch([a[offset:offset + length] for a in self.inputs],
                         [a[offset:offset + length] for a in self.targets])

    def get_input(self) -> Union[np.ndarray, List[np.ndarray]]:
        return self.inputs[0] if len(self.inputs) == 1 else self.inputs

    def get_target(self) -> Union[np.ndarray, List[np.ndarray]]:
        return self.targets[0] if len(self.targets) == 1 else self.targets

    def __repr__(self):
        return (f"MiniBatch(inputs={[a.shape for a in self.inputs]}, "
                f"targets={[a.shape for a in self.targets]})")
