"""Sample and MiniBatch: the record and batch abstractions
(``bigdl_tpu/dataset/sample.py``: ``Sample`` :31, ``MiniBatch`` :104;
reference ``dataset/Sample.scala:31``, ``dataset/MiniBatch.scala:33``).

Records and batches stay host-side numpy; the trainer moves a batch to its
device as it takes it.  Samples of one batch must share their shapes: the
reference's padding of ragged samples (``PaddingParam``) is not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence, Union

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

    def num_feature(self) -> int:
        return len(self.features)

    def num_label(self) -> int:
        return len(self.labels)

    def __repr__(self):
        return (f"Sample(features={[f.shape for f in self.features]}, "
                f"labels={[l.shape for l in self.labels]})")


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
    def from_samples(samples: Sequence[Sample]) -> "MiniBatch":
        n_feat = samples[0].num_feature()
        n_lab = samples[0].num_label()
        inputs = [np.stack([s.features[i] for s in samples])
                  for i in range(n_feat)]
        targets = [np.stack([s.labels[i] for s in samples])
                   for i in range(n_lab)]
        return MiniBatch(inputs, targets)

    def size(self) -> int:
        return self.inputs[0].shape[0] if self.inputs else 0

    def get_input(self) -> Union[np.ndarray, List[np.ndarray]]:
        return self.inputs[0] if len(self.inputs) == 1 else self.inputs

    def get_target(self) -> Union[np.ndarray, List[np.ndarray]]:
        return self.targets[0] if len(self.targets) == 1 else self.targets

    def __repr__(self):
        return (f"MiniBatch(inputs={[a.shape for a in self.inputs]}, "
                f"targets={[a.shape for a in self.targets]})")
