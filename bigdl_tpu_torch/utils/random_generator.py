"""RandomGenerator: the seedable host-side generator of the data pipeline
(``bigdl_tpu/utils/random_generator.py``, reference
``utils/RandomGenerator.scala:23``).

The port's own copy: numpy's MT19937, one instance per thread, so that one
seed gives both packages the same shuffles.  It has what the port draws so
far (the dataset's shuffle, and the seed that ``ShardedDataSet``'s pure
per-round shuffle starts from); the reference's other draws come with the
transforms that use them.  Device-side randomness is a ``torch.Generator``
the caller passes; this class never touches torch's or numpy's global
generators.
"""

from __future__ import annotations

import threading

import numpy as np


class RandomGenerator:
    """Thread-local seedable generator (mirrors the reference RNG surface)."""

    _tls = threading.local()

    def __init__(self, seed: int = 5489):  # 5489 = MT19937 default, as in Torch
        self._seed = seed
        self._rng = np.random.RandomState(seed)

    @classmethod
    def RNG(cls) -> "RandomGenerator":
        """The thread-local instance (reference ``RandomGenerator.RNG``)."""
        inst = getattr(cls._tls, "inst", None)
        if inst is None:
            inst = cls()
            cls._tls.inst = inst
        return inst

    def set_seed(self, seed: int) -> "RandomGenerator":
        self._seed = seed
        self._rng = np.random.RandomState(seed)
        return self

    def get_seed(self) -> int:
        return self._seed

    def shuffle(self, arr) -> None:
        self._rng.shuffle(arr)
