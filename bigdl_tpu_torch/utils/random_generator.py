"""RandomGenerator: the seedable host-side generator of the data pipeline
(``bigdl_tpu/utils/random_generator.py`` :21-87, reference
``utils/RandomGenerator.scala:23``).

The port's own copy: numpy's MT19937, one instance per thread, so that one
seed gives both packages the same shuffles, crop offsets and flips.  The
draws are the reference's (``uniform``, ``normal``, ``bernoulli``,
``random_int``, ``permutation``, ``shuffle`` and the raw ``np`` state), made
in the same order from the same state.  Device-side randomness is a
``torch.Generator`` the caller passes; this class never touches torch's or
numpy's global generators.
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

    @classmethod
    def adopt(cls, inst: "RandomGenerator") -> None:
        """Install ``inst`` as this thread's generator: the hand-off of a
        single-producer worker (:class:`~bigdl_tpu_torch.engine.
        BatchPrefetcher`'s fetch thread), whose epoch reshuffles must
        continue the stream the constructing thread seeded.  A hand-off,
        not a share: numpy's ``RandomState`` is not thread-safe, so the
        thread that handed it over draws nothing from it meanwhile."""
        cls._tls.inst = inst

    def set_seed(self, seed: int) -> "RandomGenerator":
        self._seed = seed
        self._rng = np.random.RandomState(seed)
        return self

    def get_seed(self) -> int:
        return self._seed

    @property
    def np(self) -> np.random.RandomState:
        return self._rng

    def uniform(self, a: float = 0.0, b: float = 1.0) -> float:
        return float(self._rng.uniform(a, b))

    def normal(self, mean: float = 0.0, stdv: float = 1.0) -> float:
        return float(self._rng.normal(mean, stdv))

    def bernoulli(self, p: float = 0.5) -> bool:
        return bool(self._rng.uniform() <= p)

    def random_int(self, low: int, high: int) -> int:
        """Inclusive-exclusive [low, high)."""
        return int(self._rng.randint(low, high))

    def permutation(self, n: int) -> np.ndarray:
        return self._rng.permutation(n)

    def shuffle(self, arr) -> None:
        self._rng.shuffle(arr)
