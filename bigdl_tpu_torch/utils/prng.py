"""The threefry-2x32 counter PRNG of JAX's default ``jax.random`` keys, in
PyTorch ops (jax 0.9.0 ``jax/_src/prng.py``: ``threefry_seed`` :802,
``_threefry2x32_lowering`` :883, ``_threefry_split_foldlike`` :1156,
``_threefry_random_bits_partitionable`` :1184; ``jax/_src/random.py``
``_uniform`` :435).

It gives the bits of ``jax.random.PRNGKey``, ``jax.random.split`` and
``jax.random.uniform`` under JAX's default configuration
(``jax_default_prng_impl`` ``threefry2x32``, ``jax_threefry_partitionable``
True, ``jax_enable_x64`` False), batched over a leading vector of keys:
what :func:`~bigdl_tpu_torch.dataset.device_augment.color_jitter` draws
per record.

A key is an int64 tensor of shape ``(..., 2)`` holding the two uint32 words
of JAX's key data.  Every word lives in int64 and is masked to 32 bits after
each addition, so the arithmetic is uint32 arithmetic on any device; the
tensors stay on the seeds' device and nothing is read back to the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["prng_key", "split", "random_bits", "uniform", "threefry_2x32"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA          # Threefry's key-schedule constant
_ONE_F32_BITS = 0x3F800000    # the bits of float32 1.0


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry_2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                  x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds over broadcast uint32 words held in
    int64: the key ``(k1, k2)`` hashes the counter ``(x1, x2)``."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def prng_key(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a tensor of integer seeds: shape
    ``seed.shape + (2,)``.  The key is the seed's 64 bits as two words;
    with ``jax_enable_x64`` off JAX holds every seed as an int32, whose
    high word is 0 and whose low word is its two's complement, so a
    negative seed keeps its bits."""
    s = seed.to(torch.int64)
    hi = (s >> 32) & _MASK if seed.dtype == torch.int64 \
        else torch.zeros_like(s)
    return torch.stack([hi, s & _MASK], dim=-1)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)`` (the partitionable scheme): shape
    ``key.shape[:-1] + (n, 2)``.  Key ``i`` is the hash of the 64-bit
    counter ``i``, whose two words are the new key."""
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    k1, k2 = key[..., :1], key[..., 1:]
    b1, b2 = threefry_2x32(k1, k2, torch.zeros_like(counts), counts)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor) -> torch.Tensor:
    """32 random bits per key (``jax.random.bits(key, (), uint32)``, the
    partitionable scheme): the two words of the hash of counter 0, xored.
    Shape ``key.shape[:-1]``, values in [0, 2**32) as int64."""
    zero = torch.zeros_like(key[..., 0])
    b1, b2 = threefry_2x32(key[..., 0], key[..., 1], zero, zero)
    return b1 ^ b2


def _fma_f32(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as XLA's CPU backend computes
    it (it fuses the multiply and the add).  The product of two float32
    values is exact in float64; the sum is rounded to odd there (TwoSum
    gives its exact error), and a round-to-odd float64 rounds to the
    nearest float32 as the exact sum would."""
    p = a.to(torch.float64) * b
    s = p + c
    pb = s - p
    err = (p - (s - pb)) + (c - pb)
    bits = s.view(torch.int64)
    bits = torch.where(err * s < 0, bits - 1, bits)
    bits = torch.where(err != 0, bits | 1, bits)
    return bits.view(torch.float64).to(torch.float32)


def uniform(key: torch.Tensor, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (), float32, minval, maxval)`` per key, to
    the bit: the top 23 bits become the mantissa of a float32 in [1, 2),
    less 1, times ``maxval - minval`` (in float32) plus ``minval`` in one
    fused rounding, held at ``minval`` or above.  Shape
    ``key.shape[:-1]``, float32."""
    bits = random_bits(key)
    f = (((bits >> 9) | _ONE_F32_BITS).to(torch.int32)
         .view(torch.float32)) - 1.0
    # float32 scalars, exact as Python floats: no host-to-device copy
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(lo))
    return torch.clamp(_fma_f32(f, scale, lo), min=lo)
