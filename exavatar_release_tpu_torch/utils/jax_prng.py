"""The JAX package's default random numbers in numpy: threefry-2x32 keys,
``split`` and float32 ``uniform`` with the partitionable counter layout
(``jax_threefry_partitionable``, the default since JAX 0.5), bit for bit.

The port draws its own numbers from ``torch.Generator``s. This module exists
for the one place where the draw itself is the point of comparison: the
convergence demo's initial weights, whose PSNR gain is held to the JAX
package's bars from the JAX package's starting point (``PRNGKey(seed)``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x1: np.ndarray, x2: np.ndarray):
    """Threefry-2x32 (20 rounds) of the counter words (x1, x2) under ``key``
    (2,) uint32: (y1, y2) uint32."""
    k1, k2 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [x1.astype(np.uint32) + ks[0], x2.astype(np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _counts(n: int):
    """The (hi, lo) words of a uint64 iota of length n."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s (2,) uint32 words, for 0 <= seed < 2^32."""
    if not 0 <= seed < 1 << 32:
        raise ValueError(f"seed {seed} outside [0, 2^32)")
    return np.asarray([0, seed], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32."""
    with np.errstate(over="ignore"):
        b1, b2 = threefry2x32(key, *_counts(num))
    return np.stack([b1, b2], axis=1)


def uniform(key: np.ndarray, shape: Sequence[int], minval, maxval) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    n = int(np.prod(shape, dtype=np.int64))
    with np.errstate(over="ignore"):
        b1, b2 = threefry2x32(key, *_counts(n))
    bits = (b1 ^ b2) >> np.uint32(32 - 23) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # XLA fuses floats * (hi - lo) + lo into one multiply-add with one
    # rounding; the float64 product of two float32 is exact
    scaled = (floats.astype(np.float64) * np.float64(hi - lo)
              + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled).reshape(tuple(shape))
