"""The JAX package's random bits, in numpy: threefry2x32 and the key
functions ``PRNGKey``, ``fold_in``, ``split``, ``random_bits`` and
``uniform`` (float32), so that the port draws the same bits from the same
seed without importing JAX.

The layout is ``jax_threefry_partitionable=True`` (JAX's default since
0.5): element i of a draw of shape s is threefry2x32(key, (hi(i), lo(i)))
of its flat index, split into two 32-bit words; ``random_bits`` XORs the
two output words, ``split`` keeps both as the new key. Keys are (2,)
uint32 arrays, as JAX's raw keys are.
"""

from __future__ import annotations

import numpy as np

__all__ = ["threefry2x32", "PRNGKey", "fold_in", "split", "random_bits",
           "uniform"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (Salmon et al., SC 2011) of the counter
    words (x0, x1) under the (2,) uint32 key, elementwise; JAX's
    ``threefry2x32_p``."""
    k0, k1 = (np.uint32(k) for k in np.asarray(key, np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0],
             np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (0, seed)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _counters(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The (hi, lo) words of the flat indices 0 .. n-1."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), \
        (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: threefry of the counter (0, data)."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.concatenate([y0, y1])


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split``: (num, 2) keys, key i threefry of counter i."""
    y0, y1 = threefry2x32(key, *_counters(num))
    return np.stack([y0, y1], axis=1)


def random_bits(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits an element: the XOR of the two words of threefry of
    the element's flat index."""
    y0, y1 = threefry2x32(key, *_counters(int(np.prod(shape))))
    return (y0 ^ y1).reshape(shape)


def uniform(key: np.ndarray, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under the
    exponent of 1.0, less 1, then ``f * (maxval - minval) + minval`` as one
    fused multiply-add (XLA's CPU code contracts the two), floored at
    minval. The FMA is computed in float64 and rounded once: f has 23
    significant bits and maxval - minval 24, so the product is exact, and
    so is the sum wherever minval's last bit lies within 53 bits of the
    sum's first (minval 0, or 1e-6 below maxval 1: 47 bits)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    f = bits.view(np.float32) - np.float32(1.0)
    fused = f.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, fused.astype(np.float32))
