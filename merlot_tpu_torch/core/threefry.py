"""JAX's default random bits (Threefry-2x32) in numpy, for the fixed draws
the port must reproduce exactly.

``jax.random`` with ``jax_threefry_partitionable`` on (JAX's default since
0.5): a key is a pair of uint32 words; ``fold_in(key, d)`` is
``threefry2x32(key, (0, d))``; 32-bit draws of a shape hash the element's
flat index i as the counter ``(i >> 32, i & 0xffffffff)`` and XOR the two
output words; ``uniform`` keeps the top 23 bits as the mantissa of a float
in [1, 2) and subtracts 1.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray) -> tuple:
    """Threefry-2x32 (20 rounds) of the counters (x0, x1) under key (k0, k1),
    elementwise over uint32 arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**32."""
    return (0, int(seed))


def fold_in(key, data: int) -> tuple:
    """``jax.random.fold_in(key, data)``."""
    y0, y1 = threefry2x32(key, np.array([0], np.uint32), np.array([data], np.uint32))
    return (int(y0[0]), int(y1[0]))


def random_bits32(key, n: int) -> np.ndarray:
    """The n uint32 draws of a flat shape (n,)."""
    i = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                          (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return y0 ^ y1


def uniform(key, n: int) -> np.ndarray:
    """``jax.random.uniform(key, (n,))``: fp32 in [0, 1)."""
    bits = (random_bits32(key, n) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)
