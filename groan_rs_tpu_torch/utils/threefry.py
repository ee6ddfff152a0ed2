"""Seeded uniform draws equal to `jax.random.uniform` bit for bit, in numpy.

The JAX package draws its Monte Carlo points with
`jax.random.uniform(jax.random.PRNGKey(seed), shape, float32)`.  The port
has no jax, so it reproduces that draw on the host: the key of a seed is
(0, seed mod 2^32); element i of the flat output is Threefry-2x32
(20 rounds) of the counter (i >> 32, i & 0xFFFFFFFF) under that key, the
two output words XORed (JAX's partitionable Threefry, its default since
0.5); its top 23 bits become the mantissa of a float in [1, 2), minus 1.
"""

from __future__ import annotations

import numpy as np

__all__ = ["prng_key", "random_bits", "uniform"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> tuple[int, int]:
    """`jax.random.PRNGKey(seed)` as its two uint32 words, as JAX makes it
    without 64-bit types (its default): the seed taken modulo 2^32."""
    return 0, int(seed) & 0xFFFFFFFF


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _threefry2x32(key, x0, x1):
    """Threefry-2x32, 20 rounds, of the uint32 counter words `x0`, `x1`."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(key, shape) -> np.ndarray:
    """`jax.random.bits(key, shape)` (uint32) of a raw two-word key."""
    n = int(np.prod(shape, dtype=np.int64))
    i = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        b0, b1 = _threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                               (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (b0 ^ b1).reshape(shape)


def uniform(seed: int, shape) -> np.ndarray:
    """`jax.random.uniform(jax.random.PRNGKey(seed), shape, float32)`:
    float32 in [0, 1)."""
    bits = random_bits(prng_key(seed), shape)
    one = np.uint32(0x3F800000)
    return ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
