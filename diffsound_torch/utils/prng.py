"""JAX's default PRNG in numpy: the threefry2x32 keys, splits and uniforms
that the JAX package draws its random material pairs from.

It reproduces `jax.random` bit for bit under the settings that package runs
with: the threefry2x32 implementation, `jax_threefry_partitionable` on (the
default since jax 0.5) and x64 on, under which `jax.random.uniform` draws
float64 by default.

    key = PRNGKey(0)              # uint32[2], as jax.random.PRNGKey(0)
    k0, k1 = split(key)           # as jax.random.split(key)
    u = uniform(k0, (16,))        # as jax.random.uniform(k0, (16,))
"""

from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the
    key (k0, k1): two uint32 arrays of x0's shape."""
    k0, k1 = (np.uint32(k) for k in np.asarray(key, np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    """The key of an integer seed: (seed >> 32, seed & 0xFFFFFFFF) of its
    64-bit two's complement, as uint32[2]."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & 0xFFFFFFFF], np.uint32)


def _counters(shape):
    """The 64-bit iota over `shape` as its (high, low) 32-bit words."""
    i = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """num new keys, uint32[num, 2]: key i is threefry2x32(key, (hi(i), lo(i)))."""
    b1, b2 = threefry2x32(key, *_counters((num,)))
    return np.stack([b1, b2], axis=-1)


def random_bits(key, shape) -> np.ndarray:
    """uint64 words: element i is bits1 << 32 | bits2 of
    threefry2x32(key, (hi(i), lo(i)))."""
    b1, b2 = threefry2x32(key, *_counters(tuple(shape)))
    return (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)


def uniform(key, shape=()) -> np.ndarray:
    """Float64 uniforms in [0, 1): the top 52 bits of a word fill the
    mantissa of a float in [1, 2), then 1 is subtracted."""
    bits = (random_bits(key, shape) >> np.uint64(12)) | np.array(1.0).view(np.uint64)
    return bits.view(np.float64) - 1.0
