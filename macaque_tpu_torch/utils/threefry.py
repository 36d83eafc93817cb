"""JAX's default random stream (threefry2x32, partitionable layout) in NumPy.

The LM solver's Hutchinson probes are drawn from
``jax.random.rademacher(jax.random.fold_in(jax.random.PRNGKey(seed), it),
shape)``; the port draws the same signs on the host from these functions,
bit for bit, so that its solver takes the JAX package's steps. They follow
``jax/_src/prng.py`` (``threefry_seed``, ``threefry_2x32``,
``_threefry_fold_in``, ``_threefry_random_bits_partitionable``) and
``jax/_src/random.py`` (``_uniform``, ``_bernoulli``, ``_rademacher``).
"""

from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the count words ``x0, x1``
    (uint32 arrays of one shape) under ``key`` (two uint32)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s two words (a non-negative seed)."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of ``threefry_seed`` of
    ``data`` as uint32 (high word 0)."""
    a, b = threefry2x32(key, np.zeros(1, np.uint32),
                        np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([a[0], b[0]], np.uint32)


def _bits_pair(key, shape):
    """The two hash words of every element: the counts are the element's
    flat row-major index as a 64-bit (high, low) pair."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = threefry2x32(key, hi, lo)
    return b1.reshape(shape), b2.reshape(shape)


def rademacher(key, shape) -> np.ndarray:
    """``jax.random.rademacher(key, shape)`` with ``jax_enable_x64`` on, as
    float64 +-1. ``rademacher`` draws ``bernoulli(p=0.5)``, whose uniform
    takes the weak type of 0.5: with x64 a float64 from the 64-bit word
    ``bits1 << 32 | bits2``, so u < 0.5 exactly when the top bit of
    ``bits1`` is 0, which gives +1. (With x64 off JAX draws a float32 from
    ``bits1 ^ bits2``: another stream.)"""
    b1, _ = _bits_pair(key, tuple(shape))
    return np.where(b1 < np.uint32(1 << 31), 1.0, -1.0)
