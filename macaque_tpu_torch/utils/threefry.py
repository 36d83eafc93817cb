"""JAX's default random stream (threefry2x32, partitionable layout) in NumPy.

The LM solver's Hutchinson probes are drawn from
``jax.random.rademacher(jax.random.fold_in(jax.random.PRNGKey(seed), it),
shape)``; the port draws the same signs on the host from these functions,
bit for bit, so that its solver takes the JAX package's steps. The trainers
draw the detection samplers' keys (``split``), their ranks (``uniform``)
and the autoencoder's initial weights (``normal``) the same way. They follow
``jax/_src/prng.py`` (``threefry_seed``, ``threefry_2x32``,
``_threefry_fold_in``, ``_threefry_split_foldlike``,
``_threefry_random_bits_partitionable``) and ``jax/_src/random.py``
(``_uniform``, ``_normal_real``, ``_bernoulli``, ``_rademacher``), as JAX
0.9.0 runs them with ``jax_threefry_partitionable`` on (its default).
"""

from __future__ import annotations

import numpy as np
import torch

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


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys, the hash words
    of the counts 0..num-1 (``_threefry_split_foldlike``)."""
    b1, b2 = _bits_pair(key, (int(num),))
    return np.stack([b1, b2], axis=-1)


def _random_bits(key, bit_width: int, shape):
    b1, b2 = _bits_pair(key, tuple(shape))
    if bit_width == 64:
        return (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)
    return b1 ^ b2


def uniform(key, shape, dtype=np.float32, minval=0.0, maxval=1.0
            ) -> np.ndarray:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` bit for bit:
    the top mantissa bits of a word of the float's width (``bits1 ^ bits2``
    for float32, ``bits1 << 32 | bits2`` for float64) under the exponent of
    1, minus 1, scaled into [minval, maxval). ``jax.random.uniform``'s
    default dtype is float32, float64 with ``jax_enable_x64`` on."""
    dtype = np.dtype(dtype)
    finfo = np.finfo(dtype)
    nbits, nmant = finfo.bits, finfo.nmant
    utype = np.dtype(f"uint{nbits}")
    bits = _random_bits(key, nbits, shape).astype(utype)
    one = np.array(1.0, dtype).view(utype)
    floats = ((bits >> utype.type(nbits - nmant)) | one).view(dtype) \
        - dtype.type(1.0)
    lo, hi = dtype.type(minval), dtype.type(maxval)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


def _fma(a, b, c):
    """a * b + c rounded once, as XLA fuses it: float32 through float64
    (the product is exact there, the sum rounded twice), float64 by
    error-free transformations (Dekker's product and Knuth's sum); both
    equal XLA's bit for bit on the tests' draws."""
    if a.dtype == np.float32:
        return (a.astype(np.float64) * np.float64(b) + np.float64(c)).astype(
            np.float32)
    a, b, c = np.float64(a), np.float64(b), np.float64(c)

    def halves(x):
        t = 134217729.0 * x                   # 2^27 + 1
        hi = t - (t - x)
        return hi, x - hi

    p = a * b
    (ah, al), (bh, bl) = halves(a), halves(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    return s + (((p - (s - bb)) + (c - bb)) + e)


def normal(key, shape, dtype=np.float32) -> np.ndarray:
    """``jax.random.normal(key, shape, dtype)``: ``sqrt(2) erfinv(u)`` with u
    uniform in (-1, 1) (bit for bit), the product computed in float64 and
    rounded once to ``dtype``. XLA evaluates erfinv with its own polynomial
    in ``dtype``, so the values are JAX's to within 128 ulp in float32 and
    4096 in float64 (in the tails; the median draw within 1), not bit for
    bit (``tests/test_torch_train_detection.py``)."""
    dtype = np.dtype(dtype)
    lo = np.nextafter(np.array(-1.0, dtype), np.array(0.0, dtype))
    u = uniform(key, shape, dtype, lo, 1.0)
    z = torch.erfinv(torch.from_numpy(u.astype(np.float64))).numpy()
    return (np.float64(np.array(np.sqrt(2), dtype)) * z).astype(dtype)
