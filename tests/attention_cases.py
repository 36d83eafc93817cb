"""Attention inputs whose value rows cancel, shared by the CPU test of the
hi/lo split of P (test_torch_attention.py) and the card test of K4
(test_torch_cuda.py). Imports neither JAX nor the JAX package."""

import numpy as np


def cancelling_qkv(seed, B, N, H, D, big=64.0, eps=0.005):
    """q, k, v (B, N, H, D) float32 with the keys in pairs: the two keys of
    a pair differ by ``eps`` times a normal draw, so their probabilities
    differ by about 0.5 % (one or two bf16 ulps) and round apart; their value
    rows are +-``big`` times a random sign plus a standard normal draw.
    The +-big parts cancel to within the pair's small difference in P, so
    the output is some 50-110 times smaller than max |v|, and an error of
    P relative to P reaches the output multiplied by that ratio."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, N, H, D))
    half = rng.normal(size=(B, N // 2, H, D))
    k = np.repeat(half, 2, axis=1)
    k[:, 1::2] += eps * rng.normal(size=half.shape)
    sign = big * rng.choice([-1.0, 1.0], size=half.shape)
    v = np.empty((B, N, H, D))
    v[:, 0::2] = sign + rng.normal(size=half.shape)
    v[:, 1::2] = -sign + rng.normal(size=half.shape)
    return [t.astype(np.float32) for t in (q, k, v)]
