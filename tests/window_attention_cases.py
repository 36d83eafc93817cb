"""The K3 kernel's bf16 arithmetic (csrc/window_attention.cu) emulated in
float32 torch on its padded 64-row tile, and window inputs whose value rows
cancel; shared by the CPU tests (test_torch_window_attention.py) and the card
test of K3 (test_torch_cuda.py). Imports neither JAX nor the JAX package."""

import numpy as np
import torch

from attention_cases import cancelling_qkv

T, ROWS, KEYS = 49, 64, 56    # tokens; the padded tile; keys the scores cover
LOG2E = 1.4426950408889634


def padded_tile(qkv, bias, mask, heads, p_rounding):
    """What the kernel computes for every (window, head), in float32 torch:
    Q, K and V zero-padded to 64 rows; S = Q K^T over keys 0-55; for the 49
    real query rows S * scale + bias + mask (three f32 roundings, in that
    order) on the 49 real keys and -inf on keys 49-55; the row softmax as
    exp2(s * log2(e) - m * log2(e)) over the row maximum m, times the
    reciprocal of the row sum; P zero on keys 56-63; O = P V with P as
    ``p_rounding`` says ("bf16": rounded once; "split": bf16 hi + lo, each
    product summed in f32; "f32": kept); the padded query rows dropped.
    qkv (B_, 49, 3C) in any dtype, bias (heads, 49, 49), mask (nW, 49, 49)
    or None -> (B_, 49, C) in qkv's dtype."""
    B_, _, C3 = qkv.shape
    C = C3 // 3
    D = C // heads
    q, k, v = qkv.float().reshape(B_, T, 3, heads, D).permute(2, 0, 3, 1, 4)
    pad = lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, n - T))  # noqa: E731
    q, k, v = pad(q, ROWS), pad(k, KEYS), pad(v, ROWS)
    s = q @ k.transpose(-1, -2)                           # (B_, H, 64, 56)
    real = s[:, :, :T, :T] * np.float32(D ** -0.5) + bias.float()
    if mask is not None:
        nW = mask.shape[0]
        real = (real.reshape(B_ // nW, nW, heads, T, T)
                + mask.float()[None, :, None]).reshape(B_, heads, T, T)
    s[:, :, :T, :T] = real
    s[:, :, :, T:] = -float("inf")
    m = s.amax(-1, keepdim=True)
    e = torch.exp2(s * np.float32(LOG2E) - m * np.float32(LOG2E))
    p = e * (1.0 / e.sum(-1, keepdim=True))
    p = torch.nn.functional.pad(p, (0, ROWS - KEYS))      # keys 56-63: P = 0
    if p_rounding == "bf16":
        o = p.bfloat16().float() @ v
    elif p_rounding == "split":
        hi = p.bfloat16().float()
        o = hi @ v + (p - hi).bfloat16().float() @ v
    else:
        o = p @ v
    return o[:, :, :T].transpose(1, 2).reshape(B_, T, C).to(qkv.dtype)


def cancelling_window_qkv(seed, windows, heads, d=32):
    """qkv (windows, 49, 3 * heads * d) float32 and a bias (heads, 49, 49)
    whose keys come in pairs (tests/attention_cases.py::cancelling_qkv over
    50 tokens, the last dropped): the two keys of a pair score alike, the
    bias equal on both, and their value rows are +-64 plus a normal draw,
    so they cancel and the output is many times smaller than max |v|. The
    unpaired key 48 keeps only its normal draw."""
    q, k, v = cancelling_qkv(seed, windows, 50, heads, d)
    rng = np.random.default_rng(seed + 1)
    v[:, 48] = rng.normal(size=v[:, 48].shape)
    qkv = np.concatenate([t[:, :T].reshape(windows, T, heads * d)
                          for t in (q, k, v)], -1)
    half = rng.normal(0, 0.5, (heads, T, 25))
    bias = np.repeat(half, 2, axis=-1)[..., :T]
    return qkv.astype(np.float32), bias.astype(np.float32)
