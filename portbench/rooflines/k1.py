"""K1, the packed attention kernel of the ViT blocks
(``csrc/packed_attention.cu``): softmax(Q K^T / sqrt(d)) V straight from
the packed qkv rows of one block, bf16 in and out.

One launch per block per pose call, on qkv (n, G, 3 D) -> (n, G, D) with
n crops, G tokens, D = heads x head size. Bytes: qkv read once and the
output written once, bf16. Operations: the two products, 4 n heads G^2 d,
on the bf16 tensor cores. At ViTPose-huge's sizes the bytes bound it.
"""

from __future__ import annotations

from portbench.files import load_module
from portbench.peaks import BF16_FLOP_PER_S, bound_seconds

KERNELS = ("packed_attention_kernel",)
LAUNCHES = "packed_attention"


def call_bound(c: dict, n: int) -> tuple:
    """(least seconds, bound by) of one launch on ``n`` crops."""
    gh, gw = load_module("counts/pose.py").grid(c)
    G, D, heads = gh * gw, c["embed_dim"], c["num_heads"]
    n_bytes = 2 * (n * G * 3 * D + n * G * D)
    n_ops = 4 * n * heads * G * G * (D // heads)
    return bound_seconds(n_bytes, n_ops, BF16_FLOP_PER_S)


def bound_s(c: dict, pose_calls: list) -> float:
    """The least seconds of every launch made by ``pose_calls`` (crops of
    each call into the pose network)."""
    return sum(c["depth"] * call_bound(c, n)[0] for n in pose_calls)
