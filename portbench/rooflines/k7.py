"""K7, the attention kernel with ViTDet's decomposed relative position
(``csrc/relpos_attention.cu``): softmax(Q K^T / sqrt(d) + rel_h + rel_w) V
straight from the packed qkv rows of one ViT block, bf16 in and out, the
two float32 factor tables read inside the tile.

One launch per block per detector call, over the chunk's n frames: a
window block's on n x (windows a frame) sequences of the window's w x w
tokens, a global block's on n sequences of the whole map's tokens. Bytes:
qkv read once and the output written once, bf16, and the tables rel_h and
rel_w, float32, (sequences, heads, T, grid side) each. Operations: the two
products, 4 sequences heads T^2 d, on the bf16 tensor cores. At ViTDet-H's
sizes the global blocks (T = 4,096) are bound by operations and the window
blocks (T = 196) by bytes.
"""

from __future__ import annotations

from portbench.peaks import BF16_FLOP_PER_S, bound_seconds

KERNELS = ("relpos_attention_kernel",)
LAUNCHES = "relpos_attention"


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def call_bound(n_seq: int, grid: int, heads: int, head_dim: int) -> tuple:
    """(least seconds, bound by) of one launch on ``n_seq`` sequences of a
    ``grid`` x ``grid`` token grid."""
    T, C = grid * grid, heads * head_dim
    n_bytes = 2 * (n_seq * T * 3 * C + n_seq * T * C) + 4 * 2 * n_seq * heads * T * grid
    n_ops = 4 * n_seq * heads * T * T * head_dim
    return bound_seconds(n_bytes, n_ops, BF16_FLOP_PER_S)


def block_calls(c: dict, input_hw) -> list:
    """(sequences a frame, grid side) of each block's launch."""
    H, W = input_hw[0] // c["patch_size"], input_hw[1] // c["patch_size"]
    w = c["window"]
    return [(1, H) if i in c["global_blocks"] else (_ceil(H, w) * _ceil(W, w), w)
            for i in range(c["depth"])]


def bound_s(c: dict, input_hw, calls: list) -> float:
    """The least seconds of every launch made by the detector ``calls``
    (frames of each call into the detector)."""
    heads, d = c["num_heads"], c["embed_dim"] // c["num_heads"]
    per_block = block_calls(c, input_hw)
    return sum(call_bound(n * s, g, heads, d)[0] for n in calls
               for s, g in per_block)
