"""Operations of the pose network on one crop, counted from shapes.

Twice the multiply-adds of ViTPose's products and convolutions: the patch
embedding, each block's qkv, the two attention products (Q K^T and P V),
proj, fc1 and fc2, the two 4x4 stride-2 deconvolutions (input pixels x
Cin x Cout x 16) and the final 1x1. With ``int8_blocks`` the four block
Linear layers run in int8 and are counted under ``int8``; the final 1x1
runs in float32; the rest in bfloat16. Not counted: norms, softmax, GELU,
cropping and decoding.
"""

from __future__ import annotations


def grid(c: dict) -> tuple:
    p, pad = c["patch_size"], c["patch_padding"]
    H, W = c["img_size"]
    return (H + 2 * pad - p) // p + 1, (W + 2 * pad - p) // p + 1


def block_layers(c: dict) -> dict:
    """(K, N) of each block Linear layer."""
    D = c["embed_dim"]
    hidden = int(D * c["mlp_ratio"])
    return {"qkv": (D, 3 * D), "proj": (D, D), "fc1": (D, hidden),
            "fc2": (hidden, D)}


def ops(c: dict) -> dict:
    gh, gw = grid(c)
    G, D = gh * gw, c["embed_dim"]
    bf16 = 2 * G * D * 3 * c["patch_size"] ** 2
    linear = sum(2 * G * K * N for K, N in block_layers(c).values())
    attn = 2 * 2 * G * G * D
    int8 = 0
    if c.get("int8_blocks"):
        int8 = c["depth"] * linear
        bf16 += c["depth"] * attn
    else:
        bf16 += c["depth"] * (linear + attn)
    h, w, cin = gh, gw, D
    for ch in c["deconv_channels"]:
        bf16 += 2 * h * w * cin * ch * 16
        h, w, cin = 2 * h, 2 * w, ch
    f32 = 2 * h * w * cin * c["num_keypoints"]
    return {"bf16": bf16, "int8": int8, "f32": f32}
