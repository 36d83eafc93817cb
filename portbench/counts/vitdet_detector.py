"""Operations of the ViTDet-H detector on one frame, counted from shapes.

Multiply-adds of the matrix products and convolutions, twice (FLOP), of
the ViT backbone, the simple feature pyramid and the RPN at the square
input, and of the box head on the RoIs it takes:

* each block's qkv and output projections on the tokens it attends over
  (a window block's on the map zero-padded to whole windows), its MLP on
  the map itself;
* the attention's two products over each window (or the whole map), and
  the decomposed relative position's two factors, q . Rh and q . Rw, one
  product each over the grid's side;
* the pyramid's transposed convolutions, its 1x1 and 3x3 convolutions, the
  RPN's 3x3 convolutions and 1x1 outputs, the box head's four 3x3
  convolutions on 7x7 RoIs and its FC.

Under ``bf16`` what the program runs in bfloat16; under ``f32`` the
relative position factors and the RPN's and box head's outputs, which it
runs in float32. Not counted: resizing, normalization, norms, softmax,
the position embedding's resize, pooling, RoIAlign, decoding and NMS.
"""

from __future__ import annotations


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def ops(c: dict, input_hw) -> dict:
    """``c``: the configuration's detector block; ``input_hw``: the padded
    network input. Returns {"bf16": FLOP, "f32": FLOP}."""
    p, D, w = c["patch_size"], c["embed_dim"], c["window"]
    H, W = input_hw[0] // p, input_hw[1] // p
    N = H * W
    hidden = int(D * c["mlp_ratio"])
    bf16 = 2 * N * D * 3 * p * p
    f32 = 0
    for i in range(c["depth"]):
        if i in c["global_blocks"]:
            n_seq, gh, gw = 1, H, W
        else:
            n_seq, gh, gw = _ceil(H, w) * _ceil(W, w), w, w
        T = gh * gw
        tokens = n_seq * T
        bf16 += 2 * tokens * D * 3 * D + 2 * tokens * D * D
        bf16 += 2 * 2 * n_seq * T * T * D
        f32 += 2 * tokens * D * (gh + gw)
        bf16 += 2 * 2 * N * D * hidden
    F = c["fpn_channels"]
    # the pyramid's inputs: strides 4, 8, 16 and 32 (a 2x2 max pool)
    levels = [(4 * H, 4 * W, D // 4), (2 * H, 2 * W, D // 2), (H, W, D),
              (H // 2, W // 2, D)]
    # transposed convolutions 2x2 stride 2: to stride 4 (two), to stride 8
    bf16 += 2 * H * W * D * (D // 2) * 4
    bf16 += 2 * (2 * H) * (2 * W) * (D // 2) * (D // 4) * 4
    bf16 += 2 * H * W * D * (D // 2) * 4
    for h, wd, C in levels:
        bf16 += 2 * h * wd * C * F + 2 * h * wd * F * F * 9
    h, wd, _ = levels[-1]
    rpn_levels = [(a, b) for a, b, _ in levels] + [(_ceil(h, 2), _ceil(wd, 2))]
    for h, wd in rpn_levels:
        bf16 += c["rpn_convs"] * 2 * h * wd * F * F * 9
        f32 += 2 * h * wd * F * (3 + 12)
    R = c["rcnn_roi_topk"]
    bf16 += c["box_convs"] * 2 * R * 49 * F * F * 9 + 2 * R * F * 49 * 1024
    f32 += 2 * R * 1024 * (c["num_classes"] + 1 + 4 * c["num_classes"])
    return {"bf16": bf16, "f32": f32}
