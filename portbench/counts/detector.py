"""Operations of the detector on one frame, counted from shapes.

Multiply-adds of the matrix products and convolutions, twice (FLOP), of
Swin-S + FPN + RPN at the padded input and of the box head on the RoIs
it takes: the window attention on the padded map (both products of each
49-token window), the MLPs and the norms' neighbours on the map itself.
Layers the program runs in bfloat16 are counted under ``bf16``; the RPN's
two 1x1 outputs and the box head's two outputs, which it runs in float32,
under ``f32``. Not counted: resizing, normalization, norms, softmax,
RoIAlign, decoding and NMS (no matrix product).
"""

from __future__ import annotations


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def ops(c: dict, input_hw) -> dict:
    """``c``: the configuration's detector block; ``input_hw``: the padded
    network input. Returns {"bf16": FLOP, "f32": FLOP}."""
    H, W = input_hw[0] // c["patch_size"], input_hw[1] // c["patch_size"]
    e, w = c["embed_dim"], c["window"]
    bf16 = 2 * H * W * e * 3 * c["patch_size"] ** 2
    levels = []
    for s, depth in enumerate(c["depths"]):
        C = e * 2 ** s
        Np = _ceil(H, w) * w * _ceil(W, w) * w
        N = H * W
        hidden = int(C * c["mlp_ratio"])
        per_block = (2 * Np * C * 3 * C + 2 * 2 * Np * w * w * C
                     + 2 * Np * C * C + 2 * 2 * N * C * hidden)
        bf16 += depth * per_block
        levels.append((H, W, C))
        if s < len(c["depths"]) - 1:
            H, W = _ceil(H, 2), _ceil(W, 2)
            bf16 += 2 * H * W * 4 * C * 2 * C
    F = c["fpn_channels"]
    for h, wd, C in levels:
        bf16 += 2 * h * wd * C * F + 2 * h * wd * F * F * 9
    h, wd, _ = levels[-1]
    rpn_levels = [(a, b) for a, b, _ in levels] + [(_ceil(h, 2), _ceil(wd, 2))]
    f32 = 0
    for h, wd in rpn_levels:
        bf16 += 2 * h * wd * F * F * 9
        f32 += 2 * h * wd * F * (3 + 12)
    R = c["rcnn_roi_topk"]
    bf16 += 2 * R * F * 49 * 1024 + 2 * R * 1024 * 1024
    f32 += 2 * R * 1024 * (c["num_classes"] + 1 + 4 * c["num_classes"])
    return {"bf16": bf16, "f32": f32}
