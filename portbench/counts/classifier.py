"""Operations of the ID classifier on one crop, counted from shapes.

Twice the multiply-adds of ResNet's convolutions (bfloat16) and of its
linear head (float32) at the crop size: the 7x7 stem, then per
bottleneck the 1x1, the 3x3 (stride 2 on the first block of stages 2-4)
and the 1x1 expansion, and the 1x1 projection of each stage's first
block. Not counted: BatchNorm, ReLU, pooling, cropping, softmax.
"""

from __future__ import annotations

STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _out(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


def ops(c: dict) -> dict:
    S = _out(c["crop"], 7, 2, 3)
    bf16 = 2 * S * S * 64 * 3 * 49
    S = _out(S, 3, 2, 1)
    cin, ch = 64, 64
    for s, blocks in enumerate(STAGES[c["depth"]]):
        for b in range(blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            So = _out(S, 3, stride, 1)
            bf16 += 2 * (S * S * cin * ch + So * So * ch * ch * 9
                         + So * So * ch * 4 * ch)
            if b == 0:
                bf16 += 2 * So * So * cin * 4 * ch
            S, cin = So, 4 * ch
        ch *= 2
    return {"bf16": bf16, "f32": 2 * cin * c["num_classes"]}
