"""K5b, the int8 matmul of the serving pose's block Linear layers
(``csrc/quantize_rows.cu`` + ``csrc/int8_matmul.cu``): each call
quantizes the bf16 rows (K5a's device code as its first pass) and runs
the int8 GEMM with the dequantizing epilogue.

Per block and pose call, four launches (qkv, proj, fc1, fc2) with M = n G
rows. Bytes: x read once (bf16), the int8 weights, the float32 scales and
bias once, the bf16 output written once. Operations: 2 M N K on the int8
tensor cores. At ViTPose-huge's sizes the operations bound all four.
"""

from __future__ import annotations

from portbench.files import load_module
from portbench.peaks import INT8_OPS_PER_S, bound_seconds

KERNELS = ("int8_gemm_kernel", "quantize_rows_kernel")
LAUNCHES = "quant_int8_matmul"


def call_bound(M: int, K: int, N: int) -> tuple:
    n_bytes = M * K * 2 + N * K + N * 8 + M * N * 2
    return bound_seconds(n_bytes, 2 * M * N * K, INT8_OPS_PER_S)


def bound_s(c: dict, pose_calls: list) -> float:
    counts = load_module("counts/pose.py")
    gh, gw = counts.grid(c)
    layers = counts.block_layers(c).values()
    return sum(c["depth"] * call_bound(n * gh * gw, K, N)[0]
               for n in pose_calls for K, N in layers)
