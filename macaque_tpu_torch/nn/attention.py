"""Multi-head attention on the packed qkv activation (the ViTPose blocks).

``packed_attention`` computes softmax(Q K^T / sqrt(d)) V straight from the
qkv Dense output (B, N, 3C) and writes (B, N, C), the layout the output
projection reads. On a CUDA tensor it launches the hand-written kernel in
``csrc/packed_attention.cu`` (bf16, N = 192, d = 80: the ViTPose-huge
shapes) or raises; on a CPU tensor it runs ``packed_attention_reference``.
It replaces ``macaque_tpu/nn/pallas_attention.py::fused_attention_packed``.
"""

from __future__ import annotations

import ctypes

import torch

from macaque_tpu_torch import kernels
from macaque_tpu_torch.nn.layers import acc_dtype


def packed_attention_reference(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its numerics: products of
    the input dtype accumulated in (at least) f32, f32 softmax statistics,
    probabilities rounded to the input dtype before P V, output in the
    input dtype."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    D = C // heads
    acc = acc_dtype(qkv.dtype)
    q, k, v = (t.reshape(B, N, heads, D).transpose(1, 2).to(acc)
               for t in qkv.split(C, dim=-1))
    s = (q @ k.transpose(-1, -2)) * (D ** -0.5)
    p = torch.softmax(s, dim=-1).to(qkv.dtype).to(acc)
    out = p @ v                                   # (B, H, N, D)
    return out.transpose(1, 2).reshape(B, N, C).to(qkv.dtype)


def packed_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, 3C) -> (B, N, C) attention; the kernel on CUDA, the plain
    version on the CPU."""
    if qkv.device.type == "cpu":
        return packed_attention_reference(qkv, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"packed_attention: unsupported device {qkv.device}")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"packed_attention: bad qkv shape {tuple(qkv.shape)}"
                         f" for {heads} heads")
    B, N, C3 = qkv.shape
    D = C3 // 3 // heads
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"packed_attention: kernel takes bfloat16, got {qkv.dtype}")
    if (N, D) != (192, 80):
        raise ValueError(f"packed_attention: kernel built for N=192, d=80; "
                         f"got N={N}, d={D}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("packed_attention: qkv must be contiguous and 16-byte aligned")
    out = torch.empty((B, N, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    lib = kernels.library()
    err = lib.macaque_packed_attention(
        ctypes.c_void_p(qkv.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        B, N, heads, D, float(D ** -0.5), kernels.current_stream(qkv.device))
    kernels.check(err, "packed_attention")
    kernels.LAUNCHES["packed_attention"] += 1
    return out
