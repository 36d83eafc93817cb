"""Multi-head attention: the ViTPose blocks, the Swin windows, and unpacked
(B, N, H, D) attention.

``packed_attention`` computes softmax(Q K^T / sqrt(d)) V straight from the
qkv Dense output (B, N, 3C) and writes (B, N, C), the layout the output
projection reads. On a CUDA tensor it launches the hand-written kernel in
``csrc/packed_attention.cu`` (bf16, N = 192, d = 80: the ViTPose-huge
shapes) or raises; on a CPU tensor it runs ``packed_attention_reference``.
It replaces ``macaque_tpu/nn/pallas_attention.py::fused_attention_packed``.

``window_attention`` is the Swin window attention of the same file's
``fused_window_attention`` and ``fused_window_attention_blocked``: on a CUDA
tensor the kernel in ``csrc/window_attention.cu`` (49 tokens, d = 32: the
Swin-S shapes), on a CPU tensor ``window_attention_reference``.

``fused_attention`` and ``fused_attention_blocked`` are the same file's two
unpacked kernels (one grid step per batch element and head, or per batch
element with the heads in turn), and ``attention`` its dispatcher: all three
take, on a CUDA tensor, the one kernel in ``csrc/attention.cu`` (bf16,
N = 192, d = 80) with one block per (batch element, head) -- heads share no
K or V, so the TPU's head-blocked grid only idles SMs on the card -- and on a
CPU tensor ``attention_reference``.
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
    kernels.refuse_grad("packed_attention", qkv)
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
    kernels.launch(
        "packed_attention", "packed_attention", qkv.device,
        ctypes.c_void_p(qkv.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        B, N, heads, D, float(D ** -0.5))
    return out


def window_attention_reference(qkv, bias, mask, heads: int,
                               blocked: bool = True) -> torch.Tensor:
    """Plain version of the window kernel: qkv (B_, T, 3C), bias (heads, T, T)
    f32, mask (nW, T, T) f32 or None, window w masked by ``mask[w % nW]`` ->
    (B_, T, C) in qkv's dtype. ``S = (Q K^T) * scale + bias + mask`` (the
    scale applied after the dot) and the softmax in (at least) f32; with
    ``blocked`` the probabilities are rounded to the input dtype before
    P V (``fused_window_attention_blocked``), without it they stay f32
    (``fused_window_attention``)."""
    B_, T, C3 = qkv.shape
    C = C3 // 3
    D = C // heads
    acc = acc_dtype(qkv.dtype)
    q, k, v = qkv.reshape(B_, T, 3, heads, D).to(acc).permute(2, 0, 3, 1, 4)
    s = (q @ k.transpose(-1, -2)) * (D ** -0.5) + bias.to(acc)
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(B_ // nW, nW, heads, T, T)
             + mask.to(acc)[None, :, None]).reshape(B_, heads, T, T)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    if blocked:
        p = p.to(qkv.dtype).to(acc)
    out = p @ v                                   # (B_, heads, T, D)
    return out.transpose(1, 2).reshape(B_, T, C).to(qkv.dtype)


_WINDOW_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def window_attention(qkv, bias, mask, heads: int,
                     blocked: bool = True) -> torch.Tensor:
    """(B_, T, 3C) -> (B_, T, C) Swin window attention; the kernel on CUDA
    (float32 or bfloat16, T = 49, d = 32), the plain version on the CPU."""
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, bias, mask, heads, blocked)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {qkv.device}")
    kernels.refuse_grad("window_attention", qkv, bias, mask)
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"window_attention: bad qkv shape {tuple(qkv.shape)}"
                         f" for {heads} heads")
    B_, T, C3 = qkv.shape
    D = C3 // 3 // heads
    if qkv.dtype not in _WINDOW_DTYPES:
        raise TypeError(f"window_attention: kernel takes float32 or bfloat16, "
                        f"got {qkv.dtype}")
    if (T, D) != (49, 32):
        raise ValueError(f"window_attention: kernel built for T=49, d=32; "
                         f"got T={T}, d={D}")
    if not qkv.is_contiguous():
        raise ValueError("window_attention: qkv must be contiguous")
    if qkv.dtype == torch.bfloat16 and qkv.data_ptr() % 16:
        # the bf16 kernel stages qkv rows by 16-byte cp.async
        raise ValueError("window_attention: a bfloat16 qkv must start on a "
                         "16-byte boundary")
    if (bias.dtype != torch.float32 or tuple(bias.shape) != (heads, T, T)
            or not bias.is_contiguous() or bias.device != qkv.device):
        raise ValueError(f"window_attention: bias must be contiguous float32 "
                         f"({heads}, {T}, {T}) on {qkv.device}")
    n_mask = 0
    if mask is not None:
        n_mask = mask.shape[0]
        if (mask.dtype != torch.float32 or tuple(mask.shape) != (n_mask, T, T)
                or not mask.is_contiguous() or mask.device != qkv.device
                or B_ % n_mask):
            raise ValueError(f"window_attention: mask must be contiguous "
                             f"float32 (nW, {T}, {T}) with nW dividing {B_}")
    out = torch.empty((B_, T, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    if B_:
        kernels.launch(
            "window_attention", "window_attention", qkv.device,
            ctypes.c_void_p(qkv.data_ptr()), ctypes.c_void_p(bias.data_ptr()),
            ctypes.c_void_p(mask.data_ptr() if mask is not None else 0),
            ctypes.c_void_p(out.data_ptr()), B_, T, heads, D, n_mask,
            float(D ** -0.5), int(blocked), _WINDOW_DTYPES[qkv.dtype])
    return out


def attention_reference(q, k, v) -> torch.Tensor:
    """Plain version of the unpacked kernels: q, k, v (B, N, H, D) ->
    (B, N, H, D) in q's dtype, all of it in (at least) f32:
    ``S = (Q K^T) * scale`` (the scale after the dot), an f32 softmax, and
    P V with P kept in f32 (``_attn_kernel``)."""
    acc = acc_dtype(q.dtype)
    qh, kh, vh = (t.to(acc).transpose(1, 2) for t in (q, k, v))
    s = (qh @ kh.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return (p @ vh).transpose(1, 2).to(q.dtype)


def _unpacked_attention(q, k, v, name: str) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    kernels.refuse_grad(name, q, k, v)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must share one (B, N, H, D) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, N, H, D = q.shape
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise TypeError(f"{name}: kernel takes bfloat16, got {q.dtype}")
    if (N, D) != (192, 80):
        raise ValueError(f"{name}: kernel built for N=192, d=80; got N={N}, d={D}")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: q, k, v must be contiguous, 16-byte "
                             f"aligned and on {q.device}")
    out = torch.empty_like(q)
    if B and H:
        kernels.launch(
            "attention", "attention", q.device,
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            B, N, H, D, float(D ** -0.5), name=name)
    return out


def fused_attention(q, k, v) -> torch.Tensor:
    """(B, N, H, D) attention: the kernel on CUDA, the plain version on the
    CPU."""
    return _unpacked_attention(q, k, v, "fused_attention")


def fused_attention_blocked(q, k, v) -> torch.Tensor:
    """The JAX head-blocked entry point; on the card the same kernel and grid
    as ``fused_attention``."""
    return _unpacked_attention(q, k, v, "fused_attention_blocked")


def attention(q, k, v) -> torch.Tensor:
    """The dispatcher: the kernel on CUDA, the plain version on the CPU."""
    return _unpacked_attention(q, k, v, "attention")
