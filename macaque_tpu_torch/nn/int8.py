"""Dynamic int8 quantization and the int8 matmul of the serving tiers.

Replaces ``macaque_tpu/nn/pallas_int8.py``. Scheme (``nn/quant.py``):
per-row activation scale ``s = max(max|x|, 1e-8) * (1/127)``, codes
``round(x / s)`` (half to even) clipped to +-127, int8 x int8 -> int32
products against per-output-channel weight codes, and the dequantization
``fma(acc * s, wscale, bias)`` in float32, cast once to the output dtype.

Three wrappers, each with its plain version:
  * ``quantize_rows`` (x (M, K) -> int8 codes (M, K), f32 scales (M, 1)):
    the kernel in ``csrc/quantize_rows.cu`` (K5a);
  * ``quant_int8_matmul``: quantization, dot and epilogue in one call,
    ``csrc/int8_matmul.cu`` (K5b: the row quantizer, then a cp.async-fed
    int8 GEMM); it replaces both Pallas kernels (weights-resident and
    tiled), which compute one function;
  * ``quant_int8_matmul_split``: K5a, then the int8 dot outside any kernel
    (``torch._int_mm``, as the JAX package leaves that dot to XLA) and the
    epilogue in plain PyTorch.

The weight is held as ``weight_q`` int8 (N, K): the JAX ``kernel_q`` (K, N)
transposed, so that K is contiguous for the tensor cores' B operand. On a
CPU tensor each wrapper computes its plain version; on a CUDA tensor it
launches its kernel or raises. The int32 dot of the plain versions runs in
float64, which is exact (|acc| <= 127^2 * K < 2^53), so kernel and plain
version agree bitwise.
"""

from __future__ import annotations

import ctypes

import torch

from macaque_tpu_torch import kernels

# the JAX package's constants as float32 (a Python float meets a float32
# array there and is rounded to float32)
_INV127 = 1.0 / 127.0
_EPS = 1e-8


def quantize_rows_reference(x: torch.Tensor):
    """x (M, K) float -> (codes int8 (M, K), scales f32 (M, 1))."""
    xf = x.to(torch.float32)
    s = xf.abs().amax(-1, keepdim=True).clamp_min(_EPS) * _INV127
    q = torch.round(xf / s).clamp(-127, 127).to(torch.int8)
    return q, s


def int_dot_reference(xq: torch.Tensor, weight_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> (M, N) int32, exactly (float64)."""
    return (xq.to(torch.float64) @ weight_q.to(torch.float64).T).to(torch.int32)


def fma_f32(a, b, c) -> torch.Tensor:
    """``a * b + c`` of float32 tensors with one rounding, as a fused
    multiply-add rounds it. The product is exact in float64; the sum is
    rounded to odd there (53 >= 24 + 2 bits), so the final rounding to
    float32 is the correctly rounded one."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    r = p + c
    t = r - p                                   # TwoSum: r + err == p + c
    err = (p - (r - t)) + (c - t)
    odd = (r.view(torch.int64) & 1) == 1
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    r = torch.where((err != 0) & ~odd, torch.nextafter(r, toward), r)
    return r.to(torch.float32)


def dequantize(acc, s, wscale, bias, dtype) -> torch.Tensor:
    """``(acc * s) * wscale (+ bias)`` in float32, then one cast to ``dtype``
    (the epilogue of the fused kernel and of the split scheme). The JAX
    kernels' epilogue, as XLA compiles it, contracts the last multiply and
    the bias add into one fused multiply-add; so does this one."""
    out = acc.to(torch.float32) * s
    if bias is None:
        return (out * wscale).to(dtype)
    return fma_f32(out, wscale, bias).to(dtype)


def quant_int8_matmul_reference(x, weight_q, wscale, bias=None, out_bias=None):
    """Plain version of ``quant_int8_matmul``: x (..., K) float; weight_q
    (N, K) int8; wscale (N,) f32; bias (N,) f32 or None, joined in float32
    before the cast; out_bias (N,) f32 or None, added after the cast in
    x.dtype -> (..., N) in x.dtype."""
    lead, K = x.shape[:-1], x.shape[-1]
    xq, s = quantize_rows_reference(x.reshape(-1, K))
    out = dequantize(int_dot_reference(xq, weight_q), s, wscale, bias, x.dtype)
    if out_bias is not None:
        out = out + out_bias.to(out.dtype)
    return out.reshape(*lead, weight_q.shape[0])


def _check_cuda(name, x, K):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    kernels.refuse_grad(name, x)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: kernel takes bfloat16, got {x.dtype}")
    if K % 32:
        raise ValueError(f"{name}: kernel needs K % 32 == 0, got K={K}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous and 16-byte aligned")


def quantize_rows(x: torch.Tensor):
    """x (M, K) -> (codes int8 (M, K), scales f32 (M, 1)); the K5a kernel on
    CUDA (bfloat16, K % 32 == 0), the plain version on the CPU."""
    if x.device.type == "cpu":
        return quantize_rows_reference(x)
    M, K = x.shape
    _check_cuda("quantize_rows", x, K)
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    s = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    if M:
        err = kernels.library().macaque_quantize_rows(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(q.data_ptr()),
            ctypes.c_void_p(s.data_ptr()), M, K,
            kernels.current_stream(x.device))
        kernels.check(err, "quantize_rows")
        kernels.LAUNCHES["quantize_rows"] += 1
    return q, s


def _check_weights(name, weight_q, wscale, bias, K, device):
    """``bias`` stands for either bias (both are (N,) float32)."""
    N = weight_q.shape[0]
    if weight_q.dtype != torch.int8 or tuple(weight_q.shape) != (N, K):
        raise ValueError(f"{name}: weight_q must be int8 (N, {K}), got "
                         f"{weight_q.dtype} {tuple(weight_q.shape)}")
    if N % 8:
        raise ValueError(f"{name}: kernel needs N % 8 == 0, got N={N}")
    for t in (weight_q, wscale) + ((bias,) if bias is not None else ()):
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: weights must be contiguous on {device}")
    for t in (wscale,) + ((bias,) if bias is not None else ()):
        if t.dtype != torch.float32 or tuple(t.shape) != (N,):
            raise ValueError(f"{name}: wscale and bias must be float32 ({N},)")
    if weight_q.data_ptr() % 16:
        raise ValueError(f"{name}: weight_q must be 16-byte aligned")


def quant_int8_matmul(x, weight_q, wscale, bias=None, out_bias=None):
    """x (..., K) -> (..., N) in x.dtype: per-row dynamic quantization, the
    int8 matmul and the float32 epilogue; ``bias`` joins in float32 before
    the cast (the TPU kernel's function), ``out_bias`` after it, in x.dtype
    (the int8 layers' chain, ``nn/quant.py``); at most one of them. The K5b
    kernel on CUDA (bfloat16, K % 32 == 0, N % 8 == 0), the plain version
    on the CPU. On CUDA one C call runs two passes: the
    row quantizer (K5a's device code) into a workspace of int8 codes and
    f32 scales that this wrapper allocates, then the int8 GEMM over the
    codes; only ``LAUNCHES["quant_int8_matmul"]`` goes up, by one."""
    if bias is not None and out_bias is not None:
        raise ValueError("quant_int8_matmul: give bias or out_bias, not both")
    if x.device.type == "cpu":
        return quant_int8_matmul_reference(x, weight_q, wscale, bias, out_bias)
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    _check_cuda("quant_int8_matmul", x2, K)
    _check_weights("quant_int8_matmul", weight_q, wscale,
                   bias if out_bias is None else out_bias, K, x.device)
    M, N = x2.shape[0], weight_q.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M:
        # the codes and scales of the quantize pass, read by the GEMM
        xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
        xs = torch.empty((M,), dtype=torch.float32, device=x.device)
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        err = kernels.library().macaque_quant_int8_matmul(
            ptr(x2), ptr(weight_q), ptr(wscale),
            *(ctypes.c_void_p(b.data_ptr() if b is not None else 0)
              for b in (bias, out_bias)),
            ptr(xq), ptr(xs), ptr(out), M, N, K,
            kernels.current_stream(x.device))
        kernels.check(err, "quant_int8_matmul")
        kernels.LAUNCHES["quant_int8_matmul"] += 1
    return out.reshape(*lead, N)


def int_mm_epilogue(xq, s, weight_q, wscale, bias, dtype) -> torch.Tensor:
    """The int8 dot and the epilogue from PyTorch calls on CUDA:
    ``torch._int_mm`` (cuBLASLt; it needs more than 16 rows, so shorter
    inputs are padded with zero rows), then ``addcmul``, whose CUDA kernel
    rounds ``bias + p * wscale`` once (a fused multiply-add), as
    ``dequantize`` does; ``chip_smoke.py`` holds it to the plain version
    bit for bit."""
    M, K = xq.shape
    if M <= 16:
        xq = torch.cat([xq, xq.new_zeros((17 - M, K))])
    p = torch._int_mm(xq, weight_q.T)[:M].to(torch.float32) * s
    out = p * wscale if bias is None else torch.addcmul(bias, p, wscale)
    return out.to(dtype)


def quant_int8_matmul_split(x, weight_q, wscale, bias=None):
    """The split scheme: ``quantize_rows``, the int8 dot, the float32
    epilogue; the same function as ``quant_int8_matmul``. On CUDA the dot
    and the epilogue are PyTorch calls (``int_mm_epilogue``), as the JAX
    package leaves them to XLA."""
    lead, K = x.shape[:-1], x.shape[-1]
    xq, s = quantize_rows(x.reshape(-1, K))
    if x.device.type == "cpu":
        out = dequantize(int_dot_reference(xq, weight_q), s, wscale, bias,
                         x.dtype)
    else:
        _check_weights("quant_int8_matmul_split", weight_q, wscale, bias, K,
                       x.device)
        out = int_mm_epilogue(xq, s, weight_q, wscale, bias, x.dtype)
    return out.reshape(*lead, weight_q.shape[0])
