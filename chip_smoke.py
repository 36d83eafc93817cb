#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

Run from the repository root, with one CUDA device:

    python3 chip_smoke.py

Phases, one line each with elapsed seconds:
  1. device  - the card's name, count, and nvidia-smi's name/power limit;
  2. build   - every csrc/*.cu kernel through one nvcc call;
  3. kernels - each kernel against its plain PyTorch version at the shapes
               of the main path, on the card, with times (CUDA events);
  4. main    - stage 1 (detect -> track -> pose -> ID) through
               ``pipeline.step1.process_camera`` at full model width with
               random weights, over 2 chunks of 16 frames of 2048x1536,
               with every kernel's launch count read around the run: the
               parity configuration, then the ``serving`` tier (int8 pose)
               and the ``fast`` tier (int8 pose, no flip test, 640 detector
               target), then the parity detector with the Swin window
               attention kernel on one 16-frame chunk; each against its
               plain path.
The second-to-last line is a JSON object with one entry per kernel; the
last is ``{"ok": true, "device": {...}}``. Any failed phase raises, so the
script exits non-zero and prints no result; so it does without a CUDA
device. ``--phases device,build,kernels`` runs a subset;
``--phases device,build,kernels,main,profile`` adds a torch.profiler pass
over one chunk (device time by kernel, idle share, a chrome trace under
chiprun_out/).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

T0 = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
INT8_OPS_PER_S = 1979e12      # H100 SXM dense int8 tensor cores
F32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(n_bytes: float, n_flop: float, peak: float = BF16_FLOP_PER_S):
    """(least time in ms, what bounds it): the bytes moved once over the HBM
    rate against the operations over ``peak``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flop / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def exact(out, ref, name):
    """The int8 kernels must equal their plain versions bit for bit (exact
    int32 products, every rounding spelled out): tolerance 0."""
    torch.cuda.synchronize()
    same = all(torch.equal(o, r) for o, r in zip(out, ref)) \
        if isinstance(out, tuple) else torch.equal(out, ref)
    if not same:
        o, r = (out[0], ref[0]) if isinstance(out, tuple) else (out, ref)
        raise AssertionError(f"{name}: kernel differs from its plain version, "
                             f"max |d| {(o.float() - r.float()).abs().max().item()}")
    log(f"{name}: equal to its plain version bit for bit")
    return 0.0


def max_err(out, ref, name):
    """Max |kernel - plain|; fails above 2^-6 of the largest |plain| value:
    both round one f32 result to bf16, so they may differ by one bf16 ulp
    (<= 2^-7 relative) plus f32 reordering noise."""
    torch.cuda.synchronize()
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (out - ref).abs().max().item()
    tol = 2.0 ** -6 * max(ref.abs().max().item(), 1.0)
    log(f"{name}: max_abs_err {err:.3e} (tolerance {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


# ------------------------------------------------------------------ phases

def phase_device():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    log(f"device: {name} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no output", flush=True)
    return name, count


def phase_build():
    from macaque_tpu_torch import kernels

    t = time.perf_counter()
    path = kernels.build()
    log(f"build: {os.path.basename(path)} in {time.perf_counter() - t:.1f}s")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas " + line.strip(), flush=True)
    kernels.library()


def check_attention(gen):
    """K1 at the pose chunk's shape: 16 frames x 8 detections x 2 flips
    sequences of ViTPose-huge (N=192, 16 heads, d=80) packed qkv."""
    import torch.nn.functional as F
    from macaque_tpu_torch.nn.attention import (
        packed_attention, packed_attention_reference)

    B, N, H, D = 256, 192, 16, 80
    C = H * D
    qkv = torch.randn((B, N, 3 * C), generator=gen, device="cuda").to(
        torch.bfloat16)
    err = max_err(packed_attention(qkv, H), packed_attention_reference(qkv, H),
                  "packed_attention")
    ms = cuda_ms(lambda: packed_attention(qkv, H), reps=20)
    plain = cuda_ms(lambda: packed_attention_reference(qkv, H), reps=5)
    q, k, v = qkv.view(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), reps=20)
    n_bytes = qkv.numel() * 2 + B * N * C * 2
    b, by = bound_ms(n_bytes, 4.0 * B * H * N * N * D)
    log(f"packed_attention {tuple(qkv.shape)}: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {b:.4f} ms ({by})")
    return dict(name="packed_attention", route="cuda",
                source="macaque_tpu_torch/csrc/packed_attention.cu",
                replaces="macaque_tpu/nn/pallas_attention.py:137",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib)


def synthetic_rois(gen, B=16, R=1000, img_hw=(608, 800)):
    """RPN-like proposals: log-uniform scale 8..700 px, aspect 0.5..2,
    clipped to the padded 608x800 detector input."""
    u = lambda *s: torch.rand(s, generator=gen, device="cuda",  # noqa: E731
                              dtype=torch.float64)
    scale = torch.exp(np.log(8.0) + u(B, R) * np.log(700.0 / 8.0))
    ar = 0.5 * 4.0 ** u(B, R)
    w, h = scale * ar.sqrt(), scale / ar.sqrt()
    cx, cy = u(B, R) * img_hw[1], u(B, R) * img_hw[0]
    rois = torch.stack([(cx - w / 2).clamp(0, img_hw[1]),
                        (cy - h / 2).clamp(0, img_hw[0]),
                        (cx + w / 2).clamp(0, img_hw[1]),
                        (cy + h / 2).clamp(0, img_hw[0])], -1).float()
    wh = (rois[..., 2:] - rois[..., :2]).clamp_min(0)
    lvl = torch.floor(torch.log2((wh[..., 0] * wh[..., 1]).sqrt() / 56.0
                                 + 1e-6)).clamp(0, 3).long()
    return rois, lvl


def window_stats(calls):
    """(bytes, flop) that window-step calls need: the union of the canvas
    pixels their windows touch, read once; the matrices and indices read
    once; the outputs written once; 2*C*(7w^2 + 49w) FLOP per RoI."""
    canvas = calls[0][0]
    P, H0, W0, C = canvas.shape
    touched = torch.zeros(P * H0 * W0, dtype=torch.bool, device="cuda")
    n_bytes = n_flop = 0.0
    for _, plane, ys, xs, ky, kx in calls:
        R, _, w = ky.shape
        ar = torch.arange(w, device="cuda")
        y = ys.long().clamp(0, H0 - w)[:, None] + ar
        x = xs.long().clamp(0, W0 - w)[:, None] + ar
        touched[((plane.long()[:, None, None] * H0 + y[:, :, None]) * W0
                 + x[:, None, :]).reshape(-1)] = True
        n_bytes += 2 * ky.numel() * 4 + 3 * R * 4 + R * 49 * C * 2
        n_flop += 2.0 * C * R * (7 * w * w + 49 * w)
    return n_bytes + touched.sum().item() * C * 2, n_flop


def check_roialign(gen):
    """K2 on the detector's RoI head shapes: FPN levels 0-3 of 16 frames
    (152x200 .. 19x25, C=256 bf16), 1000 RoIs a frame; every window bucket,
    then the detector's own sequence (bucket-sorted 256-RoI chunks)."""
    from macaque_tpu_torch.nn.ops import _roi_level_canvas
    from macaque_tpu_torch.nn.roialign import (
        WINDOW_BUCKETS, roi_align_windows, roi_align_windows_reference,
        roi_window_buckets, window_inputs)

    B, C, strides = 16, 256, (4, 8, 16, 32, 64)
    sizes = [(152, 200), (76, 100), (38, 50), (19, 25)]
    feats = [torch.randn((B, h, w, C), generator=gen, device="cuda").to(
        torch.bfloat16) for h, w in sizes]
    canvas = _roi_level_canvas(feats)
    rois, lvl = synthetic_rois(gen, B)
    err = 0.0
    for w in WINDOW_BUCKETS:
        args = window_inputs(feats, rois, lvl, 7, strides, window=w,
                             canvas=canvas)
        err = max(err, max_err(roi_align_windows(*args),
                               roi_align_windows_reference(*args),
                               f"roi_align_windowed window {w}"))
        ms = cuda_ms(lambda: roi_align_windows(*args))
        plain = cuda_ms(lambda: roi_align_windows_reference(*args), reps=3)
        b, by = bound_ms(*window_stats([args]))
        log(f"roi_align_windowed {B}x1000 RoIs window {w}: kernel {ms:.4f} "
            f"ms, plain {plain:.4f} ms, bound {b:.4f} ms ({by})")

    # the detector's sequence: RoIs sorted by their exact bucket, 256 a chunk
    need = roi_window_buckets(feats, rois, lvl, 7, strides)
    order = torch.sort(need, dim=1, descending=True, stable=True).indices
    rois = torch.gather(rois, 1, order[..., None].expand(-1, -1, 4))
    lvl, need = torch.gather(lvl, 1, order), torch.gather(need, 1, order)
    calls = []
    for c0 in range(0, rois.shape[1], 256):
        w = WINDOW_BUCKETS[int(need[:, c0:c0 + 256].max())]
        calls.append(window_inputs(feats, rois[:, c0:c0 + 256],
                                   lvl[:, c0:c0 + 256], 7, strides, window=w,
                                   canvas=canvas))
    for i, args in enumerate(calls):
        err = max(err, max_err(roi_align_windows(*args),
                               roi_align_windows_reference(*args),
                               f"roi_align_windowed chunk {i}"))
    ms = cuda_ms(lambda: [roi_align_windows(*a) for a in calls])
    plain = cuda_ms(lambda: [roi_align_windows_reference(*a) for a in calls],
                    reps=3)
    b, by = bound_ms(*window_stats(calls))
    windows = [a[4].shape[-1] for a in calls]
    log(f"roi_align_windowed detector sequence {B}x1000 RoIs, windows "
        f"{windows}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{b:.4f} ms ({by})")
    return dict(name="roi_align_windowed", route="cuda",
                source="macaque_tpu_torch/csrc/roi_align_windowed.cu",
                replaces="macaque_tpu/nn/pallas_roialign.py:188",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=None)


# ViTPose-huge's block Dense layers on a pose chunk: 16 frames x 8 detections
# x 2 flips = 256 crops of 192 tokens with the flip test (the parity and
# serving tiers), 128 crops without it (the fast tier)
POSE_ROWS = 256 * 192
FAST_ROWS = 128 * 192
VIT_LAYERS = {"qkv": (1280, 3840), "proj": (1280, 1280), "fc1": (1280, 5120),
              "fc2": (5120, 1280)}


def int8_weights(gen, K, N):
    wq = torch.randint(-127, 128, (N, K), generator=gen, device="cuda",
                       dtype=torch.int8)
    ws = torch.rand(N, generator=gen, device="cuda") * 9e-3 + 1e-3
    b = torch.randn(N, generator=gen, device="cuda") * 0.1
    return wq, ws, b


def randn_bf16(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def check_quantize_rows(gen):
    """K5a at the main path's shapes: the inputs of qkv/proj/fc1 (K = 1280),
    which Int8Linear sends through the split route, on both tiers' pose
    chunks; also K = 5120 (fc2's input) for scale. The entry is one call at
    (49152, 1280)."""
    from macaque_tpu_torch.nn.int8 import quantize_rows, quantize_rows_reference

    entry = None
    for M, K in ((POSE_ROWS, 1280), (FAST_ROWS, 1280), (POSE_ROWS, 5120)):
        x = randn_bf16(gen, M, K)
        err = exact(quantize_rows(x), quantize_rows_reference(x),
                    f"quantize_rows ({M}, {K})")
        ms = cuda_ms(lambda: quantize_rows(x), reps=20)
        plain = cuda_ms(lambda: quantize_rows_reference(x), reps=5)
        # bf16 in, int8 + f32 scale out; |x|, max, divide, round, 2 clamps
        b, by = bound_ms(x.numel() * 3 + M * 4, 6.0 * x.numel(),
                         F32_FLOP_PER_S)
        log(f"quantize_rows ({M}, {K}): kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {b:.4f} ms ({by})")
        if entry is None:
            entry = dict(name="quantize_rows", route="cuda",
                         source="macaque_tpu_torch/csrc/quantize_rows.cu",
                         replaces="macaque_tpu/nn/pallas_int8.py:120",
                         max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                         bound_by=by, library_ms=None)
    return entry


def int8_library(x, wq, ws, b):
    """The same function from PyTorch calls: the quantize ops, torch._int_mm
    (cuBLASLt int8), the float32 epilogue (``addcmul``)."""
    from macaque_tpu_torch.nn.int8 import int_mm_epilogue, quantize_rows_reference

    xq, s = quantize_rows_reference(x)
    return int_mm_epilogue(xq, s, wq, ws, b, x.dtype)


def int8_bound(M, K, N):
    """x read once (bf16), weights, scales and bias once, output once."""
    return bound_ms(M * K * 2 + N * K + N * 8 + M * N * 2, 2.0 * M * N * K,
                    INT8_OPS_PER_S)


def check_int8_matmul(gen):
    """K5b against its plain version (bitwise) at the four ViTPose-huge layer
    shapes on both tiers' pose chunks (M = 49,152 and 24,576) and one Swin-S
    shape (stage-3 fc1, 384 -> 1536, 16 frames of 38x50 tokens); the split
    route likewise where K <= 2048. Per layer (log lines): K5b, the split
    route, the PyTorch chain around torch._int_mm, _int_mm alone and the bf16
    cuBLAS product. Then one block's four layers, each way, as one timed
    sequence. The entry is the call the main path makes: fc2 at M = 49,152
    (Int8Linear sends K = 1280 through the split route)."""
    import torch.nn.functional as F
    from macaque_tpu_torch.nn.int8 import (
        quant_int8_matmul, quant_int8_matmul_reference, quant_int8_matmul_split)
    from macaque_tpu_torch.nn.quant import Int8Linear

    shapes = [(name, M, K, N) for M in (POSE_ROWS, FAST_ROWS)
              for name, (K, N) in VIT_LAYERS.items()]
    shapes.append(("swin stage-3 fc1", 16 * 38 * 50, 384, 1536))
    block, entry = [], None
    for name, M, K, N in shapes:
        x = randn_bf16(gen, M, K)
        wq, ws, b = int8_weights(gen, K, N)
        exact(quant_int8_matmul(x, wq, ws, b),
              quant_int8_matmul_reference(x, wq, ws, b),
              f"quant_int8_matmul {name} M={M}")
        if K <= 2048:
            exact(quant_int8_matmul_split(x, wq, ws, b),
                  quant_int8_matmul_reference(x, wq, ws, b),
                  f"quant_int8_matmul_split {name} M={M}")
        if M == FAST_ROWS:
            continue
        ms = cuda_ms(lambda: quant_int8_matmul(x, wq, ws, b), reps=10)
        plain = cuda_ms(lambda: quant_int8_matmul_reference(x, wq, ws, b),
                        reps=2)
        lib = cuda_ms(lambda: int8_library(x, wq, ws, b), reps=10)
        xq = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                           dtype=torch.int8)
        int_mm = cuda_ms(lambda: torch._int_mm(xq, wq.T), reps=10)
        w16 = randn_bf16(gen, N, K)
        bf16 = cuda_ms(lambda: F.linear(x, w16), reps=10)
        line = (f"quant_int8_matmul {name} ({M}, {K}) x ({K}, {N}): kernel "
                f"{ms:.4f} ms, plain {plain:.4f} ms, torch quantize+_int_mm+"
                f"epilogue {lib:.4f} ms (_int_mm alone {int_mm:.4f} ms), bf16 "
                f"F.linear {bf16:.4f} ms")
        if K <= 2048:
            split = cuda_ms(lambda: quant_int8_matmul_split(x, wq, ws, b),
                            reps=10)
            line += f", split route {split:.4f} ms"
        bnd, by = int8_bound(M, K, N)
        log(f"{line}, bound {bnd:.4f} ms ({by})")
        if name == "fc2":
            entry = dict(name="quant_int8_matmul", route="cuda",
                         source="macaque_tpu_torch/csrc/int8_matmul.cu",
                         replaces="macaque_tpu/nn/pallas_int8.py:182",
                         max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bnd,
                         bound_by=by, library_ms=lib)
        if name in VIT_LAYERS:
            m = Int8Linear(K, N, device="cuda")
            m.weight_q, m.wscale, m.bias = wq, ws, b
            block.append((x, m, w16))

    # one block's four layers on distinct inputs, each way one timed sequence
    args = [(x, m.weight_q, m.wscale, m.bias) for x, m, _ in block]
    times = {
        "Int8Linear's routes": cuda_ms(lambda: [m(x) for x, m, _ in block]),
        "K5b": cuda_ms(lambda: [quant_int8_matmul(*a) for a in args]),
        "torch chain": cuda_ms(lambda: [int8_library(*a) for a in args]),
        "plain": cuda_ms(lambda: [quant_int8_matmul_reference(*a)
                                  for a in args], reps=2),
        "bf16 F.linear": cuda_ms(lambda: [F.linear(x, w) for x, _, w in block]),
    }
    bnd = sum(int8_bound(POSE_ROWS, K, N)[0] for K, N in VIT_LAYERS.values())
    log("int8 ViTPose-huge block, 4 layers at M=49152, each a sequence: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
        + f", bound {bnd:.4f} ms")
    return entry


# Swin-S on the parity input (608x800 padded frames, the trunk one frame at
# a time): per stage the token grid padded to multiples of 7, heads, blocks
SWIN_STAGES = [((154, 203), 3, 2), ((77, 105), 6, 2), ((42, 56), 12, 18),
               ((21, 28), 24, 2)]
CHUNK = 16                       # frames a detector call takes


def window_sdpa(qkv, bias, mask, heads):
    """The same function as one PyTorch call: scaled_dot_product_attention
    with the bias plus the shift mask as its additive mask."""
    import torch.nn.functional as F

    B_, T, C3 = qkv.shape
    q, k, v = qkv.view(B_, T, 3, heads, C3 // 3 // heads).permute(2, 0, 3, 1, 4)
    add = bias if mask is None else bias[None] + mask[:, None]
    nW = 1 if mask is None else mask.shape[0]
    shape = (B_ // nW, nW, heads, T, -1)
    out = F.scaled_dot_product_attention(
        q.reshape(shape), k.reshape(shape), v.reshape(shape),
        attn_mask=add.to(qkv.dtype))
    return out.reshape(B_, heads, T, -1).transpose(1, 2).reshape(B_, T, -1)


def check_window_attention(gen):
    """K3 at the four Swin-S stages of one parity detector frame (the trunk
    runs frame by frame), with and without the shift mask, in both
    precisions (f32 products and input-dtype products); then the sequence of
    a 16-frame detector call, built call by call and timed as one: 24 calls a
    frame (blocked variant, shift masks on the odd blocks), 384 in all, each
    on its own qkv, one bias per block. The entry is that sequence."""
    from macaque_tpu_torch.nn.attention import (
        window_attention, window_attention_reference)
    from macaque_tpu_torch.nn.swin import _shift_mask

    err = 0.0
    blocks, masks = [], []          # (bias, mask or None, heads, nW) per block
    for st, ((Hp, Wp), heads, depth) in enumerate(SWIN_STAGES):
        nW = (Hp // 7) * (Wp // 7)
        C = 32 * heads
        qkv = randn_bf16(gen, nW, 49, 3 * C)
        bias = torch.randn((heads, 49, 49), generator=gen, device="cuda") * 0.5
        mask = torch.as_tensor(_shift_mask(Hp, Wp, 7, 3), device="cuda")
        masks.append(mask)
        for j in range(depth):
            blocks.append((bias if j == 0 else torch.randn(
                (heads, 49, 49), generator=gen, device="cuda") * 0.5,
                mask if j % 2 else None, heads, nW))
        for masked in (False, True):
            m = mask if masked else None
            for blocked in (False, True):
                err = max(err, max_err(
                    window_attention(qkv, bias, m, heads, blocked),
                    window_attention_reference(qkv, bias, m, heads, blocked),
                    f"window_attention stage {st + 1} mask={masked} "
                    f"blocked={blocked}"))
                ms = cuda_ms(lambda: window_attention(qkv, bias, m, heads,
                                                      blocked), reps=10)
                log(f"window_attention stage {st + 1} ({nW}, 49, {3 * C}) "
                    f"mask={masked} blocked={blocked}: kernel {ms:.4f} ms "
                    "per call")

    calls = [(randn_bf16(gen, nW, 49, 96 * heads), bias, m, heads)
             for _ in range(CHUNK) for bias, m, heads, nW in blocks]
    for i, c in enumerate(calls[:len(blocks)]):       # the first frame's 24
        err = max(err, max_err(window_attention(*c),
                               window_attention_reference(*c),
                               f"window_attention sequence call {i}"))
    ms = cuda_ms(lambda: [window_attention(*c) for c in calls], reps=5)
    plain = cuda_ms(lambda: [window_attention_reference(*c) for c in calls],
                    reps=2, warmup=1)
    lib = cuda_ms(lambda: [window_sdpa(*c) for c in calls], reps=2, warmup=1)
    # every qkv read once and every output written once, the biases and
    # masks once; 2 products of 49x49x32 per window and head
    n_bytes = sum(q.numel() * 2 * 4 // 3 for q, *_ in calls) \
        + sum(b.numel() * 4 for b, *_ in blocks) \
        + sum(m.numel() * 4 for m in masks)
    n_flop = sum(4.0 * q.shape[0] * h * 49 * 49 * 32 for q, _, _, h in calls)
    b, by = bound_ms(n_bytes, n_flop, BF16_FLOP_PER_S)
    log(f"window_attention {CHUNK}-frame detector sequence ({len(calls)} "
        f"calls): kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} "
        f"ms, bound {b:.4f} ms ({by})")
    return dict(name="window_attention", route="cuda",
                source="macaque_tpu_torch/csrc/window_attention.cu",
                replaces="macaque_tpu/nn/pallas_attention.py:265",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib)


class MemoryStore:
    """In-memory stand-in for an imgstore reader: BGR uint8 frames with
    frame numbers and times (what ``process_camera`` reads)."""

    def __init__(self, frames: np.ndarray, fps: float = 24.0):
        self.frames = frames
        self.filename = "memory.cam0"
        self.fnums = np.arange(len(frames))
        self.ftimes = self.fnums / fps

    def get_frame_metadata(self):
        return {"frame_number": self.fnums.copy(),
                "frame_time": self.ftimes.copy()}

    def get_image(self, frame_number=None, frame_index=None):
        i = int(frame_index if frame_index is not None else frame_number)
        return self.frames[i], (int(self.fnums[i]), float(self.ftimes[i]))


def synthetic_frames(n: int, seed: int = 0, hw=(1536, 2048)) -> np.ndarray:
    """A blocky textured cage with four bright blobs drifting a few pixels
    a frame, drawn with numpy alone."""
    rng = np.random.default_rng(seed)
    H, W = hw
    base = np.kron(rng.integers(40, 200, (H // 32, W // 32, 3), dtype=np.uint8),
                   np.ones((32, 32, 1), np.uint8))
    yy, xx = np.mgrid[0:H, 0:W]
    blobs = [(rng.uniform(0.2, 0.8) * H, rng.uniform(0.2, 0.8) * W,
              rng.uniform(0.08, 0.17) * H, rng.uniform(0.04, 0.1) * W)
             for _ in range(4)]
    frames = np.empty((n, H, W, 3), np.uint8)
    for t in range(n):
        f = base.copy()
        for k, (cy, cx, ry, rx) in enumerate(blobs):
            cy, cx = cy + 3 * t * np.sin(k), cx + 4 * t * np.cos(k)
            y0, y1 = int(max(cy - ry, 0)), int(min(cy + ry, H))
            x0, x1 = int(max(cx - rx, 0)), int(min(cx + rx, W))
            m = (((yy[y0:y1, x0:x1] - cy) / ry) ** 2
                 + ((xx[y0:y1, x0:x1] - cx) / rx) ** 2) < 1.0
            f[y0:y1, x0:x1][m] = (230 - 40 * k, 180, 60 + 40 * k)
        frames[t] = f
    return frames


def check_alldata(out_dir):
    """alldata.json: 32 rows of well-formed entries, some animals tracked."""
    with open(os.path.join(out_dir, "alldata.json")) as f:
        rows = json.load(f)
    n_det = sum(len(r) for r in rows)
    if len(rows) != 32 or n_det == 0:
        raise AssertionError(f"alldata.json: {len(rows)} rows, {n_det} animals")
    for r in rows:
        for tid, x1, y1, x2, y2, kps, aid, asc in r:
            kp = np.asarray(kps, np.float64)
            seen = kp[:, 2] > 0
            if kp.shape != (17, 3) or not np.isfinite([x1, y1, x2, y2, asc]).all() \
                    or not (x2 > x1 and y2 > y1) or not np.isfinite(kp[seen]).all() \
                    or not np.isnan(kp[~seen, :2]).all() or not 0 <= asc <= 1:
                raise AssertionError(f"malformed alldata entry: {r}")
    return n_det, sum(np.sum(np.asarray(e[5])[:, 2] > 0) for r in rows for e in r)


def run_camera(name, perception, store, T, expect):
    """process_camera over the 32-frame camera, cold then warm; the warm
    pass's launches are counted and each kernel in ``expect`` must have
    launched. Returns those launches."""
    from macaque_tpu_torch import kernels
    from macaque_tpu_torch.core.config import Step1Config
    from macaque_tpu_torch.pipeline.step1 import process_camera

    out_dir = os.path.join(REPO, "chiprun_out", f"chip_smoke_{name}")
    for run in ("cold", "warm"):
        # the cold pass pays cuDNN/cuBLAS set-up and the allocator's growth;
        # the warm pass is the one whose launches are counted
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        stages = process_camera(store, out_dir, T, perception, Step1Config(),
                                chunk=16, redo=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(kernels.LAUNCHES)
        log(f"{name} ({run}): process_camera 32 frames in {wall:.3f}s "
            f"({32 / wall:.2f} camera-frames/s); stages "
            + " ".join(f"{k}={v:.4f}s" for k, v in stages.items())
            + f"; launches {launches}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    for k in expect:
        if launches[k] <= 0:
            raise AssertionError(f"{name}: main path never launched kernel {k}")
    n_det, n_kp = check_alldata(out_dir)
    log(f"{name}: alldata.json 32 rows, {n_det} animal entries, {n_kp} "
        "keypoints above threshold")
    return launches


def build_models(dev, bf16):
    """Stage 1's three models at full width, random weights from seed 0."""
    from macaque_tpu_torch.nn import (
        DetectorConfig, ResNetClassifier, ResNetConfig, SwinMaskRCNN,
        ViTPose, VitPoseConfig)
    from macaque_tpu_torch.nn.swin import SwinConfig

    torch.manual_seed(0)
    det = SwinMaskRCNN(DetectorConfig(swin=SwinConfig(compute_dtype=bf16),
                                      compute_dtype=bf16), device=dev)
    pose = ViTPose(VitPoseConfig(compute_dtype=bf16), device=dev)
    idm = ResNetClassifier(ResNetConfig(compute_dtype=bf16), device=dev)
    with torch.no_grad():
        # random box-head weights score nothing near the pipeline's 0.85
        # threshold; a raised foreground bias lets detections through (the
        # scores still vary with the RoI features, so they stay tie-free)
        det.roi_head.bbox_head.fc_cls.bias[0] += 6.0
    return det, pose, idm


def phase_main():
    """Stage 1 at full width: Swin-S Mask R-CNN (1000 proposals, 256-RoI
    chunks), ViTPose-huge with flip test, ResNet-152, max_det 8, bf16, on a
    2 x 16-frame 2048x1536 camera; then the serving tiers and the window
    attention kernel's detector on the same frames. Returns the launches of
    every counted run, by run."""
    from macaque_tpu_torch.pipeline.perception import TorchPerception

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    t = time.perf_counter()
    det, pose, idm = build_models(dev, bf16)
    perception = TorchPerception(det, pose, idm, max_det=8, device=dev)
    n_params = sum(p.numel() for m in (det, pose, idm) for p in m.parameters())
    torch.cuda.synchronize()
    log(f"main: models built on the card, {n_params / 1e6:.1f} M parameters, "
        f"{time.perf_counter() - t:.1f}s")

    t = time.perf_counter()
    frames = synthetic_frames(33)
    store = MemoryStore(frames)
    T = store.ftimes[:32]
    log(f"main: {len(frames)} frames of {frames.shape[1:]} drawn in "
        f"{time.perf_counter() - t:.1f}s")

    runs = {"parity": run_camera("step1", perception, store, T,
                                 ("packed_attention", "roi_align_windowed"))}
    check_plain_path(perception, frames[:2])
    runs.update(phase_tiers(det, pose, idm, store, T, frames[:2]))
    runs["k3_detector"] = phase_window_detector(det, pose, idm, frames[:CHUNK])
    return runs, perception, store, T


def check_plain_path(perception, frames):
    """The same full-width models on a small input (2 frames, 2 detections
    each) with both kernels swapped for their plain versions: detections
    and pose heatmaps must agree. K2 matches its plain version to the bit
    at these shapes, so the detections agree to float32 noise; K1 differs
    by bf16 rounding, which 32 bf16 residual blocks carry into the
    heatmaps, held to 2^-4 of their range."""
    from unittest import mock

    from macaque_tpu_torch.nn import detector, vit
    from macaque_tpu_torch.nn.attention import packed_attention_reference
    from macaque_tpu_torch.nn.preprocess import (
        bbox_to_center_scale, normalize_rgb, udp_crop)
    from macaque_tpu_torch.nn.roialign import roi_align_windowed_reference

    with torch.no_grad():
        boxes, scores = perception.detect(frames)
        rgb = torch.from_numpy(frames).cuda().flip(-1).float()
        c, s = bbox_to_center_scale(torch.from_numpy(boxes[:, :2]).cuda())
        crops = normalize_rgb(udp_crop(rgb, c, s)).reshape(-1, 256, 192, 3)
        hm = perception.pose_model(crops).float()
        with mock.patch.object(vit, "packed_attention",
                               packed_attention_reference), \
                mock.patch.object(detector, "roi_align_windowed",
                                  roi_align_windowed_reference):
            boxes_p, scores_p = perception.detect(frames)
            hm_p = perception.pose_model(crops).float()
    db = float(np.abs(boxes - boxes_p).max())
    ds = float(np.abs(scores - scores_p).max())
    dh = (hm - hm_p).abs().max().item()
    span = (hm_p.max() - hm_p.min()).item()
    log(f"plain path: detections |d box| {db:.3e} px, |d score| {ds:.3e}; "
        f"heatmaps |d| {dh:.3e} of range {span:.3e}")
    if not (np.isfinite(boxes).all() and torch.isfinite(hm).all()):
        raise AssertionError("non-finite outputs")
    if not (db <= 1e-2 and ds <= 1e-4 and dh <= 2.0 ** -4 * span):
        raise AssertionError("kernel path disagrees with the plain path")


def phase_tiers(det, pose, idm, store, T, frames):
    """The serving tiers on the same camera: ``serving`` (512/128 detector
    budgets, int8 pose) and ``fast`` (the serving detector at a 640 target,
    int8 pose, no flip test); the int8 pose's layers run K5a (the split route,
    K = 1280) and K5b (fc2, K = 5120). Then the int8 pose against its plain
    path."""
    import copy

    from macaque_tpu_torch.nn import DetectorConfig, SwinMaskRCNN
    from macaque_tpu_torch.nn.quant import quantize_vitpose_
    from macaque_tpu_torch.nn.swin import SwinConfig
    from macaque_tpu_torch.pipeline.perception import TorchPerception
    from macaque_tpu_torch.pipeline.weights import serving_tier

    bf16 = torch.bfloat16
    det_s = SwinMaskRCNN(DetectorConfig.serving(
        swin=SwinConfig(compute_dtype=bf16), compute_dtype=bf16),
        device=det.roi_head.bbox_head.fc_cls.bias.device)
    det_s.load_state_dict(det.state_dict())
    pose8 = quantize_vitpose_(copy.deepcopy(pose))
    runs = {}
    for name in ("serving", "fast"):
        tier = serving_tier(serving=True, fast=name == "fast")
        perception = TorchPerception(det_s, pose8, idm, max_det=8,
                                     det_target=tier.det_target,
                                     flip_test=tier.flip_test)
        log(f"{name} tier: det_target {tier.det_target}, flip test "
            f"{tier.flip_test}")
        runs[name] = run_camera(name, perception, store, T,
                                ("quantize_rows", "quant_int8_matmul"))
    check_int8_plain_path(pose8, frames, TorchPerception(
        det_s, pose8, idm, max_det=8))
    return runs


def check_int8_plain_path(pose, frames, perception):
    """The int8 pose on crops of ``frames`` with its int8 routes swapped for
    their plain version. K5a, K5b and the split route equal their plain
    versions bit for bit, and everything else is the same ops on the same
    inputs, so the heatmaps must agree to 2^-10 of their range (headroom for
    float32 reordering in the library's deconvolution)."""
    from unittest import mock

    from macaque_tpu_torch.nn import quant
    from macaque_tpu_torch.nn.int8 import quant_int8_matmul_reference
    from macaque_tpu_torch.nn.preprocess import (
        bbox_to_center_scale, normalize_rgb, udp_crop)

    with torch.no_grad():
        boxes, _ = perception.detect(frames)
        rgb = torch.from_numpy(frames).cuda().flip(-1).float()
        c, s = bbox_to_center_scale(torch.from_numpy(boxes[:, :2]).cuda())
        crops = normalize_rgb(udp_crop(rgb, c, s)).reshape(-1, 256, 192, 3)
        hm = pose(crops).float()
        with mock.patch.object(quant, "quant_int8_matmul",
                               quant_int8_matmul_reference), \
                mock.patch.object(quant, "quant_int8_matmul_split",
                                  quant_int8_matmul_reference):
            hm_p = pose(crops).float()
    dh = (hm - hm_p).abs().max().item()
    span = (hm_p.max() - hm_p.min()).item()
    log(f"int8 plain path: heatmaps |d| {dh:.3e} of range {span:.3e}")
    if not torch.isfinite(hm).all() or not dh <= 2.0 ** -10 * span:
        raise AssertionError("int8 kernel path disagrees with the plain path")


def phase_window_detector(det, pose, idm, frames):
    """The parity detector with SwinConfig(use_pallas_attention=True) on one
    16-frame chunk: the 24 window-attention calls of each frame's trunk
    launch K3; its detections are held against the same model with K3
    swapped for its plain version."""
    from unittest import mock

    from macaque_tpu_torch import kernels
    from macaque_tpu_torch.nn import DetectorConfig, SwinMaskRCNN, swin
    from macaque_tpu_torch.nn.attention import window_attention_reference
    from macaque_tpu_torch.nn.swin import SwinConfig
    from macaque_tpu_torch.pipeline.perception import TorchPerception

    bf16 = torch.bfloat16
    det_k = SwinMaskRCNN(DetectorConfig(
        swin=SwinConfig(compute_dtype=bf16, use_pallas_attention=True),
        compute_dtype=bf16), device=det.roi_head.bbox_head.fc_cls.bias.device)
    det_k.load_state_dict(det.state_dict())
    perception = TorchPerception(det_k, pose, idm, max_det=8)
    perception.detect(frames)                                 # warm-up
    with torch.no_grad():
        kernels.reset_launches()
        t = time.perf_counter()
        boxes, scores = perception.detect(frames)
        wall = time.perf_counter() - t
        launches = dict(kernels.LAUNCHES)
        with mock.patch.object(swin, "window_attention",
                               window_attention_reference):
            t = time.perf_counter()
            boxes_p, scores_p = perception.detect(frames)
            wall_p = time.perf_counter() - t
    log(f"k3 detector: detect {len(frames)} frames in {wall:.3f}s (plain window "
        f"attention {wall_p:.3f}s); launches {launches}")
    if launches["window_attention"] != 24 * len(frames):
        raise AssertionError("the detector did not launch K3 once per block "
                             "and frame")
    check_detections(boxes, scores, boxes_p, scores_p)
    return launches


def check_detections(boxes, scores, boxes_p, scores_p):
    """Detections through K3 against the plain path. K3 and its plain
    version round different f32 sums to bf16, so outputs differ by up to
    one bf16 ulp, which 24 bf16 blocks carry into the features: each frame
    must keep the same valid detections, matched one to one at IoU >= 0.9,
    with scores within 2^-6."""
    valid, valid_p = scores > 0, scores_p > 0
    worst_iou, worst_ds = 1.0, 0.0
    for f in range(len(scores)):
        if valid[f].sum() != valid_p[f].sum():
            raise AssertionError(f"frame {f}: {valid[f].sum()} detections "
                                 f"through K3, {valid_p[f].sum()} plain")
        a, b = boxes[f][valid[f]], boxes_p[f][valid_p[f]]
        lt = np.maximum(a[:, None, :2], b[None, :, :2])
        rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
        inter = np.prod(np.clip(rb - lt, 0, None), -1)
        area = lambda x: np.prod(x[:, 2:] - x[:, :2], -1)  # noqa: E731
        iou = inter / (area(a)[:, None] + area(b)[None] - inter)
        j = iou.argmax(1) if len(a) else np.zeros(0, int)
        if len(set(j.tolist())) != len(j):
            raise AssertionError(f"frame {f}: detections do not match one to one")
        if len(a):
            worst_iou = min(worst_iou, iou[np.arange(len(a)), j].min())
            worst_ds = max(worst_ds, np.abs(scores[f][valid[f]]
                                            - scores_p[f][valid_p[f]][j]).max())
    log(f"k3 plain path: detections matched, worst IoU {worst_iou:.4f}, "
        f"|d score| {worst_ds:.3e}")
    if not (worst_iou >= 0.9 and worst_ds <= 2.0 ** -6):
        raise AssertionError("K3 path disagrees with the plain path")


def phase_profile(perception, store, T):
    """One 16-frame chunk of process_camera under torch.profiler: device
    time by kernel, and device busy time against the wall clock."""
    from torch.profiler import ProfilerActivity, profile

    from macaque_tpu_torch.core.config import Step1Config
    from macaque_tpu_torch.pipeline.step1 import process_camera

    out_dir = os.path.join(REPO, "chiprun_out", "chip_smoke_profile")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        process_camera(store, out_dir, T[:16], perception, Step1Config(),
                       chunk=16, redo=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    # device-side events only (kernels, copies): the host ops that launched
    # them report the same device time again
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    log(f"profile: 16 frames in {wall:.3f}s wall, device busy {busy:.3f}s "
        f"(idle share {1 - busy / wall:.3f})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x "
              f"{e.key[:100]}", flush=True)
    prof.export_chrome_trace(os.path.join(REPO, "chiprun_out",
                                          "chip_smoke_trace.json"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="device,build,kernels,main")
    phases = ap.parse_args(argv).phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import macaque_tpu_torch  # noqa: F401  (fails outside the repository)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, count = phase_device()
    if "build" in phases:
        phase_build()
    entries = []
    if "kernels" in phases:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        entries = [check_attention(gen), check_roialign(gen),
                   check_quantize_rows(gen), check_int8_matmul(gen),
                   check_window_attention(gen)]
        torch.cuda.empty_cache()
    launches = {}
    if "main" in phases:
        runs, perception, store, T = phase_main()
        # each kernel's launches on the main paths, each run counted alone
        launches = {k: sum(r[k] for r in runs.values()) for k in runs["parity"]}
        log(f"launches on the main paths: {launches}")
        for k, n in launches.items():
            if n <= 0:
                raise AssertionError(f"no main path launched kernel {k}")
        if "profile" in phases:
            phase_profile(perception, store, T)
    for e in entries:
        e["launches"] = launches.get(e["name"], 0)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
