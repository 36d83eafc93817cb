#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

Run from the repository root, with one CUDA device:

    python3 chip_smoke.py

Phases, one line each with elapsed seconds:
  1. device  - the card's name, count, and nvidia-smi's name/power limit;
  2. build   - every csrc/*.cu kernel through one nvcc call;
  3. kernels - each kernel against its plain PyTorch version at the shapes
               of its path, on the card, with times (CUDA events; the
               K2 and K3 sequences, a serving-tier K2 call and K3's
               blocked bf16 stage calls also replayed from a CUDA graph,
               the device time without the host's launch cost); the
               tensor-core kernels (K1-K4, K5b, K6) with their registers
               and spills from the build log and their resident blocks
               per SM; the fused Swin block (K6) with the parity
               detector's own backbone weights; K2's route also against
               the exact RoIAlign by flat gather (``ops.roi_align_pyramid``)
               on the RoIs inside every level's extent;
  4. main    - stage 1 (detect -> track -> pose -> ID) through
               ``pipeline.step1.process_camera`` at full model width with
               random weights, over 2 chunks of 16 frames of 2048x1536,
               with every kernel's launch count read around the run: the
               parity configuration, then the ``serving`` tier (int8 pose)
               and the ``fast`` tier (int8 pose, no flip test, 640 detector
               target), then the parity detector with the Swin window
               attention kernel on one 16-frame chunk, then the int8
               serving detector (Swin blocks quantized, K5b at each of their
               Dense layers) on that chunk; each against its plain path;
               then ViTDet-H as the detector (K7) on the same camera.
               Then the three entry points of the JAX package's
               that drive the other kernels: the Swin-S trunk with every
               block fused (``nn.swin_block.swin_backbone_apply_fused``,
               K6) on one 16-frame detector chunk, against ``SwinBackbone``,
               the unpacked attention dispatcher
               (``nn.attention.attention``, K4) at the ViT-huge crop shape,
               and the split int8 matmul (``nn.int8.quant_int8_matmul_split``,
               K5a) at ViT-huge's fc1;
  5. step2   - step 2 (cross-view keyframe matching) through
               ``pipeline.step2.run_step2`` in float32 on the port's
               synthetic scene at the reference rig's size (8 cameras, 4
               animals, 48 detection slots a keyframe) over 4,800 frames
               (399 keyframes), with its time split, SVT iterations and
               peak memory; held against the ground truth, and its first
               96 keyframes card against CPU in float64;
  6. step3   - step 3 (cross-frame tracklet graph) through
               ``pipeline.step3.run_step3`` on step 2's output, float32:
               its split, flow solves and trace calls; every tracklet and
               identity held against the ground truth, and the first 600
               frames card against CPU in float64; then a scene whose
               tracks break (tests/test_torch_step3.py's: 4 cameras, 2
               animals, 200 frames), so that stitching solves flows and
               calls ``TraceCalculator``, float32 on the card against
               float64 on the CPU; then its trim scene (8 cameras, 4
               animals, 60 frames, two animals in two pieces each), so
               that ``trim_tracklets`` cuts, then ``build_stitch_graph``
               and ``stitch_tracklets`` on the trimmed set, float32 on the
               card against float64 on the CPU;
  7. step4   - step 4 (Viterbi 2D filter, DLT, LM-CGLS refinement)
               through ``pipeline.step4.run_step4`` on step 3's output,
               float32: its split, LM iterations, CG sweeps, host reads and
               peak memory; each animal's median joint error against the
               ground truth; the first 240 frames card against CPU in
               float64, and with TF32 matmuls allowed;
  8. pipeline - ``pipeline.runner.run_pipeline``, the whole pipeline from
               video to ``kp3d.pickle``: 8 RGBA imgstores of 640x480 (10
               s at 24 fps, 4 animals, written and read without cv2) through
               steps 1-4 with the oracle ``SyntheticPerception``, float32,
               render off (no cv2 on the card): every artifact, every
               tracklet one animal's, median joint errors, a second call
               that skips every stage, ``tools.visualize.overlay_points``
               card against CPU, the RGBA reader's frames; then 32 frames
               of 2048x1536 from an RGBA store through ``run_step1`` and
               the parity networks (K1 and K2 counted around the call),
               rows equal to ``process_camera`` on the same frames;
  9. tracker - the on-device tracker (``tracking/device_tracker.py``):
               ``track_chunk_device`` on the card (float32) against the CPU
               (float64) over 10 chunks of 32 frames of an 8-animal scene's
               oracle detections, then ``run_step1`` on the pipeline
               scene's stores with the device tracker and with the host
               tracker: seconds per chunk, the assignment's host reads,
               every track one animal's;
 10. eval2d  - the evaluation and 2D tools: (a) ``tools/run2d.pose_2d_frames``
               on 32 frames of 2048x1536 in chunks of 16 through the
               parity networks (K1 and K2 counted around the calls); (b)
               ``tools/coco_eval.coco_eval_arrays`` with the oracle on
               tests/test_coco_eval.py's 24 images drawn with numpy, then
               the parity networks on 8 of them scaled to 2048x1536; (c)
               ``tools/sweep.run_synthetic_sweep`` on the card in float32,
               two grid points of 60 frames x 4 cameras; (d)
               ``association/pictorial.py`` on the card against the port's
               native C++ oracle (g++); (e) only K1 and K2 launched;
 11. train   - the trainers (``nn/train.py``, ``filters/autoencoder.py``)
               at full width: ViTPose-huge on 64 crops, ResNet-152 on 64
               crops, Swin-S Mask R-CNN on 2 images of 608x800, the
               autoencoder on 4,800 frames; bf16 compute with float32
               parameters; seconds a step, throughput, peak memory, the
               pose step's bound; losses fall, the first step repeats, no
               kernel launches, a small pose step card against CPU;
 12. calib   - the calibration (``calib/bundle.py``, ``calib/workflow.py``,
               ``compat/aniposelib.py``) at the reference rig's size (8
               omnidir cameras at 2048x1536): the omnidir and fisheye
               intrinsic fits of 10 board views, the extrinsic and full
               bundle adjustments of a 1,440-point marker trace, the
               facade's ``bundle_adjust_iter``, ``triangulate``,
               ``triangulate_ransac`` and ``optim_points_possible``; each
               solver's wall, LM steps, CG sweeps and host reads; (a) card
               against CPU at the tests' short budget, (b) the production
               budgets in float32 and float64 (the omnidir intrinsic
               fit in float32 only) against the truth, (c) no kernel launch;
 13. session - the anipose session tools' array core
               (``tools/session.py``: ``train_autoencoder``,
               ``filter_pose_2d_arrays`` with medfilt -> viterbi ->
               autoencoder, ``triangulate_arrays`` with RANSAC and the
               refinement under the macaque constraints) on one recording
               of the reference rig (8 omnidir cameras at 2048x1536, one
               animal's 17 joints over 1,440 frames); each call's wall;
               (a) card against CPU in float64 on 240 frames at the tests'
               short budget, (b) float32 against the truth, the refinement
               below RANSAC alone, (c) no kernel launch;
 14. mesh    - ``core/mesh.py`` on the card: (a) steps 2-4 on
               tests/test_multichip.py's scene (4 cameras, 2 animals x 96
               frames) under ``make_mesh()`` and under four entries of
               ``cuda:0`` against ``mesh=None``: the one-device mesh's
               pickles equal, the four-entry mesh's within the CPU test's
               bounds with step 4 at the JAX test's converged budget; (b) the
               parity perception's detect, pose and classify on 6 frames
               of 2048x1536 under the four-entry mesh against
               ``mesh=None``, K1 and K2 counted;
 15. tools   - ``tools/pipeline_bench.run`` at 32 frames x 4 cameras,
               render off, with the ``serving`` real tier alone (K1, K2
               and K5b counted), and one cheap variant list of each probe
               (``int8_probe`` micro on fc2, ``roialign_probe`` at 128,
               ``trunk_probe`` map1; ``remat`` refused), and
               ``tools/perf_tables.py`` rendering a fixed line that names
               the card into a temporary, marked README.md and PERF.md.
Steps 2-4, the tracker, the trainers, the calibration and the session
tools run no hand-written kernel (the JAX package runs them as plain XLA
or host code); a step phase runs the step phases before it, on one scene.
The second-to-last line is a JSON object with one entry per kernel; the
last is ``{"ok": true, "device": {...}}``. Any failed phase raises, so the
script exits non-zero and prints no result; so it does without a CUDA
device. ``--phases device,build,kernels`` runs a subset (``device,step4``
steps 2-4 alone, ``device,tracker,train`` the tracker and the trainers,
``device,calib`` the calibration, ``device,session`` the session tools,
``device,build,eval2d`` the evaluation and 2D tools,
``device,build,mesh,tools`` the mesh and the benchmark tools);
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


def graph_ms(fn, reps: int = 20):
    """Device time of the kernels ``fn`` launches, without the host's
    launch cost: ``fn`` captured once in a CUDA graph, the mean over
    ``reps`` replays timed with CUDA events. Returns (ms, None), or
    (None, why) where the capture is refused."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn()
    except Exception as e:  # noqa: BLE001 (the reason is the result)
        torch.cuda.synchronize()
        return None, f"{type(e).__name__}: {e}"
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    stop.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(stop) / reps, None


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


def max_err(out, ref, name, floor: float = 1.0):
    """Max |kernel - plain|; fails above 2^-6 of the largest |plain| value
    (at least ``floor``): both round one f32 result to bf16, so they may
    differ by one bf16 ulp (<= 2^-7 relative) plus f32 reordering noise."""
    torch.cuda.synchronize()
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (out - ref).abs().max().item()
    tol = 2.0 ** -6 * max(ref.abs().max().item(), floor)
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


def ptxas_summary(kernel):
    """The registers and spills of the ``__global__`` function ``kernel`` as
    ptxas reported them in this run's build."""
    from macaque_tpu_torch import kernels

    st = kernels.ptxas_stats(kernel)
    return ("not in this run's build log" if not st else
            f"{st.get('registers')} registers, spill stores "
            f"{st.get('spill_stores')} B, spill loads {st.get('spill_loads')} B")


def kernel_resources(name, kernel=None, *variant):
    """Log what holds the kernel ``name`` back on an SM: its registers and
    spills (of its ``__global__`` function ``kernel``, default
    ``<name>_kernel``), and the blocks one SM keeps resident (the kernel's
    occupancy query, for ``variant`` where it has several)."""
    from macaque_tpu_torch import kernels

    log(f"{name}{list(variant) if variant else ''}: "
        f"{ptxas_summary(kernel or f'{name}_kernel')}; "
        f"{kernels.resident_blocks(name, *variant)} resident blocks per SM")


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
    kernel_resources("packed_attention")
    return dict(name="packed_attention", route="cuda",
                source="macaque_tpu_torch/csrc/packed_attention.cu",
                replaces="macaque_tpu/nn/pallas_attention.py:137",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib)


def check_relpos_attention(gen):
    """K7 at ViTDet-H's two shapes on a 32-frame chunk: the window blocks'
    800 windows of 14 x 14 tokens and the global blocks' 32 maps of 64 x 64
    (16 heads, d=80), packed qkv and the two float32 factor tables; the
    plain version on the first 50 windows and the first map, held to 2^-6
    of its largest output with no floor (the outputs are well below 1).
    The entry's ``ms``, ``bound_ms``, ``library_ms`` (SDPA with the bias
    materialized, which a chunk's global block would need 17 GB for) and
    ``plain_ms`` are one frame's global block; ``chunk_ms`` and
    ``chunk_bound_ms`` the chunk's global block, ``window_ms`` and
    ``window_bound_ms`` the chunk's window block, each one launch."""
    import torch.nn.functional as F
    from macaque_tpu_torch.nn.attention import (
        relpos_attention, relpos_attention_reference)

    H, D = 16, 80
    out = {}
    for B, g in ((800, 14), (32, 64)):
        T, n = g * g, (50 if g == 14 else 1)
        qkv = torch.randn((B, T, 3 * H * D), generator=gen, device="cuda").to(
            torch.bfloat16)
        rh, rw = (0.3 * torch.randn((B, H, T, g), generator=gen, device="cuda")
                  for _ in range(2))
        err = max_err(relpos_attention(qkv[:n], rh[:n], rw[:n], H),
                      relpos_attention_reference(qkv[:n], rh[:n], rw[:n], H),
                      "relpos_attention", floor=0.0)
        out["max_abs_err"] = max(err, out.get("max_abs_err", 0.0))

        def k7_bound(m):
            n_bytes = (qkv[:m].numel() * 2 + m * T * H * D * 2
                       + 2 * rh[:m].numel() * 4)
            return bound_ms(n_bytes, 4.0 * m * H * T * T * D)
        ms = cuda_ms(lambda: relpos_attention(qkv, rh, rw, H), reps=10)
        b, by = k7_bound(B)
        log(f"relpos_attention {tuple(qkv.shape)}: kernel {ms:.4f} ms, "
            f"bound {b:.4f} ms ({by})")
        if g == 14:
            out.update(window_ms=ms, window_bound_ms=b)
        else:
            out.update(chunk_ms=ms, chunk_bound_ms=b)
            # one frame's global block: K7, its bound, SDPA with the bias
            # materialized, the plain version
            q, k, v = qkv[:1].view(1, T, 3, H, D).permute(2, 0, 3, 1, 4)

            def sdpa():
                bias = (rh[:1, ..., None] + rw[:1, ..., None, :]).reshape(
                    1, H, T, T).to(torch.bfloat16)
                return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
            one = cuda_ms(lambda: relpos_attention(qkv[:1], rh[:1], rw[:1], H),
                          reps=10)
            b1, by1 = k7_bound(1)
            out.update(ms=one, bound_ms=b1, bound_by=by1,
                       library_ms=cuda_ms(sdpa, reps=10),
                       plain_ms=cuda_ms(lambda: relpos_attention_reference(
                           qkv[:1], rh[:1], rw[:1], H), reps=3))
            log(f"relpos_attention one frame (1, {T}, {3 * H * D}): kernel "
                f"{one:.4f} ms, bound {b1:.4f} ms ({by1}), sdpa with its "
                f"bias {out['library_ms']:.4f} ms, plain "
                f"{out['plain_ms']:.4f} ms")
        del qkv, rh, rw
    for g in (14, 64):
        kernel_resources("relpos_attention", None, g)
    return dict(name="relpos_attention", route="cuda",
                source="macaque_tpu_torch/csrc/relpos_attention.cu",
                replaces=None, **out)


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


def window_stats(calls, show=False):
    """(bytes, flop) that window-step calls need: the union of the canvas
    pixels that carry a nonzero Ky x Kx weight, read once (a pixel of a
    window whose row has no nonzero Ky entry, or whose column has no
    nonzero Kx entry, adds only exact zeros, and a kernel need not read
    it); the matrices and indices read once; the outputs written once;
    2*C*(7w^2 + 49w) FLOP per RoI, the dense product's. With ``show``,
    log that pixel count beside the union of whole windows."""
    canvas = calls[0][0]
    P, H0, W0, C = canvas.shape
    weighted = torch.zeros(P * H0 * W0, dtype=torch.bool, device="cuda")
    windows = torch.zeros_like(weighted)
    n_bytes = n_flop = 0.0
    for _, plane, ys, xs, ky, kx in calls:
        R, _, w = ky.shape
        ar = torch.arange(w, device="cuda")
        y = ys.long().clamp(0, H0 - w)[:, None] + ar
        x = xs.long().clamp(0, W0 - w)[:, None] + ar
        pix = ((plane.long()[:, None, None] * H0 + y[:, :, None]) * W0
               + x[:, None, :])
        windows[pix.reshape(-1)] = True
        live = (ky != 0).any(1)[:, :, None] & (kx != 0).any(1)[:, None, :]
        weighted[pix[live]] = True
        n_bytes += 2 * ky.numel() * 4 + 3 * R * 4 + R * 49 * C * 2
        n_flop += 2.0 * C * R * (7 * w * w + 49 * w)
    if show:
        log(f"window step canvas pixels: {windows.sum().item()} in the "
            f"windows, {weighted.sum().item()} with a nonzero weight (the "
            "bound counts these)")
    return n_bytes + weighted.sum().item() * C * 2, n_flop


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

    serving = rois[:, :128], lvl[:, :128]   # a serving frame's 128 RoIs
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
    dev, why = graph_ms(lambda: [roi_align_windows(*a) for a in calls])
    plain = cuda_ms(lambda: [roi_align_windows_reference(*a) for a in calls],
                    reps=3)
    b, by = bound_ms(*window_stats(calls, show=True))
    windows = [a[4].shape[-1] for a in calls]
    log(f"roi_align_windowed detector sequence {B}x1000 RoIs, windows "
        f"{windows}: kernel {ms:.4f} ms eager, "
        + (f"{dev:.4f} ms device (CUDA graph replay)" if why is None else
           f"CUDA graph capture refused ({why})")
        + f", plain {plain:.4f} ms, bound {b:.4f} ms ({by})")
    check_exact_gather(feats, rois, lvl, need, strides, ms)
    # a serving / fast tier call: 16 frames x 64 RoIs, the first of a
    # frame's two 64-RoI chunks of its 128, bucket-sorted as the detector
    # sorts them
    rois, lvl = serving
    need = roi_window_buckets(feats, rois, lvl, 7, strides)
    order = torch.sort(need, dim=1, descending=True, stable=True).indices[:, :64]
    w = WINDOW_BUCKETS[int(torch.gather(need, 1, order).max())]
    args = window_inputs(feats, torch.gather(
        rois, 1, order[..., None].expand(-1, -1, 4)), torch.gather(lvl, 1, order),
        7, strides, window=w, canvas=canvas)
    err = max(err, max_err(roi_align_windows(*args),
                           roi_align_windows_reference(*args),
                           "roi_align_windowed serving call"))
    sms = cuda_ms(lambda: roi_align_windows(*args))
    sdev, why = graph_ms(lambda: [roi_align_windows(*args) for _ in range(20)],
                         reps=5)
    sb, sby = bound_ms(*window_stats([args]))
    per_roi = lambda t, n: f"{t / n * 1e6:.2f} ns a RoI"  # noqa: E731
    n_seq = sum(a[4].shape[0] for a in calls)
    log(f"roi_align_windowed serving call {args[4].shape[0]} RoIs window {w}: "
        f"kernel {sms:.4f} ms eager, "
        + (f"{sdev / 20:.4f} ms device (20 calls replayed, "
           f"{per_roi(sdev / 20, args[4].shape[0])}; the parity sequence "
           + (per_roi(dev, n_seq) if dev is not None else "not timed") + ")"
           if sdev is not None else f"CUDA graph capture refused ({why})")
        + f", bound {sb:.4f} ms ({sby})")
    kernel_resources("roi_align_windowed")
    return dict(name="roi_align_windowed", route="cuda",
                source="macaque_tpu_torch/csrc/roi_align_windowed.cu",
                replaces="macaque_tpu/nn/pallas_roialign.py:188",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=None)


def check_exact_gather(feats, rois, lvl, need, strides, kernel_ms,
                       chunk=256):
    """K2's route (``roi_align_windowed``, the detector's bucket-sorted
    256-RoI chunks) against the exact aligned RoIAlign by flat gather
    (``ops.roi_align_pyramid``, batched), in float32 on the bf16 canvas
    values, within 2^-6 of the gather's range (K2 rounds Ky, Kx and its
    output to bf16). Two kinds of RoI are left out and counted, where the
    windowed route departs from the gather by design (in the JAX package
    too, tests/test_nn.py:446-449): a sample in (-1, 0) of its level's
    extent (the windowed route follows mmcv's stencil clamping there, the
    gather blends rows 0 and 1), or anywhere outside [0, extent - 1]; and a
    RoI whose stencil the widest window (48) does not cover (its Ky, Kx
    are clamped into the window, as in the JAX package's windowed route:
    tests/test_torch_public_functions.py holds the two equal on such RoIs).
    Those wide RoIs must stay at most 0.1 % of all, and are held against the
    windowed route's plain version instead. Returns the max |windowed -
    gather| over the RoIs held."""
    from macaque_tpu_torch.nn.ops import (
        _roi_level_canvas, _roi_sample_grids, roi_align_pyramid)
    from macaque_tpu_torch.nn.roialign import (
        WINDOW_BUCKETS, roi_align_windowed, roi_align_windowed_reference,
        roi_window_buckets)

    canvas = _roi_level_canvas(feats)
    feats32 = [f.float() for f in feats]
    gy, gx, Hs, Ws = _roi_sample_grids(feats, rois, lvl, 7, strides, 2)
    interior = ((gy >= 0).all(-1) & (gy <= (Hs - 1)[..., None]).all(-1)
                & (gx >= 0).all(-1) & (gx <= (Ws - 1)[..., None]).all(-1))
    # bucket 0 of this two-step ladder: the widest window covers the RoI
    widest = WINDOW_BUCKETS[-1]
    covered = roi_window_buckets(feats, rois, lvl, 7, strides,
                                 buckets=(widest, widest)) == 0
    held = interior & covered
    starts = range(0, rois.shape[1], chunk)
    windows = [WINDOW_BUCKETS[int(need[:, c0:c0 + chunk].max())]
               for c0 in starts]
    route = lambda: [roi_align_windowed(  # noqa: E731
        feats, rois[:, c0:c0 + chunk], lvl[:, c0:c0 + chunk], 7, strides,
        window=w, canvas=canvas) for c0, w in zip(starts, windows)]
    gather = lambda: [roi_align_pyramid(  # noqa: E731
        feats32, rois[:, c0:c0 + chunk], lvl[:, c0:c0 + chunk], 7, strides)
        for c0 in starts]
    got, want = torch.cat(route(), 1), torch.cat(gather(), 1)
    wide = interior & ~covered
    n_wide = int(wide.sum())
    if n_wide > 1e-3 * wide.numel():
        raise AssertionError(f"{n_wide} of {wide.numel()} RoIs wider than the "
                             f"{widest}-pixel window: over 0.1 %")
    if n_wide:
        plain = torch.cat([roi_align_windowed_reference(
            feats, rois[:, c0:c0 + chunk], lvl[:, c0:c0 + chunk], 7, strides,
            window=w, canvas=canvas) for c0, w in zip(starts, windows)], 1)
        max_err(got[wide], plain[wide], f"roi_align_windowed on the {n_wide} "
                "RoIs wider than the window, against its plain version")
    torch.cuda.synchronize()
    got, want = got[held].float(), want[held]
    if not torch.isfinite(got).all() or got.shape != want.shape:
        raise AssertionError("roi_align_windowed: malformed output against "
                             "the gather")
    roi_err = (got - want).abs().amax((-3, -2, -1))
    err = roi_err.max().item()
    span = (want.max() - want.min()).item()
    tol = 2.0 ** -6 * span
    route_ms = cuda_ms(route, reps=3)
    gather_ms = cuda_ms(gather, reps=3)
    log(f"roi_align_windowed against the exact gather (roi_align_pyramid, "
        f"float32 on the bf16 values): {int(held.sum())} of {held.numel()} "
        f"RoIs held; left out: {int((~interior).sum())} by the border rule, "
        f"{n_wide} more wider than the "
        f"{widest}-pixel window; max_abs_err {err:.3e} (tolerance {tol:.3e}, "
        f"2^-6 of the range {span:.3e}); gather {gather_ms:.4f} ms, K2 "
        f"{kernel_ms:.4f} ms (its route with the geometry {route_ms:.4f} ms)")
    if not err <= tol:
        log(f"{int((roi_err > tol).sum())} held RoIs over the tolerance")
        raise AssertionError("roi_align_windowed disagrees with the exact "
                             "gather")
    return err


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
    """K5a at the int8 layers' shapes: the inputs of qkv/proj/fc1 (K = 1280)
    on both tiers' pose chunks and of fc2 (K = 5120); the split route
    (``quant_int8_matmul_split``) runs it, and K5b runs its device code as
    its first pass. The entry is one call at (49152, 1280)."""
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
    cuBLAS product. Int8Linear (K5b at every K) is held bit for bit to the
    JAX default tier's chain (``int8_matmul_reference``) at every shape.
    Then K5b's registers, spills and resident blocks, and one block's four
    layers, each way, as one timed sequence. The entry is fc2 at
    M = 49,152, the shape K5b's earlier times were measured at."""
    import torch.nn.functional as F
    from macaque_tpu_torch.nn.int8 import (
        quant_int8_matmul, quant_int8_matmul_reference, quant_int8_matmul_split)
    from macaque_tpu_torch.nn.quant import Int8Linear, int8_matmul_reference

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
        m = Int8Linear(K, N, device="cuda")
        m.weight_q, m.wscale, m.bias = wq, ws, b
        # the layer the tiers run: K5b with the bias added after the cast
        # (its out_bias epilogue), the JAX default tier's chain
        exact(m(x), int8_matmul_reference(x, wq, ws, b),
              f"Int8Linear (K5b) {name} M={M}")
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
            block.append((x, m, w16))

    kernel_resources("quant_int8_matmul", "int8_gemm_kernel")

    # one block's four layers on distinct inputs, each way one timed sequence
    args = [(x, m.weight_q, m.wscale, m.bias) for x, m, _ in block]
    times = {
        "Int8Linear (K5b)": cuda_ms(lambda: [m(x) for x, m, _ in block]),
        "K5b": cuda_ms(lambda: [quant_int8_matmul(*a) for a in args]),
        "split route at K = 1280, K5b for fc2 (the earlier routing)": cuda_ms(
            lambda: [quant_int8_matmul_split(*a) for a in args[:3]]
            + [quant_int8_matmul(*args[3])]),
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


# Swin-S on the parity input (608x800 padded frames): per stage one frame's
# token grid padded to multiples of 7, heads, blocks
SWIN_STAGES = [((154, 203), 3, 2), ((77, 105), 6, 2), ((42, 56), 12, 18),
               ((21, 28), 24, 2)]
CHUNK = 16                       # frames a detector call takes
# K3's __global__ functions and their (dtype, blocked) occupancy variants
WINDOW_KERNELS = [("window_attention_blocked_kernel", (1, 1)),
                  ("window_attention_split_kernel", (1, 0)),
                  ("window_attention_kernel", (0, 1))]


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
    """K3 at the four Swin-S stages of one parity detector frame, with and
    without the shift mask, in both precisions (f32 products and input-dtype
    products); then a 16-frame chunk's sequence as ``detect_frames`` runs
    it, built call by call and timed as one: 24 calls, one a block (blocked
    variant), each on its own (16 nW, 49, 3C) qkv of the whole chunk's
    windows, one bias per block, the stage's (nW, 49, 49) shift mask on the
    odd blocks, read at w % nW. The entry is that sequence."""
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
        for x in (qkv, qkv.float()):
            for masked in (False, True):
                m = mask if masked else None
                for blocked in (False, True):
                    name = (f"window_attention stage {st + 1} ({nW}, 49, "
                            f"{3 * C}) {str(x.dtype)[6:]} mask={masked} "
                            f"blocked={blocked}")
                    err = max(err, max_err(
                        window_attention(x, bias, m, heads, blocked),
                        window_attention_reference(x, bias, m, heads, blocked),
                        name))
                    if x.dtype != torch.bfloat16:
                        continue                # no card path runs f32
                    ms = cuda_ms(lambda: window_attention(x, bias, m, heads,
                                                          blocked), reps=10)
                    dev = why = None
                    if blocked:                 # the detector's variant
                        dev, why = graph_ms(lambda: [window_attention(
                            x, bias, m, heads, blocked) for _ in range(20)],
                            reps=5)
                    log(f"{name}: kernel {ms:.4f} ms per call eager"
                        + ("" if not blocked else
                           f", {dev / 20:.4f} ms device (20 calls replayed)"
                           if why is None else f", capture refused ({why})"))

    calls = [(randn_bf16(gen, CHUNK * nW, 49, 96 * heads), bias, m, heads)
             for bias, m, heads, nW in blocks]
    for i, c in enumerate(calls):
        err = max(err, max_err(window_attention(*c),
                               window_attention_reference(*c),
                               f"window_attention sequence call {i}"))
    ms = cuda_ms(lambda: [window_attention(*c) for c in calls], reps=5)
    dev, why = graph_ms(lambda: [window_attention(*c) for c in calls], reps=5)
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
        f"calls, one a block on the chunk's windows): kernel {ms:.4f} ms "
        f"eager, "
        + (f"{dev:.4f} ms device (CUDA graph replay)" if why is None else
           f"CUDA graph capture refused ({why})")
        + f", plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {b:.4f} ms "
        f"({by})")
    for kernel, variant in WINDOW_KERNELS:
        kernel_resources("window_attention", kernel, *variant)
    return dict(name="window_attention", route="cuda",
                source="macaque_tpu_torch/csrc/window_attention.cu",
                replaces="macaque_tpu/nn/pallas_attention.py:265",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib)


# the ViT-huge crop shape the JAX dispatcher's docstring measures
ATTN_SHAPE = (64, 192, 16, 80)


def check_unpacked_attention(gen):
    """K4 at (64, 192, 16, 80) bf16, through its three entry points (both
    JAX kernels and the dispatcher: one kernel, one block per batch element
    and head), against ``attention_reference``."""
    import torch.nn.functional as F
    from macaque_tpu_torch.nn.attention import (
        attention, attention_reference, fused_attention,
        fused_attention_blocked)

    q, k, v = (randn_bf16(gen, *ATTN_SHAPE) for _ in range(3))
    ref = attention_reference(q, k, v)
    err = max(max_err(fn(q, k, v), ref, fn.__name__) for fn in
              (fused_attention, fused_attention_blocked, attention))
    ms = cuda_ms(lambda: fused_attention(q, k, v), reps=20)
    plain = cuda_ms(lambda: attention_reference(q, k, v), reps=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps=20)
    B, N, H, D = ATTN_SHAPE
    b, by = bound_ms(4 * q.numel() * 2, 4.0 * B * H * N * N * D)
    log(f"attention {ATTN_SHAPE}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"sdpa {lib:.4f} ms, bound {b:.4f} ms ({by})")
    kernel_resources("attention")
    return dict(name="attention", route="cuda",
                source="macaque_tpu_torch/csrc/attention.cu",
                replaces="macaque_tpu/nn/pallas_attention.py:39",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib)


def swin_block_calls(gen, backbone):
    """The fused block's inputs for each of Swin-S's 24 blocks at the
    parity detector's 16-frame chunk (608x800: token grids 152x200 ..
    19x25, spatially padded to whole windows, shifted on odd blocks): a
    random bf16 feature map per block, turned into the block's arguments as
    the fused trunk turns it, with the block's own weights. Returns
    (block, map, args) per block."""
    from macaque_tpu_torch.nn.swin_block import block_inputs

    calls = []
    for st, stage in enumerate(backbone.stages):
        heads = SWIN_STAGES[st][1]
        for blk in stage.blocks:
            x = randn_bf16(gen, CHUNK, 152 >> st, 200 >> st, 32 * heads)
            calls.append((blk, x, block_inputs(blk, x, heads)[0]))
    return calls


def swin_block_tolerance(ref, x_win):
    """K6 against its plain version, held on the block's own contribution
    ``out - x_win``: both round every Dense output, P and each residual sum
    to bf16 at the same places, but sum the dots in another order, so an
    intermediate can land one bf16 ulp apart; an ulp flip in r1 or the
    output is one ulp at the output's magnitude, one in f1 or the attention
    output moves fc2's or proj's sum by less. Held to 2^-5 of the largest
    contribution. The residuals are drawn so that the contribution is at
    least as large as x_win (see ``check_swin_block``); a CPU emulation of
    the reordering (the plain version with f64 sums against f32 sums) put
    the error at 0.4-0.9% of the contribution on these inputs."""
    return 2.0 ** -5 * (ref.float() - x_win.float()).abs().max().item()


def trained_block(gen, blk, x, heads):
    """``fused_swin_block``'s arguments for ``blk``'s geometry on x, with
    parameters at a trained block's scale in place of the detector's fresh
    ones: Dense weights of std fan_in^-1/2, biases of std 0.1, LayerNorms
    near 1 and 0, a relative bias of std 0.5. At initialisation the
    relative bias has std 0.02 and the LayerNorm biases are 0, so a kernel
    that dropped or misindexed the bias, the mask or the pad-token zeroing
    would move the output by no more than reordering the sums does; here by
    25-80% of the largest contribution (a CPU emulation of the plain
    version at each stage's width)."""
    from macaque_tpu_torch.nn.swin_block import block_inputs

    xw, tv, _, bias, mask, heads = block_inputs(blk, x, heads)[0]
    dev, C = x.device, x.shape[-1]

    def rn(*shape, std=1.0, mean=0.0):
        return torch.randn(shape, generator=gen, device=dev) * std + mean

    p = {}
    for name, (n, k) in {"qkv": (3 * C, C), "proj": (C, C),
                         "fc1": (4 * C, C), "fc2": (C, 4 * C)}.items():
        p[f"{name}.weight"] = rn(n, k, std=k ** -0.5).to(torch.bfloat16)
        p[f"{name}.bias"] = rn(n, std=0.1).to(torch.bfloat16)
    for name in ("ln1", "ln2"):
        p[f"{name}.weight"] = rn(C, std=0.1, mean=1.0)
        p[f"{name}.bias"] = rn(C, std=0.1)
    return xw, tv, p, rn(*bias.shape, std=0.5), mask, heads


def check_swin_block(gen, backbone):
    """K6 at the B=16 chunk's window counts (10,208 / 2,640 / 768 / 192),
    with spatial padding, against ``fused_swin_block_reference``: for each
    stage, its first two blocks (unshifted, shifted) with the parity
    detector's backbone weights on a residual drawn at 1/16 of unit scale
    (LN makes the block's work independent of that scale, and the output's
    bf16 rounding then sits at the contribution's magnitude, not the
    residual's), and its shifted block with parameters at trained scale on
    a unit residual (``trained_block``); then the 24 blocks' calls as one
    timed sequence against the plain version and the port's
    ``SwinBlock.forward`` (cuBLAS Dense layers, plain attention) on the
    same feature maps."""
    from macaque_tpu_torch.nn.swin_block import (
        _workspace_slots, block_inputs, block_layout, fused_swin_block,
        fused_swin_block_reference)

    calls = swin_block_calls(gen, backbone)
    log(f"swin_block: {ptxas_summary('swin_block_kernel')}")
    err, n_bytes, n_flop, first = 0.0, 0.0, 0.0, 0
    for st, stage in enumerate(backbone.stages):
        heads = SWIN_STAGES[st][1]
        shape = (CHUNK, 152 >> st, 200 >> st, 32 * heads)
        cases = [(f"shift={stage.blocks[i].shift}",
                  block_inputs(stage.blocks[i], randn_bf16(gen, *shape) / 16,
                               heads)[0]) for i in (0, 1)]
        cases.append(("shift=3 trained scale",
                      trained_block(gen, stage.blocks[1], randn_bf16(gen, *shape),
                                    heads)))
        for label, args in cases:
            ref = fused_swin_block_reference(*args)
            out = fused_swin_block(*args)
            torch.cuda.synchronize()
            d = (out.float() - ref.float()).abs().max().item()
            tol = swin_block_tolerance(ref, args[0])
            name = f"swin_block stage {st + 1} {tuple(args[0].shape)} {label}"
            log(f"{name}: max_abs_err {d:.3e} (tolerance {tol:.3e}, largest "
                f"contribution {tol * 32:.3e}, output max "
                f"{ref.float().abs().max().item():.3e})")
            if not (torch.isfinite(out.float()).all() and d <= tol):
                raise AssertionError(f"{name}: kernel disagrees with its plain "
                                     "version")
            err = max(err, d)
        args = calls[first][2]
        ms = cuda_ms(lambda: fused_swin_block(*args), reps=5)
        C = 32 * heads
        per_sm = _workspace_slots(C, torch.device("cuda")) // \
            torch.cuda.get_device_properties(0).multi_processor_count
        log(f"swin_block stage {st + 1}: kernel {ms:.4f} ms per call; "
            f"{block_layout(C)['smem_bytes']} B of shared memory, {per_sm} "
            "resident blocks per SM")
        first += len(stage.blocks)
    for blk, x, (xw, tv, p, bias, mask, heads) in calls:
        nW, N, C = xw.shape
        # real tokens only: 12 C^2 multiply-adds a token in the four Dense
        # layers, 2 x 49 x 32 per token and head in attention
        n_flop += 2.0 * nW * N * 12 * C * C + 4.0 * nW * heads * N * N * 32
        n_bytes += 2 * xw.numel() * 2 + tv.numel() + bias.numel() * 4 \
            + sum(t.numel() * t.element_size() for t in p.values()) \
            + (mask.numel() * 4 if mask is not None else 0)
    b, by = bound_ms(n_bytes, n_flop)
    ms = cuda_ms(lambda: [fused_swin_block(*c[2]) for c in calls], reps=5)
    plain = cuda_ms(lambda: [fused_swin_block_reference(*c[2]) for c in calls],
                    reps=2, warmup=1)
    with torch.no_grad():
        swinblock = cuda_ms(lambda: [blk(x) for blk, x, _ in calls], reps=5)
    log(f"swin_block 24-call sequence ({n_flop / 1e12:.3f} TFLOP): kernel "
        f"{ms:.4f} ms ({n_flop / ms / 1e9:.1f} TFLOP/s), plain {plain:.4f} ms, "
        f"SwinBlock.forward (cuBLAS) {swinblock:.4f} ms, bound {b:.4f} ms "
        f"({by})")
    return dict(name="swin_block", route="cuda",
                source="macaque_tpu_torch/csrc/swin_block.cu",
                replaces="macaque_tpu/nn/pallas_swin_block.py:163",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=None)


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
    """Stage 1's three models at full width, random weights from seed 0, and
    the pose's float32 state dict (the weights the int8 tiers quantize, as
    a checkpoint supplies them): the bf16 pose is loaded from it."""
    from macaque_tpu_torch.nn import (
        DetectorConfig, ResNetClassifier, ResNetConfig, SwinMaskRCNN,
        ViTPose, VitPoseConfig)
    from macaque_tpu_torch.nn.swin import SwinConfig

    t = time.perf_counter()
    torch.manual_seed(0)
    det = SwinMaskRCNN(DetectorConfig(swin=SwinConfig(compute_dtype=bf16),
                                      compute_dtype=bf16), device=dev)
    pose_sd = ViTPose(VitPoseConfig(), device=dev).state_dict()
    pose = ViTPose(VitPoseConfig(compute_dtype=bf16, use_pallas_attention=True),
                   device=dev)
    pose.load_state_dict(pose_sd)
    idm = ResNetClassifier(ResNetConfig(compute_dtype=bf16), device=dev)
    with torch.no_grad():
        # random box-head weights score nothing near the pipeline's 0.85
        # threshold; a raised foreground bias lets detections through (the
        # scores still vary with the RoI features, so they stay tie-free)
        det.roi_head.bbox_head.fc_cls.bias[0] += 6.0
    n_params = sum(p.numel() for m in (det, pose, idm) for p in m.parameters())
    torch.cuda.synchronize()
    log(f"models built on the card, {n_params / 1e6:.1f} M parameters, "
        f"{time.perf_counter() - t:.1f}s")
    return det, pose, idm, pose_sd


def phase_main(det, pose, idm, pose_sd):
    """Stage 1 at full width: Swin-S Mask R-CNN (1000 proposals, 256-RoI
    chunks), ViTPose-huge with flip test, ResNet-152, max_det 8, bf16, on a
    2 x 16-frame 2048x1536 camera; then the serving tiers and the window
    attention kernel's detector on the same frames. Returns the launches of
    every counted run, by run."""
    from macaque_tpu_torch.pipeline.perception import TorchPerception

    perception = TorchPerception(det, pose, idm, max_det=8,
                                 device=torch.device("cuda"))
    t = time.perf_counter()
    frames = synthetic_frames(33)
    store = MemoryStore(frames)
    T = store.ftimes[:32]
    log(f"main: {len(frames)} frames of {frames.shape[1:]} drawn in "
        f"{time.perf_counter() - t:.1f}s")

    runs = {"parity": run_camera("step1", perception, store, T,
                                 ("packed_attention", "roi_align_windowed"))}
    check_plain_path(perception, frames[:2])
    runs.update(phase_tiers(det, pose, idm, pose_sd, store, T, frames[:2]))
    runs["k3_detector"] = phase_window_detector(det, pose, idm, frames[:CHUNK])
    runs["det_int8"] = phase_int8_detector(frames[:CHUNK])
    runs["vitdet"] = phase_vitdet_detector(pose, idm, store, T)
    return runs, perception, store, T


def phase_vitdet_detector(pose, idm, store, T):
    """Stage 1 with ViTDet-H as the detector (``build_detector("vitdet")``:
    the square 1024 input, K7 in every block, the pyramid and heads, K2) on
    the same camera, pose and ID as parity: K7, K2 and K1 must launch. The
    weights are the modules' own initialization (zero relative position
    tables, as detectron2 starts pretraining), the foreground bias raised
    by 6: this run holds the path; K7's numbers are held by
    ``check_relpos_attention`` and the benchmark's ``vitdet.occupied``."""
    from macaque_tpu_torch.pipeline.perception import TorchPerception
    from macaque_tpu_torch.pipeline.weights import build_detector

    det = build_detector("vitdet", torch.device("cuda"))
    with torch.no_grad():
        det.roi_head.bbox_head.fc_cls.bias[0] += 6.0
    perception = TorchPerception(det, pose, idm, max_det=8,
                                 device=torch.device("cuda"))
    if perception.det_square != 1024:
        raise AssertionError("the perception does not read ViTDet's square")
    launches = run_camera("vitdet", perception, store, T,
                          ("relpos_attention", "roi_align_windowed",
                           "packed_attention"))
    del perception, det
    torch.cuda.empty_cache()
    return launches


def check_plain_path(perception, frames):
    """The same full-width models on a small input (2 frames, 2 detections
    each) with both kernels swapped for their plain versions: detections
    and pose heatmaps must agree. K2 rounds the same f32 sums to bf16 as
    its plain version, summed in another order, so an output can move by
    one bf16 ulp; the detections are held to float32 noise (they have come
    out equal at these shapes). K1 differs by bf16 rounding, which 32 bf16
    residual blocks carry into the heatmaps, held to 2^-4 of their
    range."""
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


def phase_tiers(det, pose, idm, pose_sd, store, T, frames):
    """The serving tiers on the same camera: ``serving`` (512/128 detector
    budgets, int8 pose) and ``fast`` (the serving detector at a 640 target,
    int8 pose, no flip test); the int8 pose is quantized from the float32
    weights ``pose_sd``, and its four int8 layers a block run K5b. Then the
    int8 pose against its plain path."""
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
    pose8 = quantize_vitpose_(copy.deepcopy(pose), pose_sd)
    runs = {}
    for name in ("serving", "fast"):
        tier = serving_tier(serving=True, fast=name == "fast")
        perception = TorchPerception(det_s, pose8, idm, max_det=8,
                                     det_target=tier.det_target,
                                     flip_test=tier.flip_test)
        log(f"{name} tier: det_target {tier.det_target}, flip test "
            f"{tier.flip_test}")
        runs[name] = run_camera(name, perception, store, T,
                                ("quant_int8_matmul",))
    check_int8_plain_path(pose8, frames, TorchPerception(
        det_s, pose8, idm, max_det=8))
    return runs


def check_int8_plain_path(pose, frames, perception):
    """The int8 pose on crops of ``frames`` with K5b swapped for its plain
    version. K5b equals its plain version bit for bit, and everything else
    is the same ops on the same inputs, so the heatmaps must agree to 2^-10
    of their range (headroom for float32 reordering in the library's
    deconvolution)."""
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
                               quant_int8_matmul_reference):
            hm_p = pose(crops).float()
    dh = (hm - hm_p).abs().max().item()
    span = (hm_p.max() - hm_p.min()).item()
    log(f"int8 plain path: heatmaps |d| {dh:.3e} of range {span:.3e}")
    if not torch.isfinite(hm).all() or not dh <= 2.0 ** -10 * span:
        raise AssertionError("int8 kernel path disagrees with the plain path")


def phase_window_detector(det, pose, idm, frames):
    """The parity detector with SwinConfig(use_pallas_attention=True) on one
    16-frame chunk: the trunk's 24 window-attention calls, one a block over
    the whole chunk's windows, launch K3. Then the same model with K3
    swapped for its plain version, and K3 again on the plain run's RPN
    proposals: the RPN's top-k and NMS
    pick among proposals that the random weights score within about 1e-4
    of each other, so bf16 noise would change which proposals the RoI head
    sees. On shared proposals every RoI-head output (the boxes and scores
    into its NMS) and the detections are held against the plain path."""
    from unittest import mock

    from macaque_tpu_torch import kernels
    from macaque_tpu_torch.nn import DetectorConfig, SwinMaskRCNN, detector, swin
    from macaque_tpu_torch.nn.attention import window_attention_reference
    from macaque_tpu_torch.nn.preprocess import detector_input_batch
    from macaque_tpu_torch.nn.swin import SwinConfig
    from macaque_tpu_torch.pipeline.perception import TorchPerception

    bf16 = torch.bfloat16
    det_k = SwinMaskRCNN(DetectorConfig(
        swin=SwinConfig(compute_dtype=bf16, use_pallas_attention=True),
        compute_dtype=bf16), device=det.roi_head.bbox_head.fc_cls.bias.device)
    det_k.load_state_dict(det.state_dict())
    # every detection a frame, best first: the first 8 are a max_det = 8
    # detect's, the rest those below its cut (check_detections)
    perception = TorchPerception(det_k, pose, idm, max_det=1 << 10)
    perception.detect(frames)                                 # warm-up
    real_nms, real_proposals = detector.nms_fixed, det_k._proposals
    props, pre = [], []     # the plain run's proposals; each run's NMS input

    def nms(boxes, score, *a):
        pre.append((boxes.float().cpu().numpy(), score.float().cpu().numpy()))
        return real_nms(boxes, score, *a)

    def proposals(*a):
        props.append(real_proposals(*a))
        return props[-1]

    with torch.no_grad():
        kernels.reset_launches()
        t = time.perf_counter()
        boxes, scores = perception.detect(frames)
        wall = time.perf_counter() - t
        launches = dict(kernels.LAUNCHES)
        with mock.patch.object(detector, "nms_fixed", nms):
            with mock.patch.object(swin, "window_attention",
                                   window_attention_reference), \
                    mock.patch.object(det_k, "_proposals", proposals):
                t = time.perf_counter()
                boxes_p, scores_p = perception.detect(frames)
                wall_p = time.perf_counter() - t
            with mock.patch.object(det_k, "_proposals", lambda *a: props[0]):
                boxes_s, scores_s = perception.detect(frames)
    log(f"k3 detector: detect {len(frames)} frames in {wall:.3f}s (plain window "
        f"attention {wall_p:.3f}s); launches {launches}")
    if launches["window_attention"] != 24:
        raise AssertionError("the detector did not launch K3 once per block")
    if not (np.isfinite(boxes).all() and ((scores >= 0) & (scores <= 1)).all()
            and (scores[:, :8] > 0).sum() == (scores_p[:, :8] > 0).sum()):
        raise AssertionError("k3 detector: malformed detections")
    # the trunk K3 acts in, as detect runs it (one call a block on the whole
    # chunk, each mask read at w % nW across 16 frames), against its plain
    # version
    x = detector_input_batch(perception._rgb(
        torch.from_numpy(frames).to(perception.device)))[0]
    with torch.no_grad():
        maps = det_k.backbone(x)
        with mock.patch.object(swin, "window_attention",
                               window_attention_reference):
            maps_p = det_k.backbone(x)
    check_maps(maps, maps_p, "k3 trunk vs its plain version", 2.0 ** -5)
    check_roi_head(*pre[1], *pre[0])
    check_detections(boxes_s, scores_s, boxes_p, scores_p)
    return launches


def phase_int8_detector(frames):
    """The int8 serving detector (the JAX package's ``BENCH_DET_INT8=1``):
    Swin-S Mask R-CNN at the serving budgets, bf16, its 24 blocks' qkv,
    proj, fc1 and fc2 quantized by ``quantize_swin_`` from a float32 state
    dict drawn from seed 0 (a bf16 model's own weights are already
    rounded), box head's foreground bias +6. ``detect_frames`` on one
    16-frame chunk runs the trunk once over the chunk, so K5b launches
    24 x 4 = 96 times, once a layer and block. Then 2 frames against the
    same model with ``Int8Linear`` routed to the plain chain on the card
    (no K5b launch there): K5b is exact, so no Swin map and no int8
    activation code may differ, the maps are held to 2^-6 of each map's
    range besides and the detections through ``check_detections``. The
    warm chunk timed with CUDA events against the bf16 serving detector of
    the same weights. Returns the launches."""
    from unittest import mock

    from macaque_tpu_torch import kernels
    from macaque_tpu_torch.nn import DetectorConfig, SwinMaskRCNN, quant
    from macaque_tpu_torch.nn.detector import detect_frames
    from macaque_tpu_torch.nn.int8 import (
        quant_int8_matmul_reference, quantize_rows_reference)
    from macaque_tpu_torch.nn.preprocess import detector_input_batch
    from macaque_tpu_torch.nn.quant import Int8Linear, quantize_swin_
    from macaque_tpu_torch.nn.swin import SwinConfig

    bf16, dev = torch.bfloat16, torch.device("cuda")
    t = time.perf_counter()
    torch.manual_seed(0)
    sd = SwinMaskRCNN(DetectorConfig.serving(), device=dev).state_dict()

    def serving_detector():
        m = SwinMaskRCNN(DetectorConfig.serving(
            swin=SwinConfig(compute_dtype=bf16), compute_dtype=bf16), device=dev)
        m.load_state_dict(sd)
        with torch.no_grad():
            m.roi_head.bbox_head.fc_cls.bias[0] += 6.0     # hazard 3
        return m

    det_bf16 = serving_detector()
    det8 = quantize_swin_(serving_detector(), sd)
    del sd
    if det8.backbone.cfg != SwinConfig(compute_dtype=bf16, quantize="int8"):
        raise AssertionError(f"int8 detector: Swin config {det8.backbone.cfg}")
    layers = [m for m in det8.modules() if isinstance(m, Int8Linear)]
    x = detector_input_batch(torch.from_numpy(frames).to(dev).flip(-1).float())[0]
    torch.cuda.synchronize()
    log(f"int8 detector: {len(layers)} Int8Linear layers, built and quantized "
        f"in {time.perf_counter() - t:.1f}s; input {tuple(x.shape)}")
    with torch.no_grad():
        detect_frames(det8, x[:1])                             # warm-up
        kernels.reset_launches()
        t = time.perf_counter()
        out = detect_frames(det8, x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(kernels.LAUNCHES)
        log(f"int8 detector: detect_frames {len(x)} frames in {wall:.3f}s; "
            f"launches {launches}")
        if launches["quant_int8_matmul"] != 24 * 4:
            raise AssertionError("the int8 detector did not launch K5b once "
                                 "per int8 layer and block")
        boxes, scores, valid = (o.float().cpu().numpy() if o.is_floating_point()
                                else o.cpu().numpy() for o in out)
        if not (np.isfinite(boxes).all() and ((scores >= 0) & (scores <= 1)).all()
                and valid.any(1).all()):
            raise AssertionError("int8 detector: malformed detections")

        # 2 frames against the plain chain: maps, int8 codes, detections
        seen = []
        hooks = [m.register_forward_pre_hook(
            lambda mod, args: seen.append(quantize_rows_reference(
                args[0].reshape(-1, args[0].shape[-1]))[0])) for m in layers]
        x2 = x[:2]
        maps = det8.backbone(x2)
        codes = seen[:]
        seen.clear()
        det_out = detect_frames(det8, x2)
        seen.clear()
        with mock.patch.object(quant, "quant_int8_matmul",
                               quant_int8_matmul_reference):
            before = kernels.LAUNCHES["quant_int8_matmul"]
            maps_p = det8.backbone(x2)
            codes_p = seen[:]
            seen.clear()
            det_p = detect_frames(det8, x2)
            if kernels.LAUNCHES["quant_int8_matmul"] != before:
                raise AssertionError("int8 detector: the plain chain launched "
                                     "K5b (Int8Linear was not rerouted)")
        for h in hooks:
            h.remove()
        n_codes = sum(c.numel() for c in codes)
        flips = sum(int((a != b).sum()) for a, b in zip(codes, codes_p))
        differ = sum(not torch.equal(a, b) for a, b in zip(maps, maps_p))
        log(f"int8 detector vs its plain chain, 2 frames: {differ} of 4 maps "
            f"differ, {flips} of {n_codes} int8 activation codes differ "
            f"(K5b is exact: both 0 expected)")
        if len(codes) != len(layers) or len(codes_p) != len(layers):
            raise AssertionError("int8 detector: not every int8 layer ran")
        if differ or flips:
            raise AssertionError("int8 detector: K5b is not exact against "
                                 "its plain chain")
        check_maps(maps, maps_p, "int8 trunk vs its plain chain", 2.0 ** -6)
        top = lambda o: (o[0].float().cpu().numpy(),  # noqa: E731
                         torch.where(o[2], o[1], torch.zeros_like(o[1]))
                         .float().cpu().numpy())
        check_detections(*top(det_out), *top(det_p), path="K5b")
        ms = cuda_ms(lambda: detect_frames(det8, x), reps=3, warmup=1)
        ms_bf16 = cuda_ms(lambda: detect_frames(det_bf16, x), reps=3,
                          warmup=1)
    log(f"int8 serving detector, warm {len(x)}-frame chunk: {ms:.3f} ms; "
        f"bf16 serving detector {ms_bf16:.3f} ms (CUDA events)")
    del det8, det_bf16
    torch.cuda.empty_cache()
    return launches


def check_roi_head(boxes, score, boxes_p, score_p):
    """The RoI head's boxes and scores for each proposal, (B, R, 4) and (B,
    R) with -inf where a proposal is dropped, through K3 against the plain
    path on the same proposals: the same proposals kept, every box at IoU
    >= 0.9 with its plain counterpart and every score within 2^-6, the
    detection check's limits, proposal by proposal."""
    keep, keep_p = np.isfinite(score), np.isfinite(score_p)
    if not (keep == keep_p).all():
        raise AssertionError("k3 RoI head: another set of proposals kept")
    a, b = boxes[keep], boxes_p[keep]
    lt, rb = np.maximum(a[:, :2], b[:, :2]), np.minimum(a[:, 2:], b[:, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), -1)
    area = lambda x: np.prod(x[:, 2:] - x[:, :2], -1)  # noqa: E731
    iou = inter / (area(a) + area(b) - inter)
    ds = np.abs(score[keep] - score_p[keep])
    log(f"k3 RoI head on the plain path's proposals: {keep.sum()} of "
        f"{keep.size} kept, worst IoU {iou.min():.6f}, |d box| "
        f"{np.abs(a - b).max():.3e} px, |d score| {ds.max():.3e}")
    if not (iou.min() >= 0.9 and ds.max() <= 2.0 ** -6):
        raise AssertionError("k3 RoI head disagrees with the plain path")


def box_iou(a, b):
    """IoU of every box of ``a`` (n, 4) xyxy with every box of ``b``."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), -1)
    area = lambda x: np.prod(x[:, 2:] - x[:, :2], -1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None] - inter)


def match_boxes(iou, sa, free):
    """One to one matching, best score ``sa`` first, of the rows of ``iou``
    to the columns whose ``free`` flag is set (cleared as they are taken),
    each to its best IoU among those at IoU >= 0.9. Returns the (i, j)
    pairs and the unmatched i."""
    pairs, lone = [], []
    for i in np.argsort(-sa, kind="stable"):
        cand = np.where(free & (iou[i] >= 0.9))[0]
        if not len(cand):
            lone.append(i)
            continue
        j = cand[iou[i, cand].argmax()]
        free[j] = False
        pairs.append((i, j))
    return pairs, lone


def check_detections(boxes, scores, boxes_p, scores_p, keep=8, path="K3"):
    """Detections through K3 (or the kernel ``path`` names) against the
    plain path: every detection of each path a frame, best first, of which
    a max_det = ``keep`` detect returns the first ``keep``. K3 and its
    plain version round different
    f32 sums to bf16, so outputs differ by up to one bf16 ulp, which 24
    bf16 blocks carry into the features (the trunk maps are held to 2^-5
    of their range before this). Each frame must keep as many valid
    detections, matched one to one at IoU >= 0.9 with scores within 2^-6.
    The random-weight detector scores a frame's boxes within about 1e-4 of
    each other, so bf16 noise can swap a box at the max_det cut. So a kept
    detection may go without a match, at most 2 a frame and only where the
    frame's ``keep`` slots are full, if the other path holds it just below
    its cut: among its detections past the first ``keep`` at IoU >= 0.9,
    with a score within 2^-12 of its own there and of the other path's
    lowest kept score (bf16 noise: matched scores differ by under 1e-5)."""
    tol, cut_tol = 2.0 ** -6, 2.0 ** -12
    fmt = lambda x: np.array2string(  # noqa: E731
        np.asarray(x), precision=7, max_line_width=1 << 16)
    worst_iou, worst_ds, worst_cut, swaps, faults = 1.0, 0.0, 0.0, 0, []
    for f in range(len(scores)):
        sa, sb = scores[f][:keep], scores_p[f][:keep]
        valid, valid_p = sa > 0, sb > 0
        if valid.sum() != valid_p.sum():
            faults.append(f"frame {f}: {valid.sum()} detections through {path}, "
                          f"{valid_p.sum()} plain")
            continue
        a, b = boxes[f][:keep][valid], boxes_p[f][:keep][valid_p]
        sa, sb = sa[valid], sb[valid_p]
        free = np.ones(len(b), bool)
        iou = box_iou(a, b)
        pairs, lone = match_boxes(iou, sa, free)
        for i, j in pairs:
            worst_iou = min(worst_iou, iou[i, j])
            worst_ds = max(worst_ds, abs(sa[i] - sb[j]))
        if not lone:
            continue
        lone_p = np.where(free)[0]
        log(f"frame {f}: {len(lone)} detection(s) swapped at the max_det cut: "
            f"through {path} {fmt(sa[lone])}, plain {fmt(sb[lone_p])}; kept "
            f"scores through {path} {fmt(sa)}, plain {fmt(sb)}")
        if not (valid.all() and len(lone) <= 2):
            faults.append(f"frame {f}: {len(lone)} detections do not match "
                          "one to one")
            continue
        # each side's unmatched boxes among the other's detections past the cut
        for side, box, s, idx, ob, os_, cut in (
                (path, a, sa, lone, boxes_p[f], scores_p[f], sb.min()),
                ("plain", b, sb, lone_p, boxes[f], scores[f], sa.min())):
            ob, os_ = ob[keep:], os_[keep:]
            iou_o = box_iou(box[idx], ob)
            found, missed = match_boxes(iou_o, s[idx], os_ > 0)
            for i, j in found:
                d = max(abs(s[idx][i] - os_[j]), abs(s[idx][i] - cut))
                worst_iou = min(worst_iou, iou_o[i, j])
                worst_cut = max(worst_cut, d)
                log(f"frame {f}: the {side} path's {s[idx][i]:.7f} is the "
                    f"other's rank {keep + j} at IoU {iou_o[i, j]:.4f}, "
                    f"score {os_[j]:.7f} (its cut {cut:.7f})")
                if d > cut_tol:
                    missed.append(i)
            for i in missed:
                k = int(iou_o[i].argmax()) if len(ob) else None
                faults.append(
                    f"frame {f}: the {side} path's detection {box[idx][i]} "
                    f"score {s[idx][i]:.7f} is not just below the other "
                    f"path's cut {cut:.7f}; the nearest there: " + (
                        "none" if k is None else f"rank {keep + k}, IoU "
                        f"{iou_o[i, k]:.4f}, score {os_[k]:.7f}"))
        swaps += len(lone)
    log(f"{path.lower()} plain path: detections matched, worst IoU "
        f"{worst_iou:.4f}, "
        f"|d score| {worst_ds:.3e}; {swaps} swapped at the max_det cut, "
        f"each within {worst_cut:.3e} of its own score and the cut on the "
        "other path")
    for msg in faults:
        log(msg)
    if faults:
        raise AssertionError(faults[0])
    if not (worst_iou >= 0.9 and worst_ds <= tol):
        raise AssertionError(f"{path} path disagrees with the plain path")


def check_maps(got, want, name, frac):
    """The four stage maps within ``frac`` of each map's range."""
    for lvl, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{name}: map {lvl} {tuple(g.shape)} "
                                 f"malformed against {tuple(w.shape)}")
        d = (g - w).abs().max().item()
        span = (w.max() - w.min()).item()
        log(f"{name}: map {lvl} {tuple(g.shape)} |d| {d:.3e} of range "
            f"{span:.3e}")
        if not d <= frac * span:
            raise AssertionError(f"{name}: map {lvl} disagrees")


def phase_fused_trunk(det, perception, frames):
    """The Swin-S trunk with every block fused (``swin_backbone_apply_fused``,
    24 K6 launches whatever the batch) on one 16-frame normalized detector
    chunk at 608x800, launches counted; its 4 maps against the detector's
    own ``SwinBackbone`` on the whole chunk and against the same trunk with
    K6 swapped for its plain version, each within 2^-5 of the map's range
    (bf16 rounded at other places, or the dots summed in another order,
    carried through 24 residual blocks). The maps are LayerNorm outputs
    (RMS 1, range 8-10), so that is about 0.3, a third of a typical value;
    the card has shown at most 1.4% of the range (map 2 against
    ``SwinBackbone``), and dropping the shift mask moves map 0 by 5% and
    maps 2-3 by 22-24% of the range (CPU emulation, two 224x160 frames).
    At initialisation the relative bias is too small to show at this
    level: ``check_swin_block`` holds it at trained scale. Times: the fused trunk, the plain
    trunk on the whole chunk (as ``detect_frames`` runs it) and frame by
    frame."""
    from unittest import mock

    from macaque_tpu_torch import kernels
    from macaque_tpu_torch.nn import swin_block
    from macaque_tpu_torch.nn.preprocess import detector_input_batch
    from macaque_tpu_torch.nn.swin_block import swin_backbone_apply_fused

    bb = det.backbone
    x = detector_input_batch(perception._rgb(
        torch.from_numpy(frames).to(perception.device)))[0]
    swin_backbone_apply_fused(bb, x)                          # warm-up
    kernels.reset_launches()
    t = time.perf_counter()
    outs = swin_backbone_apply_fused(bb, x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    log(f"fused trunk {tuple(x.shape)}: {wall:.3f}s; launches {launches}")
    if launches["swin_block"] != 24:
        raise AssertionError("the fused trunk did not launch K6 once per block")
    with torch.no_grad():
        check_maps(outs, bb(x), "fused trunk vs SwinBackbone", 2.0 ** -5)
        with mock.patch.object(swin_block, "fused_swin_block",
                               swin_block.fused_swin_block_reference):
            check_maps(outs, swin_backbone_apply_fused(bb, x),
                       "fused trunk vs its plain version", 2.0 ** -5)
        fused = cuda_ms(lambda: swin_backbone_apply_fused(bb, x), reps=3)
        batched = cuda_ms(lambda: bb(x), reps=3)
        per_frame = cuda_ms(lambda: [bb(x[i:i + 1]) for i in range(len(x))],
                            reps=3)
    log(f"trunk, 16-frame chunk: fused (K6) {fused:.3f} ms, SwinBackbone on "
        f"the chunk {batched:.3f} ms, frame by frame {per_frame:.3f} ms")
    return launches


def phase_attention_path(gen):
    """``attention()``, the JAX package's dispatcher, at (64, 192, 16, 80)
    bf16 with launches counted: it launches K4."""
    from macaque_tpu_torch import kernels
    from macaque_tpu_torch.nn.attention import attention, attention_reference

    q, k, v = (randn_bf16(gen, *ATTN_SHAPE) for _ in range(3))
    kernels.reset_launches()
    out = attention(q, k, v)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"attention path {ATTN_SHAPE}: launches {launches}")
    max_err(out, attention_reference(q, k, v), "attention path")
    return launches


def phase_split_path(gen):
    """``quant_int8_matmul_split``, the port of the JAX package's split int8
    matmul (``pallas_int8.py:149``), at ViTPose-huge's fc1 on the serving
    tier's pose chunk, with launches counted: it launches K5a, then
    ``torch._int_mm`` and the epilogue; bit for bit against the plain
    version."""
    from macaque_tpu_torch import kernels
    from macaque_tpu_torch.nn.int8 import (
        quant_int8_matmul_reference, quant_int8_matmul_split)

    K, N = VIT_LAYERS["fc1"]
    x = randn_bf16(gen, POSE_ROWS, K)
    wq, ws, b = int8_weights(gen, K, N)
    kernels.reset_launches()
    out = quant_int8_matmul_split(x, wq, ws, b)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"split int8 path ({POSE_ROWS}, {K}) x ({K}, {N}): launches {launches}")
    exact(out, quant_int8_matmul_reference(x, wq, ws, b), "split int8 path")
    return launches


# steps 2-4 at the reference rig's size: 8 cameras, 4 animals
# (CrossViewConfig.max_people), 48 detection slots a keyframe; the
# recording cut from 10 minutes at 24 fps (14,400 frames) to a third:
# there run_step2 alone took 530.7 s, 511.2 s of it 500 SVT iterations of
# 1022 ms (H100 80GB HBM3, 700 W; PERF.md section 4)
STEP2_SCENE = {"n_cam": 8, "n_animal": 4, "n_frame": 4800}
STEP2_HELD = 96       # keyframes held card against CPU in float64
STEP3_HELD = 600      # frames of step 3 held card against CPU in float64
STEP4_HELD = 240      # frames of step 4 held card against CPU in float64
# the held refinement: fifteen LM iterations of two CG sweeps. Past about
# ten sweeps CGLS amplifies rounding about fourfold a sweep (in the JAX
# package too), so two devices agree to rounding only on few sweeps
STEP4_BOUNDED = {"lm_iters": 15, "cg_iters": 2}


def step2_scene(root, n_cam, n_animal, n_frame):
    """The port's synthetic scene written as step 1 writes its output: one
    ``alldata.json`` a camera. Returns the rig and the ground-truth joints
    (A, T, 17, 3)."""
    from macaque_tpu_torch.pipeline.artifacts import write_alldata
    from macaque_tpu_torch.tools.synthetic import (
        make_test_rig, simulate_scene, synthesize_alldata)

    rig = make_test_rig(n_cam)
    kp3d = simulate_scene(n_animal, n_frame, seed=0)
    for cam_id, rows in zip(rig.camera_ids, synthesize_alldata(rig, kp3d)):
        write_alldata(os.path.join(root, cam_id), rows,
                      np.arange(n_frame, dtype=np.int32))
    return rig, kp3d


def check_step2_truth(keyframes, kp3d):
    """(b) Every written person holds one animal's track id (a + 1) in
    each camera it fills (the ghost id A + 7 never); at least 99 % of the
    (keyframe, animal) pairs are recovered; the median joint error of
    ``pose3d`` against the ground truth is below 20 mm."""
    A = kp3d.shape[0]
    found, errs = set(), []
    for kf in keyframes:
        f = kf["frame"]
        for bcomb, p3d in zip(kf["bcomb"], kf["pose3d"]):
            ids = {int(b) for b in bcomb if b >= 0}
            if len(ids) != 1 or not 1 <= min(ids) <= A:
                raise AssertionError(f"step2: frame {f}: person "
                                     f"{bcomb.tolist()} is not one animal")
            a = ids.pop() - 1
            found.add((f, a))
            e = np.linalg.norm(p3d - kp3d[a, f], axis=-1)
            errs.extend(e[np.isfinite(e)])
    share = len(found) / (len(keyframes) * A)
    med = float(np.median(errs)) if errs else float("inf")
    log(f"step2 against the ground truth: {sum(len(k['bcomb']) for k in keyframes)}"
        f" persons, each one animal; {len(found)} of {len(keyframes) * A} "
        f"(keyframe, animal) pairs recovered ({share:.4f}); median joint "
        f"error {med:.3f} mm over {len(errs)} joints")
    if share < 0.99:
        raise AssertionError(f"step2 recovered {share:.4f} < 0.99 of the pairs")
    if not med < 20.0:
        raise AssertionError(f"step2 median joint error {med:.3f} mm >= 20 mm")


def check_step2_devices(packed, rig, cfg, n_held):
    """(a) The first ``n_held`` keyframes' packed tensors through the
    affinity, ``match_svt`` and ``triangulate_poses`` on the card and on
    the CPU, both in float64: match matrices equal, W and the matched
    persons' 3D points within 1e-9 of their largest value. Returns the
    CPU's bcomb set of each keyframe."""
    from macaque_tpu_torch.pipeline.geometry3d import triangulate_poses
    from macaque_tpu_torch.pipeline.step2 import (
        affinity_and_match, bcomb_of, match_persons)

    held = {k: v if k == "cam_idx" else v[:n_held] for k, v in packed.items()}
    cams, W, match = {}, {}, {}
    for dev in ("cuda", "cpu"):
        cams[dev] = rig.omni(dev, torch.float64)
        w, m = affinity_and_match(cams[dev], held, cfg, 6)
        W[dev], match[dev] = w.cpu().numpy(), m.cpu().numpy()
    finals, kp = match_persons(cams["cpu"], held, match["cpu"], rig.n_cam,
                               cfg.n_joint)
    p3d = {dev: triangulate_poses(cam, torch.from_numpy(kp).to(cam.K.device))
           .cpu().numpy() for dev, cam in cams.items()}
    dW = np.abs(W["cuda"] - W["cpu"]).max() / np.abs(W["cpu"]).max()
    same_nan = np.array_equal(np.isnan(p3d["cuda"]), np.isnan(p3d["cpu"]))
    dP = np.nanmax(np.abs(p3d["cuda"] - p3d["cpu"])) / np.nanmax(
        np.abs(p3d["cpu"]))
    n_diff = int((match["cuda"] != match["cpu"]).sum())
    log(f"step2 card against CPU, float64, {n_held} keyframes: W rel "
        f"{dW:.3e}, match entries differing {n_diff}, {len(finals)} persons' "
        f"3D points rel {dP:.3e}, NaN pattern equal {same_nan}")
    if n_diff or not (dW <= 1e-9 and dP <= 1e-9 and same_nan):
        raise AssertionError("step2 differs between the card and the CPU")
    sets = [set() for _ in range(n_held)]
    for ti, slots in finals:
        sets[ti].add(tuple(bcomb_of(held, ti, slots, rig.n_cam).tolist()))
    return sets


def time_svt_svd(rig, packed, cfg):
    """One SVD of the SVT's shape (every keyframe's symmetric 48 x 48 first
    iterate, float32), as ``match_svt`` calls it, beside the symmetric
    eigendecomposition of the same batch: ms a call, CUDA events. Timed
    only; the port runs the SVD."""
    from macaque_tpu_torch.pipeline.step2 import _affinity_program

    cam = rig.omni("cuda", torch.float32)
    idx = torch.as_tensor(packed["cam_idx"], device="cuda")
    W = _affinity_program(
        cam, idx, torch.as_tensor(packed["pose"], dtype=torch.float32,
                                  device="cuda"),
        torch.as_tensor(packed["valid"], device="cuda"),
        torch.as_tensor(packed["cids"], device="cuda"),
        torch.tensor(cfg.alpha_id, dtype=torch.float32))
    A = W * ~torch.eye(W.shape[-1], dtype=torch.bool, device="cuda")
    A = (A + A.transpose(-1, -2)) / 2
    svd = cuda_ms(lambda: torch.linalg.svd(A, full_matrices=False), reps=3,
                  warmup=1)
    eigh = cuda_ms(lambda: torch.linalg.eigh(A), reps=3, warmup=1)
    log(f"step2: one SVD of {tuple(A.shape)} float32 {svd:.3f} ms "
        f"(torch.linalg.svd); torch.linalg.eigh of the same {eigh:.3f} ms")


def phase_step2(root, scene=STEP2_SCENE, n_held=STEP2_HELD):
    """Step 2 (cross-view keyframe matching) at full width through
    ``pipeline.step2.run_step2`` on the card in float32, from the port's
    synthetic ``alldata.json`` files written into ``root`` (where steps 3
    and 4 read them): its wall time and split, SVT iterations and host
    reads, and peak memory; then checks (a) and (b), and (c) the count of
    the held keyframes whose bcomb sets differ between the float32 card
    run and the float64 CPU run (printed, not asserted: the SVT's 0.5
    threshold can flip on rounding). Step 2 runs no hand-written kernel;
    its launches are read around the run. Returns the rig and the ground
    truth."""
    from macaque_tpu_torch import kernels
    from macaque_tpu_torch.core.config import CrossViewConfig
    from macaque_tpu_torch.pipeline.artifacts import read_pickle
    from macaque_tpu_torch.pipeline.step2 import load_keyframes, run_step2

    cfg = CrossViewConfig()
    t = time.perf_counter()
    rig, kp3d = step2_scene(root, **scene)
    log(f"step2: scene of {scene} written in "
        f"{time.perf_counter() - t:.1f}s")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times = {}
    t = time.perf_counter()
    out = run_step2(root, rig, cfg, redo=True, times=times)
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    mk = read_pickle(out)
    it = times["svt_iterations"]
    first = times["svt_first_converged"]
    log(f"step2: run_step2 {len(mk)} keyframes, M = {rig.n_cam * 6}, "
        f"J = {cfg.n_joint}, float32, in {wall:.3f}s: "
        + " ".join(f"{k}={times[k]:.4f}s" for k in (
            "read_vote", "pack", "affinity", "svt", "best_comb", "write"))
        + f"; SVT {it} iterations, {1e3 * times['svt'] / it:.3f} ms an "
        f"iteration, {times['svt_host_reads']} host reads (each keyframe "
        f"first converged by iteration median {np.median(first):.0f}, "
        f"max {first.max()}, {int((first == 0).sum())} never), "
        f"{times['svt'] / wall:.3f} of the wall; peak memory "
        f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above "
        f"the {base / 2**30:.3f} GiB held before); launches {launches}")
    check_step2_truth(mk, kp3d)
    _, packed = load_keyframes(root, rig, cfg, 6)
    time_svt_svd(rig, packed, cfg)
    cpu_sets = check_step2_devices(packed, rig, cfg, n_held)
    differ = sum(set(map(tuple, (b.tolist() for b in kf["bcomb"]))) != s
                 for kf, s in zip(mk, cpu_sets))
    log(f"step2: {differ} of the first {n_held} keyframes' bcomb sets differ "
        "between the float32 card run and the float64 CPU run")
    return rig, kp3d, wall


def check_step3_truth(trk, cid, n_animal):
    """(d) Every tracklet of ``track.pickle`` holds one animal's track id
    (a + 1) in every camera it fills, and its ``collar_id.pickle``
    identity, where it has one, is that animal's; every animal has a
    tracklet with its identity. Returns the share of (frame, animal)
    pairs up to the last keyframe that carry their identity."""
    cover = {}
    for k, t in trk.items():
        ids = {int(v) for v in np.unique(t) if v >= 0}
        if len(ids) != 1 or not 1 <= min(ids) <= n_animal:
            raise AssertionError(f"step3: tracklet {k} holds track ids "
                                 f"{sorted(ids)}, not one animal's")
        a = ids.pop() - 1
        got = {int(v) for v in np.unique(cid[k]) if v >= 0}
        if got - {a}:
            raise AssertionError(f"step3: tracklet {k} of animal {a} has "
                                 f"identity {sorted(got)}")
        rows = (t >= 0).any(1) & (cid[k] == a)
        cover[a] = cover.get(a, np.zeros_like(rows)) | rows
    if sorted(cover) != list(range(n_animal)):
        raise AssertionError(f"step3: animals {sorted(cover)} of "
                             f"{n_animal} have a tracklet with identity")
    n = len(next(iter(trk.values())))
    return sum(int(c.sum()) for c in cover.values()) / (n * n_animal)


def held_copy(root, dst, n_frame, files=(), rows=None):
    """``root``'s ``files`` in ``dst``, cut to their first ``n_frame``
    frames where they are per frame, and ``rows`` ({camera id: alldata
    rows}) cut the same way as ``alldata.json`` files."""
    from macaque_tpu_torch.pipeline.artifacts import (
        read_pickle, write_alldata, write_pickle)

    for cam_id, data in (rows or {}).items():
        write_alldata(os.path.join(dst, cam_id), data[:n_frame],
                      np.arange(n_frame, dtype=np.int32))
    for f in files:
        obj = read_pickle(os.path.join(root, f))
        if f == "match_keyframe.pickle":
            obj = [kf for kf in obj if kf["frame"] < n_frame]
        elif f == "kp2d.pickle":
            obj = obj[:, :n_frame]
        write_pickle(os.path.join(dst, f), obj)
    return dst


def check_traces(rig, rows, n_frame, n_animal=4, f32_bound_mm=None):
    """``TraceCalculator`` card against CPU in float64 (within 1e-9 of the
    largest value) and the float32 card against the float64 CPU (within
    ``f32_bound_mm`` where given), on every animal's whole-rig trace over
    the first ``n_frame`` frames."""
    from macaque_tpu_torch.pipeline.step3 import TraceCalculator

    rows = [rows[c][:n_frame] for c in rig.camera_ids]
    frames = np.arange(n_frame)
    out = {}
    for dev, dt in (("cpu", torch.float64), ("cuda", torch.float64),
                    ("cuda", torch.float32)):
        tc = TraceCalculator(rig, device=dev, dtype=dt)
        out[(dev, dt)] = np.stack([
            tc.trace(rows, np.full((n_frame, rig.n_cam), a + 1), frames)
            for a in range(n_animal)])
    want = out[("cpu", torch.float64)]
    scale = np.nanmax(np.abs(want))
    d64 = np.nanmax(np.abs(out[("cuda", torch.float64)] - want)) / scale
    d32 = np.nanmax(np.abs(out[("cuda", torch.float32)] - want))
    same = np.array_equal(np.isnan(out[("cuda", torch.float64)]),
                          np.isnan(want))
    log(f"step3: TraceCalculator on {n_animal} x {n_frame} frames, card "
        f"against CPU in float64: rel {d64:.3e}, NaN pattern equal {same}; "
        f"float32 card against float64 CPU: {d32:.4f} mm"
        + (f" (bound {f32_bound_mm})" if f32_bound_mm is not None else ""))
    if not (same and d64 <= 1e-9):
        raise AssertionError("step3 traces differ between the card and the CPU")
    if f32_bound_mm is not None and not d32 <= f32_bound_mm:
        raise AssertionError("step3 float32 traces differ between the card "
                             "and the CPU")


STEP3_PICKLES = ("track.pickle", "collar_id.pickle", "kp2d.pickle")


def step3_pickles(d):
    from macaque_tpu_torch.pipeline.artifacts import read_pickle

    return [read_pickle(os.path.join(d, f)) for f in STEP3_PICKLES]


def same_step3(a, b):
    """Two runs' ``STEP3_PICKLES`` equal: the tracklet keys, every track and
    collar-id array, and kp2d with its NaNs."""
    (ta, ca, ka), (tb, cb, kb) = a, b
    return (list(ta) == list(tb) and list(ca) == list(cb)
            and all(np.array_equal(ta[k], tb[k]) for k in tb)
            and all(np.array_equal(ca[k], cb[k]) for k in cb)
            and np.array_equal(ka, kb, equal_nan=True))


def broken_tracks_scene(n_frame=200):
    """tests/test_torch_step3.py's ``_broken_tracks_scene``, built with the
    port's synthetic tools (rows equal to the JAX generator's within
    1e-10): 4 cameras, 2 animals; animal 1 seen by camera 0 alone for
    frames 50-74 (its keyframe links break, a stitch edge bridges them) and
    camera 2's 2D track ids switch once per animal."""
    from macaque_tpu_torch.tools.synthetic import (
        make_test_rig, simulate_scene, synthesize_alldata)

    rig = make_test_rig(4, seed=0)
    rows = synthesize_alldata(rig, simulate_scene(2, n_frame, seed=1), seed=2)
    rng = np.random.default_rng(7)
    for a in range(2):
        cut = int(rng.integers(20, 180))
        for f in range(cut, n_frame):
            for d in rows[2][f]:
                if d[0] == a + 1:
                    d[0] = 100 + 10 * a + 2
    for f in range(50, 75):
        for c in range(1, 4):
            rows[c][f] = [d for d in rows[c][f] if d[0] not in (2, 110 + c)]
    return rig, rows


def check_step3_broken(root, trace_bound_mm=0.05):
    """Step 3 where tracks break, so that stitching runs: one step-2
    ``match_keyframe.pickle`` (CPU, float64) under the broken-tracks scene,
    ``run_step3`` on the card in float32 and on the CPU in float64. The card
    must solve flows and call ``TraceCalculator``; the two runs must write
    equal ``STEP3_PICKLES``; and every animal's trace, float32 card against
    float64 CPU, must agree within ``trace_bound_mm`` (float32 rounding of
    ~700 mm coordinates through the DLT: 1.2e-3 mm on the CPU's
    float32)."""
    import shutil

    from macaque_tpu_torch.pipeline.artifacts import write_alldata
    from macaque_tpu_torch.pipeline.step2 import run_step2
    from macaque_tpu_torch.pipeline.step3 import run_step3

    rig, rows = broken_tracks_scene()
    n_frame = len(rows[0])
    dirs = {dev: os.path.join(root, f"broken3_{dev}")
            for dev in ("cuda", "cpu")}
    for d in dirs.values():
        for c, cam_id in enumerate(rig.camera_ids):
            write_alldata(os.path.join(d, cam_id), rows[c],
                          np.arange(n_frame, dtype=np.int32))
    run_step2(dirs["cpu"], rig, device="cpu", dtype=torch.float64)
    shutil.copy(os.path.join(dirs["cpu"], "match_keyframe.pickle"),
                dirs["cuda"])
    got, times, walls = {}, {}, {}
    for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
        times[dev] = {}
        t = time.perf_counter()
        run_step3(dirs[dev], rig, redo=True, device=dev, dtype=dt,
                  times=times[dev])
        walls[dev] = time.perf_counter() - t
        got[dev] = step3_pickles(dirs[dev])
    equal = same_step3(got["cuda"], got["cpu"])
    card = times["cuda"]
    log(f"step3 broken-tracks scene ({rig.n_cam} cameras, 2 animals, "
        f"{n_frame} frames): card float32 run_step3 {walls['cuda']:.3f}s, "
        f"flow {card['flow_solves']} solves in {card['flow']:.4f}s, "
        f"TraceCalculator {card['trace_calls']} device calls in "
        f"{card['trace']:.4f}s, stitch {card['stitch']:.4f}s; CPU float64 "
        f"{walls['cpu']:.3f}s ({times['cpu']['flow_solves']} solves, "
        f"{times['cpu']['trace_calls']} trace calls); {len(got['cpu'][0])} "
        f"tracklets, track/collar_id/kp2d equal {equal}")
    if not (card["flow_solves"] > 0 and card["trace_calls"] > 0):
        raise AssertionError("step3 broken-tracks scene: the card solved no "
                             "flow or made no trace call")
    if not equal:
        raise AssertionError("step3 broken-tracks scene differs between the "
                             "card (float32) and the CPU (float64)")
    check_traces(rig, dict(zip(rig.camera_ids, rows)), n_frame, n_animal=2,
                 f32_bound_mm=trace_bound_mm)


def trim_scene(n_frame=60):
    """tests/test_torch_step3.py's trim scene, built with the port's
    synthetic tools: 8 cameras, 4 animals, ``n_frame`` frames, and six
    tracklets of whole-rig track ids, animal 0 in two pieces that overlap
    (frames 0-35 and 30-59), animal 2 in two pieces with a gap (0-25 and
    27-59), animals 1 and 3 whole; and their collar identities (animal 3
    unassigned, animal 2's first piece unknown)."""
    from macaque_tpu_torch.tools.synthetic import (
        make_test_rig, simulate_scene, synthesize_alldata)

    rig = make_test_rig(8, seed=0)
    rows = synthesize_alldata(rig, simulate_scene(4, n_frame, seed=1), seed=2)
    pieces = [(0, 0, 35), (0, 30, 59), (1, 0, 59), (2, 0, 25), (2, 27, 59),
              (3, 0, 59)]
    trk, cid = {}, {}
    for k, (a, lo, hi) in enumerate(pieces):
        trk[k] = -np.ones((n_frame, rig.n_cam), int)
        trk[k][lo:hi + 1] = a + 1
        cid[k] = np.full(n_frame, a if a < 3 else -1)
    cid[3][:] = -1
    return rig, rows, trk, cid


def check_step3_trim(edge_bound_mm=0.05):
    """Step 3's trims on the card: ``trim_tracklets`` with a
    ``TraceCalculator`` on the card in float32 and on the CPU in float64 on
    the trim scene (``trim_scene``), then ``build_stitch_graph`` and
    ``stitch_tracklets`` on the trimmed set. The card's trim must cut at
    least one tracklet; the trimmed tracklets and the stitched result must
    equal the CPU's; and the stitch edges (3D jump distances in mm, x0.01
    where the identities agree) must agree within ``edge_bound_mm``, the
    bound ``check_step3_broken`` holds the traces to (float32 rounding of
    ~700 mm coordinates through the DLT is ~1e-3 mm)."""
    import copy

    from macaque_tpu_torch.pipeline.step3 import (
        TraceCalculator, build_stitch_graph, stitch_tracklets, trim_tracklets)

    rig, rows, base, cid = trim_scene()
    n_frame = len(rows[0])
    got = {}
    for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
        tc = TraceCalculator(rig, device=dev, dtype=dt)
        t = time.perf_counter()
        trimmed = trim_tracklets(copy.deepcopy(base), rows, n_frame, tc)
        t_trim = time.perf_counter() - t
        edges = build_stitch_graph(trimmed, cid, rows, n_frame, tc)
        stitched = stitch_tracklets(copy.deepcopy(trimmed), cid, rows, n_frame,
                                    tc)
        got[dev] = (trimmed, edges, stitched, t_trim, tc.calls)
    (trim_c, edges_c, (trk_c, info_c), t_c, calls_c) = got["cuda"]
    (trim_h, edges_h, (trk_h, info_h), _, _) = got["cpu"]
    cut = {k: int((base[k] >= 0).any(1).sum() - (trim_c[k] >= 0).any(1).sum())
           for k in base}
    same_trim = (list(trim_c) == list(trim_h) and all(
        np.array_equal(trim_c[k], trim_h[k]) for k in trim_h))
    same_stitch = (list(trk_c) == list(trk_h) and all(
        np.array_equal(trk_c[k], trk_h[k]) for k in trk_h)
        and info_c == info_h)
    same_edges = (edges_c.shape == edges_h.shape
                  and np.array_equal(edges_c[:, :2], edges_h[:, :2]))
    d_edge = (float(np.max(np.abs(edges_c[:, 2] - edges_h[:, 2])))
              if same_edges and len(edges_h) else float("nan"))
    log(f"step3 trims ({rig.n_cam} cameras, 4 animals, {n_frame} frames, "
        f"{len(base)} tracklets): card float32 trim_tracklets {t_c:.3f}s, "
        f"frames cut {cut}; {len(edges_c)} stitch edges, card against CPU "
        f"float64 within {d_edge:.6f} mm (bound {edge_bound_mm}); "
        f"{calls_c} TraceCalculator device calls; {len(trk_c)} tracklets "
        f"after stitching; trimmed equal {same_trim}, stitched equal "
        f"{same_stitch}")
    if not any(v > 0 for v in cut.values()):
        raise AssertionError("step3 trims: the card's trim cut no tracklet")
    if not (same_trim and same_stitch and same_edges and len(edges_h)):
        raise AssertionError("step3 trims: the card (float32) differs from "
                             "the CPU (float64)")
    if not d_edge <= edge_bound_mm:
        raise AssertionError("step3 trims: stitch edges differ between the "
                             "card and the CPU")


def phase_step3(root, rig, kp3d, n_held=STEP3_HELD):
    """Step 3 (cross-frame tracklet graph) through
    ``pipeline.step3.run_step3`` on the card in float32, on the step-2
    phase's output: its split, the flow solves and ``TraceCalculator``'s
    device calls and seconds; check (d) against the ground truth; (e) the
    first ``n_held`` frames through step 3 on the card and on the CPU,
    both float64, writing equal ``track.pickle``, ``collar_id.pickle`` and
    ``kp2d.pickle``; the traces card against CPU; and the broken-tracks
    scene, where stitching runs (``check_step3_broken``); and the trim
    scene, where trims cut (``check_step3_trim``)."""
    from macaque_tpu_torch import kernels
    from macaque_tpu_torch.pipeline.artifacts import read_pickle
    from macaque_tpu_torch.pipeline.step3 import run_step3

    kernels.reset_launches()
    times = {}
    t = time.perf_counter()
    run_step3(root, rig, redo=True, times=times)
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    trk = read_pickle(os.path.join(root, "track.pickle"))
    cid = read_pickle(os.path.join(root, "collar_id.pickle"))
    log(f"step3: run_step3 {kp3d.shape[1]} frames, {rig.n_cam} cameras, "
        f"float32, in {wall:.3f}s: "
        + " ".join(f"{k}={times[k]:.4f}s" for k in (
            "read", "connect", "build", "trim", "ids", "stitch", "dedup",
            "last_one", "write"))
        + f"; flow {times['flow_solves']} solves in {times['flow']:.4f}s; "
        f"TraceCalculator {times['trace_calls']} device calls in "
        f"{times['trace']:.4f}s; {len(trk)} tracklets; launches {launches}")
    share = check_step3_truth(trk, cid, kp3d.shape[0])
    log(f"step3 against the ground truth: every tracklet one animal's, "
        f"every identity its animal's; {share:.4f} of the (frame, animal) "
        f"pairs carry their identity")
    from macaque_tpu_torch.pipeline.artifacts import read_alldata

    rows = {c: read_alldata(os.path.join(root, c))[0][:n_held]
            for c in rig.camera_ids}
    got = {}
    for dev in ("cuda", "cpu"):
        d = held_copy(root, os.path.join(root, f"held3_{dev}"), n_held,
                      ("match_keyframe.pickle",), rows)
        run_step3(d, rig, redo=True, device=dev, dtype=torch.float64)
        got[dev] = step3_pickles(d)
    equal = same_step3(got["cuda"], got["cpu"])
    log(f"step3 card against CPU, float64, {n_held} frames: "
        f"{len(got['cpu'][0])} tracklets, track/collar_id/kp2d equal {equal}")
    if not equal:
        raise AssertionError("step3 differs between the card and the CPU")
    check_traces(rig, rows, n_held)
    check_step3_broken(root)
    check_step3_trim()
    return wall


def check_step4_truth(out, kp3d, name="step4"):
    """(f) Each animal's median joint error against the ground truth under
    its own identity is below 30 mm (tests/test_four_animals.py:46,
    tests/test_eight_cameras.py:79)."""
    T = out["kp3d"].shape[1]
    for a in range(kp3d.shape[0]):
        e = np.linalg.norm(out["kp3d"][a] - kp3d[a, :T], axis=-1)
        med = float(np.nanmedian(e))
        log(f"{name} animal {a}: median joint error {med:.3f} mm, finite "
            f"joints {np.isfinite(e).mean():.4f}")
        if not med < 30.0:
            raise AssertionError(f"{name} animal {a}: median joint error "
                                 f"{med:.3f} mm >= 30 mm")


def phase_step4(root, rig, kp3d, n_held=STEP4_HELD):
    """Step 4 (Viterbi 2D filter, DLT, LM-CGLS refinement) through
    ``pipeline.step4.run_step4`` on the card in float32, on step 3's
    output: its split, LM iterations, CG sweeps, host reads and peak
    memory; check (f) against the ground truth; (g) the first ``n_held``
    frames on the card and on the CPU in float64: the same ``kp2d_f`` NaN
    pattern and values within 1e-9 of the largest, and with the held
    refinement budget equal LM iterations and CG sweeps and ``kp3d``
    within 1e-6 of its largest value; (h) with
    ``torch.backends.cuda.matmul.allow_tf32`` on, the float32 card run of
    those frames keeps ``kp3d`` within the same 1e-6."""
    from macaque_tpu_torch import kernels
    from macaque_tpu_torch.pipeline.artifacts import read_pickle
    from macaque_tpu_torch.pipeline.step4 import run_step4

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times = {}
    t = time.perf_counter()
    out = read_pickle(run_step4(root, rig, redo=True, times=times))
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"step4: run_step4 {out['kp3d'].shape[1]} frames, 4 animals, "
        f"{rig.n_cam} cameras, float32, in {wall:.3f}s: "
        + " ".join(f"{k}={times[k]:.4f}s" for k in (
            "viterbi", "dlt", "refine", "reproject", "write"))
        + f"; Viterbi {times['viterbi_frame_steps']} frame steps; LM "
        f"iterations {times['lm_iters']}, CG sweeps {times['cg_iters']} "
        f"an animal; the batch's loop {times['lm_lm_steps']} LM steps, "
        f"{times['lm_cg_sweeps']} CG sweeps, {times['lm_host_reads']} host "
        f"reads, {1e3 * times['refine'] / max(times['lm_cg_sweeps'], 1):.3f}"
        f" ms of refinement a sweep; peak "
        f"memory {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB "
        f"above the {base / 2**30:.3f} GiB held before); launches "
        f"{launches}")
    check_step4_truth(out, kp3d)

    res = {}
    for dev, dt, tf32 in (("cuda", torch.float64, False),
                          ("cpu", torch.float64, False),
                          ("cuda", torch.float32, False),
                          ("cuda", torch.float32, True)):
        d = held_copy(root, os.path.join(root, f"held4_{dev}_{dt}_{tf32}"),
                      n_held, ("kp2d.pickle",))
        flag = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            tm = {}
            run_step4(d, rig, redo=True, device=dev, dtype=dt, times=tm,
                      refine_overrides=STEP4_BOUNDED if dt == torch.float64
                      else None)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flag
        res[(dev, dt, tf32)] = (read_pickle(os.path.join(d, "kp2d_f.pickle")),
                                read_pickle(os.path.join(d, "kp3d.pickle")),
                                tm)
    (fg, og, tg), (fc, oc, tc) = (res[("cuda", torch.float64, False)],
                                  res[("cpu", torch.float64, False)])
    same_f = np.array_equal(np.isnan(fg), np.isnan(fc))
    dF = np.nanmax(np.abs(fg - fc)) / np.nanmax(np.abs(fc))
    same_k = np.array_equal(np.isnan(og["kp3d"]), np.isnan(oc["kp3d"]))
    dK = np.nanmax(np.abs(og["kp3d"] - oc["kp3d"])) / np.nanmax(
        np.abs(oc["kp3d"]))
    same_it = (tg["lm_iters"], tg["cg_iters"]) == (tc["lm_iters"],
                                                   tc["cg_iters"])
    log(f"step4 card against CPU, float64, {n_held} frames: kp2d_f NaN "
        f"pattern equal {same_f}, rel {dF:.3e}; held refinement "
        f"{STEP4_BOUNDED}: LM iterations {tg['lm_iters']} / {tc['lm_iters']},"
        f" CG sweeps {tg['cg_iters']} / {tc['cg_iters']}, kp3d NaN pattern "
        f"equal {same_k}, rel {dK:.3e}")
    if not (same_f and dF <= 1e-9 and same_k and dK <= 1e-6 and same_it):
        raise AssertionError("step4 differs between the card and the CPU")
    k0 = res[("cuda", torch.float32, False)][1]["kp3d"]
    k1 = res[("cuda", torch.float32, True)][1]["kp3d"]
    dT = np.nanmax(np.abs(k1 - k0)) / np.nanmax(np.abs(k0))
    log(f"step4 float32 card, {n_held} frames, with allow_tf32 against "
        f"without: NaN pattern equal {np.array_equal(np.isnan(k0), np.isnan(k1))}"
        f", kp3d rel {dT:.3e}")
    if not (np.array_equal(np.isnan(k0), np.isnan(k1)) and dT <= 1e-6):
        raise AssertionError("step4 follows allow_tf32")
    return wall


PIPELINE_SCENE = {"n_cam": 8, "n_animal": 4, "n_frame": 240}  # 10 s, 24 fps
PIPELINE_CHUNK = 120     # frames an RGBA chunk: 2 chunks a store
FULL_FRAMES = 32         # 2048x1536 frames through run_step1 (check v)
STAGES = ("step1_2d", "step2_crossview", "step3_crossframe", "step4_3d")
ARTIFACTS = ("match_keyframe.pickle", "track.pickle", "collar_id.pickle",
             "kp2d.pickle", "kp2d_f.pickle", "kp3d.pickle", "config.toml",
             "calibration.toml")
COINCIDE_PX = 5.0        # two animals' projected centroids this close
                         # coincide in that view (check i)


def entry_animal(rows, fnums, proj, c, f, tid):
    """The animal whose projected joints the ``alldata.json`` box of track
    ``tid`` in row ``f`` of camera ``c`` is centred nearest (the rule by
    which the oracle perception chose the keypoints it gave the box), or
    None where another animal's projected centroid lies within
    ``COINCIDE_PX`` of that one's in that view (the oracle's choice between
    them is arbitrary)."""
    box = next(r[1:5] for r in rows[c][f] if r[0] == tid)
    cen = np.nanmean(proj[c, :, int(fnums[c][f])], axis=1)       # (A, 2)
    d = np.sum((cen - [(box[0] + box[2]) / 2, (box[1] + box[3]) / 2]) ** 2,
               axis=1)
    a = int(np.nanargmin(d))
    sep = np.linalg.norm(cen - cen[a], axis=1)
    sep[a] = np.inf
    return None if np.nanmin(sep) < COINCIDE_PX else a


def check_pipeline_tracklets(rd, rig, proj):
    """(i) Every tracklet of ``track.pickle`` is one animal's: each
    (frame, camera) entry's ``alldata.json`` box is centred nearest that
    animal's projected joints in that frame, the rule by which the oracle
    perception chose the keypoints it gave the box. Entries where another
    animal's projected centroid lies within ``COINCIDE_PX`` of that one's
    are skipped: the two coincide in that view and the oracle's choice
    between them is arbitrary. Returns the tracklets, the animals that own
    one, and the entries seen and skipped."""
    from macaque_tpu_torch.pipeline.artifacts import read_alldata, read_pickle

    rows, fnums = zip(*(read_alldata(os.path.join(rd, c))
                        for c in rig.camera_ids))
    trk = read_pickle(os.path.join(rd, "track.pickle"))
    owners, n, skipped = set(), 0, 0
    for k, t in trk.items():
        got = [entry_animal(rows, fnums, proj, c, f, int(t[f, c]))
               for f, c in zip(*np.nonzero(t >= 0))]
        n += len(got)
        skipped += got.count(None)
        got = set(got) - {None}
        if len(got) != 1:
            raise AssertionError(f"pipeline: tracklet {k} spans animals "
                                 f"{sorted(got)}")
        owners |= got
    if owners != set(range(proj.shape[1])):
        raise AssertionError(f"pipeline: only animals {sorted(owners)} own "
                             "a tracklet")
    return len(trk), owners, n, skipped


def pipeline_run(cfg, rig, factory):
    """run_pipeline on the card, render off; returns its wall, stdout and
    the manifest it wrote."""
    import contextlib
    import io

    from macaque_tpu_torch.pipeline.runner import run_pipeline

    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rd = run_pipeline(cfg, rig, factory, render=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    with open(os.path.join(rd, "run_manifest.json")) as f:
        manifest = json.load(f)
    if sorted(manifest) != sorted(STAGES) or any(
            v["calls"] != 1 for v in manifest.values()):
        raise AssertionError(f"pipeline: run_manifest.json {manifest}")
    return rd, wall, out.getvalue(), manifest


def check_overlay_points(rd, rig):
    """(iii) ``overlay_points`` for every camera on the card against the
    CPU, both float64: pixels within 1e-6, NaN patterns and draw masks
    equal."""
    from macaque_tpu_torch.pipeline.artifacts import read_pickle
    from macaque_tpu_torch.tools.visualize import overlay_points

    data = read_pickle(os.path.join(rd, "kp3d.pickle"))
    worst = 0.0
    for c in range(rig.n_cam):
        pg, mg = overlay_points(data, rig, c, "cuda", torch.float64)
        pc, mc = overlay_points(data, rig, c, "cpu", torch.float64)
        if not (np.array_equal(np.isnan(pg), np.isnan(pc))
                and np.array_equal(mg, mc)):
            raise AssertionError(f"overlay_points camera {c}: NaN pattern or "
                                 "draw mask differs between card and CPU")
        worst = max(worst, float(np.nanmax(np.abs(pg - pc))))
    log(f"pipeline (iii): overlay_points on {rig.n_cam} cameras x "
        f"{pg.shape[0]} animals x {pg.shape[1]} frames, card against CPU in "
        f"float64: |d| {worst:.3e} px, draw masks equal")
    if not worst <= 1e-6:
        raise AssertionError("overlay_points differs between card and CPU")
    log("pipeline: the render's cv2 drawing and mp4v encoding are not run on "
        "the card (its machine has no cv2); tier-1 holds them on the CPU "
        "(tests/test_torch_runner.py)")


def check_full_width_store(root, perception):
    """(v) ``FULL_FRAMES`` 2048x1536 frames written as an RGBA store and
    read by ``run_step1`` through the parity ``TorchPerception``: its rows
    equal ``process_camera`` on the same frames in memory, and K1 and K2
    launch in the store run. Returns that run's launches."""
    from macaque_tpu_torch import kernels
    from macaque_tpu_torch.core.config import Step1Config
    from macaque_tpu_torch.pipeline.artifacts import read_alldata
    from macaque_tpu_torch.pipeline.step1 import process_camera, run_step1
    from macaque_tpu_torch.video.imgstore import write_imgstore
    from macaque_tpu_torch.video.timegrid import make_time_grid

    frames = synthetic_frames(FULL_FRAMES)
    t = time.perf_counter()
    write_imgstore(os.path.join(root, "full", "cage.cam0"), frames,
                   fourcc="RGBA", chunksize=16)
    wrote = time.perf_counter() - t
    kernels.reset_launches()
    t = time.perf_counter()
    run_step1("cage", os.path.join(root, "out"), os.path.join(root, "full"),
              perception, chunk=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    store = MemoryStore(frames)
    T = make_time_grid(store.ftimes, 24.0)
    process_camera(store, os.path.join(root, "mem"), T, perception,
                   Step1Config(), chunk=16, redo=True)
    got, fn_got = read_alldata(os.path.join(root, "out", "cage", "cam0"))
    want, fn_want = read_alldata(os.path.join(root, "mem"))
    n_det = sum(len(r) for r in got)
    log(f"pipeline (v): {FULL_FRAMES} frames of 2048x1536 written as an RGBA "
        f"store in {wrote:.3f}s; run_step1 through the parity perception "
        f"{len(got)} rows in {wall:.3f}s, {n_det} animal entries; launches "
        f"{launches}; rows equal to process_camera in memory: {got == want}")
    if got != want or not np.array_equal(fn_got, fn_want) or n_det == 0:
        raise AssertionError("pipeline: run_step1 on the RGBA store differs "
                             "from process_camera on the same frames")
    for k in ("packed_attention", "roi_align_windowed"):
        if launches[k] <= 0:
            raise AssertionError(f"pipeline: run_step1 never launched {k}")
    return launches


def pipeline_stores(root, scene=PIPELINE_SCENE):
    """The port's synthetic scene (the reference rig's 8 cameras, 4 animals,
    10 s at 24 fps) rendered as RGBA imgstores of 640x480 in 2 chunks each
    under ``root/videos``. Returns (rig, kp3d, proj, raw)."""
    from macaque_tpu_torch.tools.synthetic import (
        make_test_rig, project_scene, render_stores, simulate_scene)

    rig = make_test_rig(scene["n_cam"])
    kp3d = simulate_scene(scene["n_animal"], scene["n_frame"], seed=1)
    proj = project_scene(rig, kp3d)
    raw = os.path.join(root, "videos")
    t = time.perf_counter()
    render_stores(raw, "synth", rig, proj, fourcc="RGBA",
                  chunksize=PIPELINE_CHUNK)
    wrote = time.perf_counter() - t
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(raw) for f in fs)
    log(f"pipeline scene: {rig.n_cam} RGBA stores of {scene['n_frame']} "
        f"frames of 640x480 ({size / 1e9:.3f} GB) drawn and written in "
        f"{wrote:.3f}s")
    return rig, kp3d, proj, raw


def phase_pipeline(perception, root, rig, kp3d, proj, raw):
    """``pipeline.runner.run_pipeline`` end to end on the card: the stores
    of :func:`pipeline_stores`, steps 1-4 with the oracle
    ``SyntheticPerception``, float32, render off (the card has no cv2).
    Checks: (i) every artifact, the manifest's four stages, every tracklet
    one animal's, each animal's median joint error below 30 mm; (ii) a
    second call skips every stage and rewrites no artifact; (iii)
    ``overlay_points`` card against CPU; (iv) the RGBA reader gives the
    frames drawn; (v) a full-width camera through the real networks from an
    RGBA store. Returns the launches of (v)."""
    from macaque_tpu_torch.core.config import PipelineConfig
    from macaque_tpu_torch.tools.synthetic import (
        SyntheticPerception, draw_frames)
    from macaque_tpu_torch.video.imgstore import ImgStoreReader

    t0 = time.perf_counter()

    def factory(cam_name):
        return SyntheticPerception(rig.camera_ids.index(cam_name), proj,
                                   noise=1.0)

    cfg = PipelineConfig(data_name="synth", raw_data_dir=raw,
                         results_dir=os.path.join(root, "results"))
    rd, wall, _, manifest = pipeline_run(cfg, rig, factory)
    log(f"pipeline (i): run_pipeline {wall:.3f}s: " + " ".join(
        f"{k}={v['total_s']:.4f}s" for k, v in manifest.items()))
    missing = [f for f in ARTIFACTS if not os.path.exists(
        os.path.join(rd, f))] + [
        os.path.join(c, f) for c in rig.camera_ids
        for f in ("alldata.json", "frame_num.npy")
        if not os.path.exists(os.path.join(rd, c, f))]
    if missing:
        raise AssertionError(f"pipeline: missing artifacts {missing}")
    n_trk, owners, n, skipped = check_pipeline_tracklets(rd, rig, proj)
    log(f"pipeline (i): {n_trk} tracklets, each one animal's, covering "
        f"animals {sorted(owners)}; {n} (frame, camera) entries, "
        f"{skipped} skipped where two animals' centroids coincide within "
        f"{COINCIDE_PX} px")
    from macaque_tpu_torch.pipeline.artifacts import read_pickle

    check_step4_truth(read_pickle(os.path.join(rd, "kp3d.pickle")), kp3d,
                      "pipeline (i)")

    stamps = {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
              for d, _, fs in os.walk(rd) for f in fs
              if f != "run_manifest.json"}
    _, wall2, text, manifest2 = pipeline_run(cfg, rig, factory)
    skips = text.count("skip (exists)")
    changed = [p for p, m in stamps.items() if os.stat(p).st_mtime_ns != m]
    log(f"pipeline (ii): the second call {wall2:.3f}s, {skips} stages "
        f"skipped of {rig.n_cam + 3}, {len(changed)} of {len(stamps)} "
        "artifacts rewritten")
    if skips != rig.n_cam + 3 or changed:
        raise AssertionError("pipeline: the second call redid work")

    check_overlay_points(rd, rig)

    store = ImgStoreReader(os.path.join(raw, f"synth.{rig.camera_ids[0]}"))
    drawn = draw_frames(proj, 0)
    same = all(np.array_equal(store.get_image(frame_index=i)[0], drawn[i])
               for i in range(len(drawn)))
    store.close()
    log(f"pipeline (iv): the RGBA reader gives the {len(drawn)} frames "
        f"drawn for camera {rig.camera_ids[0]}: {same}")
    if not same:
        raise AssertionError("pipeline: RGBA store frames differ")

    launches = check_full_width_store(root, perception)
    log(f"pipeline: phase {time.perf_counter() - t0:.1f}s")
    return launches


TRACKER_CHUNKS, TRACKER_T = 10, 32   # check (a): 10 chunks of 32 frames
TRACKER_ANIMALS, TRACKER_SLOTS, TRACKER_CAPACITY = 8, 8, 16


def tracker_detections(n_animal=TRACKER_ANIMALS,
                       n_frame=TRACKER_CHUNKS * TRACKER_T, max_det=TRACKER_SLOTS):
    """One camera's oracle detections of an ``n_animal`` synthetic scene, as
    step 1 hands them to the tracker: (boxes (T, D, 4), scores (T, D)) with
    scores at or below ``score_thr`` zeroed."""
    from macaque_tpu_torch.core.config import Step1Config
    from macaque_tpu_torch.tools.synthetic import (
        IMG_H, IMG_W, SyntheticPerception, encode_index, make_test_rig,
        project_scene, simulate_scene)

    # the scene holds up to 4 animals: two of them, the second moved 0.35 m
    half = n_animal // 2
    kp3d = np.concatenate([simulate_scene(half, n_frame, seed=3),
                           simulate_scene(n_animal - half, n_frame, seed=4)
                           + [250.0, 250.0, 0.0]])
    proj = project_scene(make_test_rig(1), kp3d)
    oracle = SyntheticPerception(0, proj, noise=1.0, max_det=max_det)
    boxes, scores = [], []
    for t0 in range(0, n_frame, TRACKER_T):
        frames = np.zeros((min(TRACKER_T, n_frame - t0), IMG_H, IMG_W, 3),
                          np.uint8)
        for i, f in enumerate(frames):
            encode_index(f, t0 + i)
        b, sc = oracle.detect(frames)
        boxes.append(b)
        scores.append(sc)
    boxes, scores = np.concatenate(boxes), np.concatenate(scores)
    thr = Step1Config().score_thr
    return boxes, np.where(scores > thr, scores, 0.0)


def track_chunks(device, dtype, boxes, scores):
    """``track_chunk_device`` over the chunks with the table carried:
    (boxes (T, K, 4) float64, ids (T, K), seconds per chunk, host reads)."""
    from macaque_tpu_torch.tracking import make_table, track_chunk_device

    table = make_table(TRACKER_CAPACITY, device=device, dtype=dtype)
    stats = {"host_reads": 0}
    out_b, out_t, secs = [], [], []
    for t0 in range(0, len(boxes), TRACKER_T):
        t = time.perf_counter()
        table, b, ids = track_chunk_device(table, boxes[t0:t0 + TRACKER_T],
                                           scores[t0:t0 + TRACKER_T],
                                           stats=stats)
        out_b.append(b.cpu().double())
        out_t.append(ids.cpu())
        secs.append(time.perf_counter() - t)
    return torch.cat(out_b), torch.cat(out_t), secs, stats["host_reads"]


def check_step1_tracks(rd, rig, proj, name):
    """Every step-1 track of every camera is one animal's (the rule of
    check (i) of the pipeline phase, per ``alldata.json`` entry). Returns
    (tracks, entries, entries skipped where two animals coincide)."""
    from macaque_tpu_torch.pipeline.artifacts import read_alldata

    rows, fnums = zip(*(read_alldata(os.path.join(rd, c))
                        for c in rig.camera_ids))
    n_trk = n = skipped = 0
    for c in range(rig.n_cam):
        owner = {}
        for f, row in enumerate(rows[c]):
            for r in row:
                a = entry_animal(rows, fnums, proj, c, f, r[0])
                n += 1
                if a is None:
                    skipped += 1
                    continue
                if owner.setdefault(r[0], a) != a:
                    raise AssertionError(f"tracker ({name}): camera {c} track "
                                         f"{r[0]} spans animals {owner[r[0]]} "
                                         f"and {a}")
        n_trk += len(owner)
    return n_trk, n, skipped, fnums


def phase_tracker(root, rig, kp3d, proj, raw):
    """The on-device tracker (``tracking/device_tracker.py``). (a) The card
    against the CPU: ``track_chunk_device`` on one camera's oracle
    detections of an 8-animal scene (max_det 8, capacity 16), 10 chunks of
    32 frames with the table carried, float32 on the card against float64
    on the CPU: equal track ids, boxes within 1e-3 px. (b) Both trackers
    end to end: ``run_step1`` with the oracle perception on the pipeline
    scene's RGBA stores, with ``use_device_tracker`` (its table on the
    card) and with the host tracker: the same frame numbers, every track
    one animal's."""
    import contextlib
    import io
    import re

    from macaque_tpu_torch.pipeline.step1 import run_step1
    from macaque_tpu_torch.tools.synthetic import SyntheticPerception

    t0 = time.perf_counter()
    boxes, scores = tracker_detections()
    bg, ig, sg, reads_g = track_chunks("cuda", torch.float32, boxes, scores)
    bc, ic, sc, reads_c = track_chunks("cpu", torch.float64, boxes, scores)
    same_ids = torch.equal(ig, ic)
    nan_same = torch.equal(torch.isnan(bg), torch.isnan(bc))
    err = float(np.nanmax(np.abs((bg - bc).numpy()))) if nan_same else np.inf
    n_tracks = len(set(ic[ic >= 0].tolist()))
    log(f"tracker (a): {len(boxes)} frames, {int((scores > 0).sum())} "
        f"detections of {TRACKER_ANIMALS} animals, {n_tracks} tracks; card "
        f"float32 {np.median(sg):.3f} s/chunk (first {sg[0]:.3f}), CPU float64 "
        f"{np.median(sc):.3f} s/chunk; assignment host reads "
        f"{reads_g} ({reads_g / len(boxes):.1f} a frame); ids equal "
        f"{same_ids}, boxes |d| {err:.3e} px")
    if not (same_ids and nan_same and err <= 1e-3 and n_tracks > 0):
        raise AssertionError("tracker (a): the card's tracks differ from the "
                             "CPU's")

    walls, fn = {}, {}
    for dev_tracker in (True, False):
        name = "device" if dev_tracker else "host"
        out = os.path.join(root, f"tracker_{name}")

        def factory(cam_name):
            return SyntheticPerception(rig.camera_ids.index(cam_name), proj,
                                       noise=1.0, device="cuda")

        text = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(text):
            run_step1("synth", out, raw, factory,
                      use_device_tracker=dev_tracker)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
        # each camera's summary line holds its "track" stage seconds
        track = sum(map(float, re.findall(r"track=([0-9.]+)s",
                                          text.getvalue())))
        n_trk, n, skipped, fn[name] = check_step1_tracks(
            os.path.join(out, "synth"), rig, proj, name)
        chunks = rig.n_cam * -(-len(fn[name][0]) // 32)
        log(f"tracker (b): run_step1 with the {name} tracker "
            f"{walls[name]:.3f}s over {rig.n_cam} cameras x "
            f"{len(fn[name][0])} frames, its track stage {track:.3f}s = "
            f"{track / chunks:.4f} s a 32-frame chunk; {n_trk} tracks, each "
            f"one animal's; {n} entries, {skipped} skipped where two animals "
            "coincide")
    if not all(np.array_equal(a, b) for a, b in zip(fn["device"], fn["host"])):
        raise AssertionError("tracker (b): frame numbers differ")
    log(f"tracker: phase {time.perf_counter() - t0:.1f}s")


TRAIN_FULL = {
    "pose": dict(crops=64, steps=6),            # ViTPose-huge, 256x192
    "id": dict(crops=64, size=224, steps=6),    # ResNet-152, id_crops' size
    "det": dict(images=2, hw=(608, 800), gt=4, proposals=512, steps=4),
    "ae": dict(frames=4800, joints=17, epochs=300),
}


def median_step(times):
    """The median seconds of steps 2 to the end (the first one warms)."""
    return float(np.median(times[1:]))


def train_loop(name, step, state, batch, n_steps):
    """``step`` from ``state`` twice (the first loss must repeat: the step
    is deterministic), then ``n_steps`` steps on the one batch. Returns the
    losses and the seconds of each step."""
    first = [float(step(*state, *batch)[-1]) for _ in range(2)]
    torch.cuda.synchronize()
    if first[0] != first[1]:
        raise AssertionError(f"train ({name}): the first step's loss "
                             f"{first[0]!r} did not repeat: {first[1]!r}")
    losses, secs = [], []
    for _ in range(n_steps):
        t = time.perf_counter()
        *state, loss = step(*state, *batch)
        losses.append(float(loss))          # one host read: the step's end
        secs.append(time.perf_counter() - t)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"train ({name}): losses {losses}")
    return losses, secs


def train_pose(dev, sizes):
    """ViTPose(-huge) in bf16 with float32 parameters, the layer-decay AdamW
    with ``pose_lr_schedule`` (5e-4, a 5-step warmup), ``sizes["steps"]``
    steps on one batch of random crops with UDP targets of random keypoints.
    Returns (losses, step seconds, peak bytes, parameter count)."""
    from macaque_tpu_torch.nn import ViTPose, VitPoseConfig
    from macaque_tpu_torch.nn import train as tr

    torch.cuda.reset_peak_memory_stats()
    torch.manual_seed(10)
    cfg = VitPoseConfig(compute_dtype=torch.bfloat16)
    model = ViTPose(cfg, device=dev)
    params, stats = tr.train_state(model)
    opt = tr.make_pose_optimizer(
        params, num_layers=cfg.depth,
        schedule=tr.pose_lr_schedule(5e-4, warmup_steps=5))
    gen = torch.Generator(device=dev).manual_seed(11)
    B, (H, W) = sizes["crops"], cfg.img_size
    crops = torch.randn((B, H, W, 3), generator=gen, device=dev)
    kps = torch.rand((B, 17, 2), generator=gen, device=dev) \
        * torch.tensor([W - 1.0, H - 1.0], device=dev)
    visible = (torch.rand((B, 17), generator=gen, device=dev) > 0.1).float()
    losses, secs = train_loop("pose", tr.make_pose_train_step(model, opt),
                              [params, stats, opt.init(params)],
                              (crops, kps, visible), sizes["steps"])
    return losses, secs, torch.cuda.max_memory_allocated(), \
        sum(p.numel() for p in params.values())


def train_id(dev, sizes):
    """ResNet(-152) in bf16 with float32 parameters, AdamW (1e-4, wd 1e-4),
    the label-smoothing loss with the reference class weights, on random
    224x224 crops with random labels."""
    from macaque_tpu_torch.nn import ResNetClassifier, ResNetConfig
    from macaque_tpu_torch.nn import optim
    from macaque_tpu_torch.nn import train as tr

    torch.cuda.reset_peak_memory_stats()
    torch.manual_seed(12)
    model = ResNetClassifier(ResNetConfig(compute_dtype=torch.bfloat16),
                             device=dev)
    params, stats = tr.train_state(model)
    opt = optim.adamw(1e-4)
    gen = torch.Generator(device=dev).manual_seed(13)
    B, S = sizes["crops"], sizes["size"]
    images = torch.randn((B, S, S, 3), generator=gen, device=dev)
    labels = torch.randint(0, 6, (B,), generator=gen, device=dev)
    losses, secs = train_loop(
        "id", tr.make_id_train_step(model, opt, tr.ID_CLASS_WEIGHTS),
        [params, stats, opt.init(params)], (images, labels), sizes["steps"])
    return losses, secs, torch.cuda.max_memory_allocated()


def train_detection(dev, sizes):
    """Swin-S Mask R-CNN in bf16 with float32 parameters (the plain Swin
    attention, the plain RoIAlign), ``make_detection_optimizer``, on
    ``images`` random images with ``gt`` bright boxes each, one JAX key for
    every step (the same samples while the proposals stay)."""
    from macaque_tpu_torch.nn import DetectorConfig, SwinMaskRCNN
    from macaque_tpu_torch.nn import train as tr
    from macaque_tpu_torch.nn.swin import SwinConfig
    from macaque_tpu_torch.utils.threefry import prng_key

    torch.cuda.reset_peak_memory_stats()
    torch.manual_seed(14)
    bf16 = torch.bfloat16
    model = SwinMaskRCNN(DetectorConfig(swin=SwinConfig(compute_dtype=bf16),
                                        compute_dtype=bf16), device=dev)
    params, _ = tr.train_state(model)
    opt = tr.make_detection_optimizer(params)
    rng = np.random.default_rng(15)
    B, (H, W), G = sizes["images"], sizes["hw"], sizes["gt"]
    images = rng.normal(0, 0.3, (B, H, W, 3)).astype(np.float32)
    gt = np.zeros((B, G, 4), np.float32)
    for b in range(B):
        for g in range(G):
            w, h = rng.uniform(0.1, 0.3) * W, rng.uniform(0.1, 0.3) * H
            x, y = rng.uniform(0, W - w), rng.uniform(0, H - h)
            gt[b, g] = [x, y, x + w, y + h]
            images[b, int(y):int(y + h), int(x):int(x + w)] += 1.5
    step = tr.make_detection_train_step(model, opt,
                                        num_proposals=sizes["proposals"])

    def loss_step(params, opt_state, *batch):
        params, opt_state, metrics = step(params, opt_state, *batch)
        return params, opt_state, metrics["loss"]

    batch = (prng_key(16), torch.from_numpy(images).to(dev),
             torch.from_numpy(gt).to(dev),
             torch.ones((B, G), dtype=torch.bool, device=dev))
    losses, secs = train_loop("detection", loss_step,
                              [params, opt.init(params)], batch,
                              sizes["steps"])
    return losses, secs, torch.cuda.max_memory_allocated()


def train_ae(dev, sizes):
    """The autoencoder score filter on random scores with correlated
    occlusions; the loss before and after training."""
    from macaque_tpu_torch.filters.autoencoder import (
        _forward, train_autoencoder)

    rng = np.random.default_rng(17)
    n, J = sizes["frames"], sizes["joints"]
    scores = rng.uniform(0.55, 1.0, (n, J))
    hidden = rng.uniform(0, 1, n) < 0.3
    scores[hidden, 1::2] = rng.uniform(0, 0.4, (hidden.sum(), J // 2))
    x = torch.from_numpy((scores > 0.5).astype(np.float32)).to(dev)

    def bce(p):
        pred = _forward(p, x)
        return float(-torch.mean(x * torch.log(pred + 1e-7)
                                 + (1 - x) * torch.log(1 - pred + 1e-7)))

    before = bce(train_autoencoder(scores, epochs=0, device=dev))
    t = time.perf_counter()
    params = train_autoencoder(scores, epochs=sizes["epochs"], device=dev)
    after = bce(params)
    secs = time.perf_counter() - t
    if not (np.isfinite(after) and after < before):
        raise AssertionError(f"train (autoencoder): loss {before} -> {after}")
    return before, after, secs


def check_small_pose_step():
    """A small-width float32 pose step on the card against the CPU's: loss
    and parameters within 1e-4 relative (TF32 is off)."""
    from macaque_tpu_torch.nn import ViTPose, VitPoseConfig
    from macaque_tpu_torch.nn import train as tr

    cfg = VitPoseConfig(img_size=(64, 48), embed_dim=64, depth=2, num_heads=4,
                        deconv_channels=(32, 32))
    torch.manual_seed(18)
    sd = ViTPose(cfg, device="cpu").state_dict()
    rng = np.random.default_rng(19)
    batch = (rng.normal(0, 1, (4, 64, 48, 3)).astype(np.float32),
             rng.uniform(8, 40, (4, 17, 2)).astype(np.float32),
             np.ones((4, 17), np.float32))
    out = {}
    # cuDNN's default backward algorithms sum with atomics: this float32
    # step then varies run to run on the card (7.85e-05 to 1.31e-04 of each
    # tensor's largest value against the CPU, bound 1e-4); deterministic
    # ones give 9.20e-05 every time. Only this check asks for them.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for dev in ("cpu", "cuda"):
            model = ViTPose(cfg, device=dev)
            model.load_state_dict(sd)
            params, stats = tr.train_state(model)
            opt = tr.make_pose_optimizer(params, num_layers=2)
            params, stats, _, loss = tr.make_pose_train_step(model, opt)(
                params, stats, opt.init(params),
                *(torch.from_numpy(a).to(dev) for a in batch))
            out[dev] = float(loss), {k: v.cpu()
                                     for k, v in {**params, **stats}.items()}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (lc, pc), (lg, pg) = out["cpu"], out["cuda"]
    rel = max(float((pg[k] - v).abs().max()) / max(float(v.abs().max()), 1e-30)
              for k, v in pc.items())
    log(f"train: small-width float32 pose step card against CPU: loss "
        f"{lg:.7f} / {lc:.7f}, parameters and statistics within {rel:.2e} of "
        "each tensor's largest value")
    if not (abs(lg - lc) <= 1e-4 * abs(lc) and rel <= 1e-4):
        raise AssertionError("train: the card's pose step differs from the CPU's")


def phase_train(sizes=TRAIN_FULL):
    """The trainers at full width on the card: ViTPose-huge (64 crops), the
    ResNet-152 ID classifier (64 crops), the Swin-S Mask R-CNN (2 images of
    608x800) and the autoencoder filter (4,800 frames). Checks: every loss
    finite, each model's last loss below its first, the first step's loss
    repeated from the same state, ``kernels.LAUNCHES`` unchanged (no
    hand-written kernel on a training path), and a small-width pose step
    card against CPU."""
    from macaque_tpu_torch import kernels

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    before = dict(kernels.LAUNCHES)
    gib = 2.0 ** 30
    losses, secs, peak, n_params = train_pose(dev, sizes["pose"])
    s = median_step(secs)
    B = sizes["pose"]["crops"]
    flop = 6 * n_params * B * 192 + 3 * 4 * 32 * B * 16 * 192 ** 2 * 80
    log(f"train (pose): ViTPose-huge {n_params / 1e9:.3f} G parameters, {B} "
        f"crops of 256x192, bf16 compute, float32 parameters: losses "
        f"{[round(x, 6) for x in losses]}; {s:.4f} s/step (median of steps "
        f"2-{len(secs)}), {B / s:.1f} crops/s, peak {peak / gib:.2f} GiB; "
        f"bound {flop / 1e12:.1f} TFLOP at {BF16_FLOP_PER_S / 1e12:.0f} "
        f"TFLOP/s = {flop / BF16_FLOP_PER_S:.4f} s/step")
    torch.cuda.empty_cache()
    losses, secs, peak = train_id(dev, sizes["id"])
    s = median_step(secs)
    B = sizes["id"]["crops"]
    log(f"train (id): ResNet-152, {B} crops of {sizes['id']['size']}^2: "
        f"losses {[round(x, 6) for x in losses]}; {s:.4f} s/step, "
        f"{B / s:.1f} crops/s, peak {peak / gib:.2f} GiB")
    torch.cuda.empty_cache()
    losses, secs, peak = train_detection(dev, sizes["det"])
    s = median_step(secs)
    B = sizes["det"]["images"]
    log(f"train (detection): Swin-S Mask R-CNN, {B} images of "
        f"{sizes['det']['hw']} with {sizes['det']['gt']} gt boxes, "
        f"{sizes['det']['proposals']} proposals: losses "
        f"{[round(x, 6) for x in losses]}; {s:.4f} s/step, {B / s:.2f} "
        f"images/s, peak {peak / gib:.2f} GiB")
    torch.cuda.empty_cache()
    b, a, secs = train_ae(dev, sizes["ae"])
    log(f"train (autoencoder): {sizes['ae']['frames']} frames x "
        f"{sizes['ae']['joints']} scores, {sizes['ae']['epochs']} epochs in "
        f"{secs:.3f}s: loss {b:.6f} -> {a:.6f}")
    check_small_pose_step()
    if kernels.LAUNCHES != before:
        raise AssertionError(f"train: kernels launched while training: "
                             f"{before} -> {kernels.LAUNCHES}")
    log(f"train: kernels.LAUNCHES unchanged across the phase; phase "
        f"{time.perf_counter() - t0:.1f}s")


# ------------------------------------------------------------ calibration

# The reference rig (SURVEY L6): 8 omnidir cameras at 2048x1536, the ring of
# tools/synthetic.py::make_test_rig with its 640x480 intrinsics scaled 3.2x.
# Intrinsics: one camera, the reference's 9x6 board (mct:34-35) of 23 mm
# squares, in 10 views (the reference gives no count; cut from 60 for the
# time limit: the float64 fisheye fit of this scene converges at 10 views
# and runs its 400-sweep cap every LM step at 20 and at 60, while the
# omnidir fit and the float32 fisheye fit run their whole budgets at any
# count) with 0.1 px noise.
# Marker BA: the cube-centre trace of a 310 s recording at 24 fps sampled
# every 5th frame with 5 s cut at each end (workflow.py:388-391): 1,440
# points, 0.2 px noise, 5 % of detections dropped, cameras 1-7 perturbed as
# tests/test_calib_workflow.py's marker_scene. Facade: one animal's 17
# joints over 240 frames, 2 px noise, a decoy candidate 40-80 px away.
CALIB_FULL = {"cams": 8, "views": 10, "trace": 1440, "frames": 240,
              "iter_rounds": 10, "iter_samples": 1000}
CALIB_SHORT = (15, 2)          # the tier-1 tests' short budget
CALIB_SCALE = 3.2              # 640x480 -> 2048x1536
BOARD_NOISE, TRACE_NOISE = 0.1, 0.2
FISHEYE_D = np.array([-0.015, 0.006, 0.0, 0.0])


def full_size_rig(n_cam, seed=0):
    """``n_cam`` of the synthetic ring's omnidir cameras at the reference
    rig's 2048x1536."""
    from macaque_tpu_torch.tools.synthetic import make_test_rig

    rig = make_test_rig(n_cam, seed)
    rig.K = rig.K.copy()
    rig.K[:, :2] *= CALIB_SCALE
    rig.size = (2048, 1536)
    return rig


def calib_scene(sizes, seed=0):
    """The phase's numpy inputs, made from ``seed`` with the port's float64
    projections on the CPU."""
    from macaque_tpu_torch.calib.boards import chessboard_object_points
    from macaque_tpu_torch.cameras.fisheye import (
        FisheyeCamera, fisheye_project)
    from macaque_tpu_torch.cameras.omnidir import (
        OmnidirCamera, omnidir_project)
    from macaque_tpu_torch.tools.synthetic import simulate_scene

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64))

    rng = np.random.default_rng(seed)
    rig = full_size_rig(sizes["cams"], seed)
    V = sizes["views"]
    board = chessboard_object_points(9, 6, 23.0)
    rv = np.array([np.pi, 0, 0]) + rng.uniform(-0.4, 0.4, (V, 3))
    tv = np.stack([rng.uniform(-250, 250, V), rng.uniform(-180, 180, V),
                   rng.uniform(450, 900, V)], 1)
    K0 = np.repeat(rig.K[:1], V, 0)
    omni = omnidir_project(OmnidirCamera(
        t(K0), t(np.repeat(rig.xi[:1], V)), t(np.repeat(rig.D[:1], V, 0)),
        t(rv), t(tv)), t(board)).numpy()
    fish = fisheye_project(FisheyeCamera(
        t(K0), t(np.repeat(FISHEYE_D[None], V, 0)), t(rv), t(tv)),
        t(board)).numpy()
    f0, c0 = rig.K[0, 0, 0], rig.K[0, :2, 2]
    intr = dict(obj=np.tile(board[None], (V, 1, 1)),
                omni=omni + rng.normal(0, BOARD_NOISE, omni.shape),
                fish=fish + rng.normal(0, BOARD_NOISE, fish.shape),
                kw=dict(init_f=0.9 * f0, init_c=(c0[0] + 15, c0[1] - 10),
                        img_size=rig.size,
                        init_rvecs=rv + rng.normal(0, 0.02, (V, 3)),
                        init_tvecs=tv + rng.normal(0, 20, (V, 3))))

    P = sizes["trace"]
    s = np.arange(P) / P * 2 * np.pi
    pts = np.stack([900 * np.sin(3 * s) + 150 * np.sin(17 * s),
                    900 * np.cos(2 * s) + 150 * np.cos(13 * s),
                    800 + 500 * np.sin(5 * s)], 1)
    cam = rig.omni("cpu", torch.float64)
    obs = omnidir_project(cam, t(pts)).numpy()
    obs += rng.normal(0, TRACE_NOISE, obs.shape)
    obs[rng.uniform(size=obs.shape[:2]) < 0.05] = np.nan
    rvec0, tvec0 = rig.rvec.copy(), rig.tvec.copy()
    rvec0[1:] += rng.normal(0, 0.02, rvec0[1:].shape)
    tvec0[1:] += rng.normal(0, 30.0, tvec0[1:].shape)
    trace = dict(obs=obs, pts=pts, rvec0=rvec0, tvec0=tvec0)

    kp3d = simulate_scene(1, sizes["frames"], seed=seed)[0]   # (F, 17, 3)
    F, J, _ = kp3d.shape
    pix = omnidir_project(cam, t(kp3d.reshape(-1, 3))).numpy().reshape(
        rig.n_cam, F, J, 2)
    pix += rng.normal(0, 2.0, pix.shape)
    pix[rng.uniform(size=pix.shape[:3]) < 0.1] = np.nan
    decoy = pix + rng.uniform(40, 80, pix.shape) * rng.choice([-1, 1],
                                                            pix.shape)
    from macaque_tpu_torch.core.config import (
        MACAQUE_CONSTRAINTS, MACAQUE_CONSTRAINTS_WEAK, constraint_indices)

    facade = dict(kp3d=kp3d, pix=pix, cands=np.stack([pix, decoy], 3),
                  cons=constraint_indices(MACAQUE_CONSTRAINTS),
                  weak=constraint_indices(MACAQUE_CONSTRAINTS_WEAK))
    return rig, intr, trace, facade


def calib_sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def calib_timed(name, fn, *args, **kw):
    """``fn(*args, **kw, info=...)`` with its wall time on its device and
    its LM counts, logged; returns (output, info, seconds)."""
    info = {}
    calib_sync(kw["device"])
    t = time.perf_counter()
    out = fn(*args, **kw, info=info)
    calib_sync(kw["device"])
    wall = time.perf_counter() - t
    log(f"calib {name}: {wall:.3f}s, {info['lm_steps']} LM steps, "
        f"{info['cg_sweeps']} CG sweeps, {info['host_reads']} host reads, "
        f"{1e3 * wall / max(info['cg_sweeps'], 1):.3f} ms a sweep; cost "
        f"{info['cost0']:.6g} -> {info['cost']:.6g}, rms {out[-1]:.6f} px")
    return out, info, wall


def calib_solves(rig, intr, trace, device, dtype, cfg=None, prefix="",
                 skip=()):
    """The solvers of the calibration on the phase's scene: the two
    intrinsic fits of camera 0's board views, then the
    extrinsic and the full BA of the marker trace from the perturbed rig,
    its structure DLT-triangulated as the drivers do. ``cfg`` (LM
    iterations, CG sweeps) overrides every default budget; the solvers
    named in ``skip`` do not run. Returns {name: (output, info, s)}."""
    from macaque_tpu_torch.calib import bundle
    from macaque_tpu_torch.calib.workflow import _triangulate_trace
    from macaque_tpu_torch.geometry.lm import LMConfig

    def budget(lm_iters, cg_iters, ftol):
        if cfg is not None:
            lm_iters, cg_iters = cfg
        return {"cfg": LMConfig(lm_iters=lm_iters, cg_iters=cg_iters,
                                ftol=ftol)}

    on = {"device": device, "dtype": dtype}
    tag = f"{prefix}{str(dtype).split('.')[-1]}"
    out = {}
    if "omnidir_intrinsics" not in skip:
        out["omnidir_intrinsics"] = calib_timed(
            f"calibrate_intrinsics_omnidir ({tag})",
            bundle.calibrate_intrinsics_omnidir, intr["obj"], intr["omni"],
            **intr["kw"], **budget(300, 150, 1e-12), **on)
    if "fisheye_intrinsics" not in skip:
        out["fisheye_intrinsics"] = calib_timed(
            f"calibrate_intrinsics_fisheye ({tag})",
            bundle.calibrate_intrinsics_fisheye, intr["obj"], intr["fish"],
            **intr["kw"], **budget(600, 400, 1e-15), **on)
    K, xi, D = rig.K, rig.xi, rig.D
    obs, rv0, tv0 = trace["obs"], trace["rvec0"], trace["tvec0"]
    pts0 = _triangulate_trace(obs, K, xi, D, rv0, tv0, device, dtype)
    seen = ~np.isnan(pts0[:, 0])
    args = (K, xi, D, rv0, tv0, obs[:, seen], np.nan_to_num(pts0[seen]))
    out["extrinsic_ba"] = calib_timed(
        f"bundle_adjust_extrinsics ({tag}, {int(seen.sum())} points)",
        bundle.bundle_adjust_extrinsics, *args, **budget(50, 80, 1e-8), **on)
    out["full_ba"] = calib_timed(
        f"bundle_adjust_full ({tag}, {int(seen.sum())} points)",
        bundle.bundle_adjust_full, *args, **budget(60, 100, 1e-9), **on)
    return out


def calib_positions(rv, tv, rig):
    """Camera-centre errors (mm) against the rig after the scale alignment
    about camera 0 (tests/test_calib_workflow.py::_campos_errors)."""
    from macaque_tpu_torch.calib.workflow import camera_position

    pos = np.stack([camera_position(r, t) for r, t in zip(rv, tv)])
    gt = np.stack([camera_position(r, t) for r, t in zip(rig.rvec, rig.tvec)])
    s = np.mean(np.linalg.norm(gt[1:] - gt[0], axis=1)
                / np.linalg.norm(pos[1:] - pos[0], axis=1))
    return np.linalg.norm((pos - pos[0]) * s + gt[0] - gt, axis=1), s


def calib_self_consistency(out, obs, device, dtype):
    """DLT-triangulate the trace with the full BA's calibration and
    reproject: rms over the observations (px)."""
    from macaque_tpu_torch.calib.workflow import _triangulate_trace
    from macaque_tpu_torch.cameras.omnidir import (
        OmnidirCamera, omnidir_project)

    K, xi, D, rv, tv = out[:5]
    pts = _triangulate_trace(obs, K, xi, D, rv, tv, device, dtype)
    seen = ~np.isnan(pts[:, 0])
    cam = OmnidirCamera(*(torch.as_tensor(a, dtype=torch.float64)
                          for a in (K, xi, D, rv, tv)))
    reproj = omnidir_project(cam, torch.as_tensor(pts[seen])).numpy()
    return float(np.sqrt(np.nanmean((reproj - obs[:, seen]) ** 2)))


def check_calib_production(res, rig, trace, dtype, dev):
    """Check (b) on one precision's production run: every rms under twice
    its injected noise, the extrinsic BA's cameras within 3 mm of the truth
    after the scale alignment, the full BA's self-consistency rms under
    0.5 px."""
    bad = []
    for name, noise in (("omnidir_intrinsics", BOARD_NOISE),
                        ("fisheye_intrinsics", BOARD_NOISE),
                        ("extrinsic_ba", TRACE_NOISE),
                        ("full_ba", TRACE_NOISE)):
        if name not in res:
            continue
        rms = res[name][0][-1]
        if not rms < 2 * noise:
            bad.append(f"{name} rms {rms}")
    errs, s = calib_positions(*res["extrinsic_ba"][0][:2], rig)
    self_rms = calib_self_consistency(res["full_ba"][0], trace["obs"],
                                      dev, dtype)
    log(f"calib (b) {str(dtype).split('.')[-1]}: extrinsic BA camera "
        f"positions after the scale alignment (s = {s:.6f}) within "
        f"{errs.max():.4f} mm of the truth; full BA self-consistency rms "
        f"{self_rms:.6f} px")
    if not errs.max() < 3.0:
        bad.append(f"extrinsic BA positions {errs}")
    if not self_rms < 0.5:
        bad.append(f"full BA self-consistency rms {self_rms}")
    if bad:
        raise AssertionError("calib (b): " + "; ".join(bad))


def check_calib_devices(rig, intr, trace, facade, dev):
    """Check (a): the card against the CPU, both float64, at the tier-1
    tests' short budget: equal LM iterations and CG sweeps, every output
    within 1e-9 of its largest value (the tests' tolerance); the facade's
    triangulation within 1e-9 and its multi-hypothesis refinement within
    1e-9 at the same short budget."""
    from macaque_tpu_torch.compat.aniposelib import CameraGroup
    from macaque_tpu_torch.geometry.refine3d import (
        RefineConfig, refine_points_3d_possible)

    f64 = torch.float64
    card = calib_solves(rig, intr, trace, dev, f64, CALIB_SHORT, "short, ")
    host = {}
    for name, (out, info, _) in calib_solves(
            rig, intr, trace, "cpu", f64, CALIB_SHORT, "short CPU, ").items():
        host[name] = (out, info)
    worst = 0.0
    for name, (out, info, _) in card.items():
        h_out, h_info = host[name]
        if (info["lm_iters"], info["cg_iters"]) != (h_info["lm_iters"],
                                                    h_info["cg_iters"]):
            raise AssertionError(f"calib (a) {name}: counts differ, card "
                                 f"{info} CPU {h_info}")
        for g, h in zip(out, h_out):
            g, h = np.asarray(g, float), np.asarray(h, float)
            worst = max(worst, float(np.abs(g - h).max())
                        / max(float(np.abs(h).max()), 1e-30))
    n_cam, (F, J) = rig.n_cam, facade["kp3d"].shape[:2]
    flat = facade["pix"].reshape(n_cam, F * J, 2)
    tri = [CameraGroup(rig, d, f64).triangulate(flat) for d in (dev, "cpu")]
    scale = np.nanmax(np.abs(tri[1]))
    d_tri = float(np.nanmax(np.abs(tri[0] - tri[1]))) / scale
    same_nan = np.array_equal(np.isnan(tri[0]), np.isnan(tri[1]))
    init = tri[1].reshape(F, J, 3)
    poss = []
    for d in (dev, "cpu"):
        cam = rig.camera(d, f64)
        p3, a = refine_points_3d_possible(
            cam, torch.as_tensor(facade["cands"], device=d),
            torch.as_tensor(init, device=d), facade["cons"], facade["weak"],
            RefineConfig(lm_iters=CALIB_SHORT[0], cg_iters=CALIB_SHORT[1]))
        poss.append((p3.cpu().numpy(), a.cpu().numpy()))
    d_p3 = float(np.abs(poss[0][0] - poss[1][0]).max()
                 / np.abs(poss[1][0]).max())
    d_a = float(np.nanmax(np.abs(poss[0][1] - poss[1][1])))
    log(f"calib (a) card against CPU, float64, {CALIB_SHORT[0]} LM "
        f"iterations of {CALIB_SHORT[1]} CG sweeps: counts equal, solver "
        f"outputs within {worst:.3e} of their largest value; facade "
        f"triangulate NaN pattern equal {same_nan}, rel {d_tri:.3e}; "
        f"possible refinement points rel {d_p3:.3e}, weights {d_a:.3e}")
    if not (worst <= 1e-9 and same_nan and d_tri <= 1e-9 and d_p3 <= 1e-9
            and d_a <= 1e-9):
        raise AssertionError("calib (a): the card differs from the CPU")


def calib_graph_gain(intr, dev, cfg=(2, 150)):
    """The omnidir intrinsic fit, float32, a few LM steps of 150 sweeps,
    with its sweeps eager (the solver's loop without graphs,
    ``lm._lm_solve_batch``) and replayed from CUDA graphs (``lm_solve`` on
    the card): ms a sweep each way (second calls), and the two outputs bit
    for bit equal (the same kernels on the same buffers)."""
    from macaque_tpu_torch.calib import bundle
    from macaque_tpu_torch.geometry import lm

    def eager(resid_fn, x0, cfg, return_info=False):
        x, info = lm._lm_solve_batch(resid_fn, x0, cfg)
        return (x, info) if return_info else x

    solve, got = bundle.lm_solve, {}
    for graph in (False, True, False, True):
        bundle.lm_solve = solve if graph else eager
        try:
            out, info, wall = calib_timed(
                f"calibrate_intrinsics_omnidir ({'graph' if graph else 'eager'}"
                f" sweeps, float32)", bundle.calibrate_intrinsics_omnidir,
                intr["obj"], intr["omni"], **intr["kw"],
                cfg=lm.LMConfig(lm_iters=cfg[0], cg_iters=cfg[1], ftol=1e-12),
                device=dev, dtype=torch.float32)
        finally:
            bundle.lm_solve = solve
        got[graph] = (out, 1e3 * wall / info["cg_sweeps"])
    same = all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(got[False][0], got[True][0]))
    log(f"calib: {got[False][1]:.3f} ms a sweep eager, {got[True][1]:.3f} "
        f"replayed from CUDA graphs; outputs bit for bit equal {same}")
    if not same:
        raise AssertionError("calib: graph-replayed sweeps differ from eager")


def phase_calib(sizes=CALIB_FULL, dev="cuda"):
    """The calibration on the card: the intrinsic fits, the marker-trace
    bundle adjustments and the aniposelib facade at the reference rig's
    size, no hand-written kernel on any of them. Checks (a) card against
    CPU at the short budget, (b) the production budgets in float32 and in
    float64 (the intrinsic fits in float32 only), (c) no kernel launched
    during the phase; and the facade's
    ``bundle_adjust_iter``, ``triangulate``, ``triangulate_ransac`` and
    ``optim_points_possible`` against the truth."""
    from macaque_tpu_torch import kernels
    from macaque_tpu_torch.compat.aniposelib import CameraGroup

    t0 = time.perf_counter()
    before = dict(kernels.LAUNCHES)
    rig, intr, trace, facade = calib_scene(sizes)
    log(f"calib: scene of {rig.n_cam} cameras at {rig.size[0]}x"
        f"{rig.size[1]}, {sizes['views']} board views, a trace of "
        f"{sizes['trace']} points, {sizes['frames']} frames of 17 joints "
        f"({time.perf_counter() - t0:.1f}s)")
    check_calib_devices(rig, intr, trace, facade, dev)
    calib_graph_gain(intr, dev)
    walls = {}
    for dtype in (torch.float32, torch.float64):
        # the omnidir intrinsic fit runs at its production budget in
        # float32 only: its float64 repeat (~45 s, near its sweep cap) gave
        # the time of the mesh and tools phases; check (a) holds it in
        # float64 card against CPU at the short budget
        res = calib_solves(rig, intr, trace, dev, dtype, skip=(
            ("omnidir_intrinsics",) if dtype == torch.float64 else ()))
        walls[dtype] = sum(w for _, _, w in res.values())
        check_calib_production(res, rig, trace, dtype, dev)

    # the facade, float32 on the card (its default)
    obs = trace["obs"]
    g = CameraGroup(_perturbed(rig, trace), dev)
    t = time.perf_counter()
    err = g.bundle_adjust_iter(obs, n_iters=sizes["iter_rounds"],
                               n_samp_full=sizes["iter_samples"])
    t_iter = time.perf_counter() - t
    n_cam, (F, J) = rig.n_cam, facade["kp3d"].shape[:2]
    flat = facade["pix"].reshape(n_cam, F * J, 2)
    g = CameraGroup(rig, dev)
    t = time.perf_counter()
    tri = g.triangulate(flat).reshape(F, J, 3)
    t_tri = time.perf_counter() - t
    noisy = flat.copy()
    noisy[0, ::4] += 300.0                       # a camera's gross outliers
    t = time.perf_counter()
    ran = g.triangulate_ransac(noisy)[0].reshape(F, J, 3)
    t_ran = time.perf_counter() - t
    t = time.perf_counter()
    poss, alphas = g.optim_points_possible(
        facade["cands"], tri, constraints=facade["cons"],
        constraints_weak=facade["weak"])
    t_poss = time.perf_counter() - t

    def median_mm(p):
        return float(np.nanmedian(np.linalg.norm(p - facade["kp3d"], axis=-1)))

    e_tri, e_ran, e_poss = median_mm(tri), median_mm(ran), median_mm(poss)
    w_sum = np.nansum(alphas, -1)
    valid = ~np.isnan(facade["cands"][..., 0]).all(-1)
    log(f"calib facade (float32): bundle_adjust_iter {sizes['iter_rounds']} "
        f"rounds of {sizes['iter_samples']} samples in {t_iter:.3f}s, final "
        f"median error {err:.4f} px; triangulate {F * J} points in "
        f"{t_tri:.3f}s, median {e_tri:.3f} mm from the truth; "
        f"triangulate_ransac {t_ran:.3f}s, {e_ran:.3f} mm with camera 0's "
        f"outliers; optim_points_possible {t_poss:.3f}s, {e_poss:.3f} mm")
    # bounds: twice the trace's noise; 2 px of keypoint noise is ~10 mm
    # of DLT error on this rig (a CPU rehearsal at 24 frames: 10.3 mm,
    # RANSAC 22.4 mm at its 0.5 px threshold, the refinement 8.9 mm)
    if not (err < 2 * TRACE_NOISE and e_tri < 20.0 and e_ran < 40.0
            and np.isfinite(poss).all() and e_poss < e_tri + 5.0
            and np.allclose(w_sum[valid], 1.0, atol=1e-5)):
        raise AssertionError("calib: the facade's results are off")
    if kernels.LAUNCHES != before:
        raise AssertionError(f"calib (c): kernels launched: {before} -> "
                             f"{kernels.LAUNCHES}")
    log(f"calib (c): kernels.LAUNCHES unchanged; solver walls float32 "
        f"{walls[torch.float32]:.1f}s, float64 {walls[torch.float64]:.1f}s;"
        f" phase {time.perf_counter() - t0:.1f}s")


def _perturbed(rig, trace):
    """The rig with the trace's perturbed extrinsics (the facade's start)."""
    import copy

    out = copy.deepcopy(rig)
    out.rvec, out.tvec = trace["rvec0"].copy(), trace["tvec0"].copy()
    return out


# one anipose recording: a minute at 24 fps of one animal's 17 joints in
# the reference rig's 8 cameras at 2048x1536; 2 px noise, 10 % of the
# detections dropped, camera 0's wrists and ankles swapped left for right
# in every other 60-frame stretch. (a) holds the first 240 frames card
# against CPU.
SESSION_FULL = {"cams": 8, "frames": 1440, "held": 240}
SESSION_NOISE, SESSION_DROP = 2.0, 0.1
SESSION_FILTER = {"type": ["medfilt", "viterbi", "autoencoder"],
                  "medfilt": 13, "offset_threshold": 25,
                  "score_threshold": 0.05, "spline": True, "n_back": 5}


def session_scene(sizes, seed=0):
    """The phase's numpy inputs: the rig, the truth (F, 17, 3) and each
    camera's detections (C, F, 17, 2) with scores (C, F, 17)."""
    from macaque_tpu_torch.cameras.omnidir import omnidir_project
    from macaque_tpu_torch.core.config import MACAQUE_BODYPARTS
    from macaque_tpu_torch.tools.synthetic import simulate_scene

    rng = np.random.default_rng(seed)
    rig = full_size_rig(sizes["cams"], seed)
    kp3d = simulate_scene(1, sizes["frames"], seed=seed)[0]
    F, J, _ = kp3d.shape
    pix = omnidir_project(rig.omni("cpu", torch.float64),
                          torch.as_tensor(kp3d.reshape(-1, 3))).numpy()
    pix = pix.reshape(rig.n_cam, F, J, 2)
    pix += rng.normal(0, SESSION_NOISE, pix.shape)
    scores = rng.uniform(0.6, 1.0, pix.shape[:3])
    drop = rng.uniform(size=scores.shape) < SESSION_DROP
    pix[drop] = np.nan
    scores[drop] = 0.02
    swap = (np.arange(F) // 60) % 2 == 1
    for part in ("wrist", "ankle"):
        i = MACAQUE_BODYPARTS.index("left_" + part)
        j = MACAQUE_BODYPARTS.index("right_" + part)
        cam0 = pix[0]
        cam0[np.ix_(swap, [i, j])] = cam0[np.ix_(swap, [j, i])]
    return rig, kp3d, pix, scores


def session_tri_cfg():
    """The pipeline's triangulation settings (the ``config.toml`` step 4
    writes), with RANSAC and the refinement on; the macaque constraints."""
    import dataclasses

    from macaque_tpu_torch.core.config import (
        MACAQUE_CONSTRAINTS, MACAQUE_CONSTRAINTS_WEAK, PipelineConfig,
        constraint_indices)

    cfg = dataclasses.asdict(PipelineConfig().triangulation)
    cfg.update(ransac=True, optim=True)
    return cfg, (constraint_indices(MACAQUE_CONSTRAINTS),
                 constraint_indices(MACAQUE_CONSTRAINTS_WEAK))


def session_group(rig, device, dtype, short=False):
    """The facade's group; ``short`` holds its refinement to the tests'
    short budget."""
    from macaque_tpu_torch.compat.aniposelib import CameraGroup

    class Short(CameraGroup):
        def _refine_config(self, kwargs):
            return super()._refine_config(kwargs)._replace(
                lm_iters=CALIB_SHORT[0], cg_iters=CALIB_SHORT[1])

    return (Short if short else CameraGroup)(rig, device, dtype)


def session_train(scores, path, device, dtype):
    """``train_autoencoder`` on every camera's scores, saved to ``path``;
    returns (weights, seconds)."""
    from macaque_tpu_torch.filters.autoencoder import (
        save_autoencoder, train_autoencoder)

    calib_sync(device)
    t = time.perf_counter()
    params = train_autoencoder(scores.reshape(-1, scores.shape[-1]),
                               score_threshold=SESSION_FILTER["score_threshold"],
                               device=device, dtype=dtype)
    calib_sync(device)
    wall = time.perf_counter() - t
    save_autoencoder(params, path)
    return params, wall


def session_run(rig, pix, scores, ae_path, device, dtype, short=False):
    """The session's array core: each camera through
    ``filter_pose_2d_arrays`` (medfilt -> viterbi -> autoencoder), then
    ``triangulate_arrays`` (RANSAC, then the refinement with the macaque
    constraints). Returns (filtered points, filtered scores, the
    triangulation's four outputs, {call: seconds})."""
    from macaque_tpu_torch.tools.session import (
        filter_pose_2d_arrays, triangulate_arrays)

    fcfg = dict(SESSION_FILTER, autoencoder_path=ae_path)
    tri_cfg, (cons, weak) = session_tri_cfg()
    walls = {}
    calib_sync(device)
    t = time.perf_counter()
    filt = [filter_pose_2d_arrays(fcfg, pix[c], scores[c], device, dtype)
            for c in range(rig.n_cam)]
    calib_sync(device)
    walls["filter_pose_2d_arrays"] = time.perf_counter() - t
    pts = np.stack([p for p, _ in filt])
    scs = np.stack([s for _, s in filt])
    t = time.perf_counter()
    out = triangulate_arrays(session_group(rig, device, dtype, short), pts,
                             scs, tri_cfg, cons, weak)
    calib_sync(device)
    walls["triangulate_arrays"] = time.perf_counter() - t
    return pts, scs, out, walls


def session_rel(a, b):
    """Largest |a - b| over the largest |b|, and whether the NaNs agree."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    same = np.array_equal(np.isnan(a), np.isnan(b))
    scale = max(float(np.nanmax(np.abs(b))), 1e-30)
    return float(np.nanmax(np.abs(a - b))) / scale, same


def check_session_devices(rig, pix, scores, root, dev, n_held):
    """Check (a): the card against the CPU, both float64, on the first
    ``n_held`` frames, with the refinement at the tests' short budget: the
    autoencoder's weights, the filtered points and scores and the
    triangulation's outputs within 1e-8 of their largest value, NaNs in
    the same places, the Viterbi picks equal."""
    f64 = torch.float64
    pix, scores = pix[:, :n_held], scores[:, :n_held]
    runs, weights = {}, {}
    for d in (dev, "cpu"):
        path = os.path.join(root, f"ae_{torch.device(d).type}.npz")
        weights[d], t_ae = session_train(scores, path, d, f64)
        runs[d] = session_run(rig, pix, scores, path, d, f64, short=True)
        log(f"session (a) {d} float64, {n_held} frames: train_autoencoder "
            f"{t_ae:.3f}s, " + ", ".join(f"{k} {w:.3f}s"
                                         for k, w in runs[d][3].items()))
    worst_w = max(session_rel(a.cpu(), b)[0]
                  for a, b in zip(weights[dev], weights["cpu"]))
    card, host = runs[dev], runs["cpu"]
    picks = np.array_equal(card[0], host[0])
    rels = [session_rel(a, b) for a, b in zip([card[1], *card[2]],
                                              [host[1], *host[2]])]
    worst = max(r for r, _ in rels)
    same = all(s for _, s in rels)
    log(f"session (a) card against CPU, float64, {CALIB_SHORT[0]} LM "
        f"iterations of {CALIB_SHORT[1]} CG sweeps: autoencoder weights "
        f"rel {worst_w:.3e}; filtered points equal {picks}; filtered scores "
        f"and triangulation (points, errors, ncams, scores) rel {worst:.3e},"
        f" NaN patterns equal {same}")
    if not (worst_w <= 1e-8 and picks and worst <= 1e-8 and same):
        raise AssertionError("session (a): the card differs from the CPU")


def phase_session(sizes=SESSION_FULL, dev="cuda"):
    """The anipose session tools' array core on the card at one
    recording's size, no hand-written kernel on it: ``train_autoencoder``,
    ``filter_pose_2d_arrays`` and ``triangulate_arrays`` (the work of
    ``filter-2d``, ``train-autoencoder`` and ``triangulate-session``
    without their pandas and h5py files). Checks (a) card against CPU at the
    short budget, (b) the production run in float32 against the truth: the
    refinement's median 3D error below RANSAC's alone, (c) no kernel
    launched during the phase."""
    import tempfile

    from macaque_tpu_torch import kernels

    t0 = time.perf_counter()
    before = dict(kernels.LAUNCHES)
    rig, kp3d, pix, scores = session_scene(sizes)
    F, J, _ = kp3d.shape
    log(f"session: scene of {rig.n_cam} cameras at {rig.size[0]}x"
        f"{rig.size[1]}, {F} frames of {J} joints, "
        f"{int(np.isnan(pix[..., 0]).sum())} detections dropped "
        f"({time.perf_counter() - t0:.1f}s)")
    with tempfile.TemporaryDirectory(dir=REPO,
                                     prefix=".chip_smoke_session_") as root:
        check_session_devices(rig, pix, scores, root, dev, sizes["held"])
        path = os.path.join(root, "ae.npz")
        _, t_ae = session_train(scores, path, dev, torch.float32)
        pts, scs, (p3d, err, ncams, sc3d), walls = session_run(
            rig, pix, scores, path, dev, torch.float32)
    tri_cfg, _ = session_tri_cfg()
    thr = pts.copy()
    thr[scs < tri_cfg["score_threshold"]] = np.nan
    g = session_group(rig, dev, torch.float32)
    t = time.perf_counter()
    ran = g.triangulate_ransac(thr.reshape(rig.n_cam, -1, 2),
                               min_cams=2)[0].reshape(F, J, 3)
    t_ran = time.perf_counter() - t
    dlt = g.triangulate(thr.reshape(rig.n_cam, -1, 2)).reshape(F, J, 3)

    def median_mm(p):
        return float(np.nanmedian(np.linalg.norm(p - kp3d, axis=-1)))

    e_opt, e_ran, e_dlt = median_mm(p3d), median_mm(ran), median_mm(dlt)
    finite = float(np.isfinite(p3d[..., 0]).mean())
    log(f"session (b) float32: train_autoencoder {t_ae:.3f}s, "
        + ", ".join(f"{k} {w:.3f}s" for k, w in walls.items())
        + f" ({rig.n_cam} cameras); triangulate_ransac alone {t_ran:.3f}s; "
        f"median 3D error against the truth: ransac + optim {e_opt:.3f} mm "
        f"on {finite:.3f} of the joints, ransac alone {e_ran:.3f} mm, "
        f"DLT {e_dlt:.3f} mm; median reprojection error "
        f"{float(np.nanmedian(err)):.3f} px, median ncams "
        f"{float(np.nanmedian(ncams)):.1f}")
    shapes = (p3d.shape == (F, J, 3) and err.shape == ncams.shape
              == sc3d.shape == (F, J) and pts.shape == pix.shape)
    if not (shapes and finite > 0.9 and e_opt < e_ran):
        raise AssertionError("session (b): the refinement's points are off")
    if kernels.LAUNCHES != before:
        raise AssertionError(f"session (c): kernels launched: {before} -> "
                             f"{kernels.LAUNCHES}")
    log(f"session (c): kernels.LAUNCHES unchanged; phase "
        f"{time.perf_counter() - t0:.1f}s")


EVAL2D_FRAMES, EVAL2D_THR = 32, 0.85     # (a): 2 chunks of 16 at 2048x1536
COCO_IMAGES, COCO_FULL = 24, 8           # (b): the oracle's and the networks'
SWEEP_FRAMES, SWEEP_CAMS = 60, 4         # (c): tests/test_sweep.py's slow test
PICT_PROBLEMS, PICT_C, PICT_N = 64, 16, 48   # (d)


def check_pose2d(perception, frames):
    """(a) ``tools/run2d.pose_2d_frames`` in chunks of 16 through the parity
    networks; K1 and K2 counted around the calls alone. Each frame's
    keypoints are (D, 17, 3), finite where kept, NaN elsewhere; the kept
    count is ``perception.detect``'s count above the threshold on the same
    frames; some detection passed. Returns the launches."""
    from macaque_tpu_torch import kernels
    from macaque_tpu_torch.tools.run2d import pose_2d_frames

    kernels.reset_launches()
    t = time.perf_counter()
    out = [pose_2d_frames(perception, frames[i:i + CHUNK], EVAL2D_THR)
           for i in range(0, len(frames), CHUNK)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    kps = np.concatenate([k for k, _ in out])
    valid = np.concatenate([v for _, v in out])
    n_det = sum(int((perception.detect(frames[i:i + CHUNK])[1]
                     > EVAL2D_THR).sum()) for i in range(0, len(frames), CHUNK))
    ok = (kps.shape == (len(frames), perception.max_det, 17, 3)
          and np.isfinite(kps[valid]).all() and np.isnan(kps[~valid]).all()
          and int(valid.sum()) == n_det > 0)
    log(f"eval2d (a): pose_2d_frames on {len(frames)} frames of 2048x1536 in "
        f"chunks of {CHUNK} at det_thr {EVAL2D_THR}: {wall:.3f}s "
        f"({wall / len(frames):.4f}s a frame), {int(valid.sum())} detections "
        f"kept (detect's count {n_det}), keypoints {kps.shape}; launches "
        f"{launches}")
    if not ok:
        raise AssertionError("eval2d (a): pose_2d_frames' keypoints or "
                             "masks are off")
    for k in ("packed_attention", "roi_align_windowed"):
        if launches[k] <= 0:
            raise AssertionError(f"eval2d (a): pose_2d_frames never launched {k}")
    return launches


def coco_scene(n=COCO_IMAGES):
    """tests/test_coco_eval.py's scene drawn with numpy: one camera, two
    animals' filled boxes (``cv2.rectangle``'s inclusive, truncated
    corners, clipped), the frame index in the top edge, and the
    ``load_coco`` records of its annotations. Returns (proj, images,
    records)."""
    from macaque_tpu_torch.tools.synthetic import (
        encode_index, make_test_rig, project_scene, simulate_scene)

    proj = project_scene(make_test_rig(1, seed=41),
                         simulate_scene(2, n, seed=42))
    images, records = [], []
    for t in range(n):
        img = np.full((480, 640, 3), 30, np.uint8)
        boxes, kps, areas = [], [], []
        for a in range(2):
            pts = proj[0, a, t]
            x1, y1 = pts.min(axis=0) - 8
            x2, y2 = pts.max(axis=0) + 8
            img[max(int(y1), 0):max(int(y2) + 1, 0),
                max(int(x1), 0):max(int(x2) + 1, 0)] = (0, 180, 0)
            boxes.append([x1, y1, x2, y2])
            kps.append(np.concatenate([pts, np.full((len(pts), 1), 2.0)], 1))
            areas.append((x2 - x1) * (y2 - y1))
        encode_index(img, t)
        images.append(img)
        records.append({"file_name": f"f{t:03d}.png",
                        "boxes": np.asarray(boxes, float),
                        "keypoints": np.stack(kps),
                        "areas": np.asarray(areas, float)})
    return proj, images, records


def check_coco(perception):
    """(b) ``tools/coco_eval.coco_eval_arrays``: the oracle on the 24-image
    scene to tests/test_coco_eval.py's bounds; then the parity networks on
    8 of its images scaled to 2048x1536 (nearest neighbour, ground truth
    scaled alike): every AP finite and in [0, 1]."""
    from macaque_tpu_torch.tools.coco_eval import coco_eval_arrays
    from macaque_tpu_torch.tools.synthetic import SyntheticPerception

    t = time.perf_counter()
    proj, images, records = coco_scene()
    drawn = time.perf_counter() - t
    t = time.perf_counter()
    res = coco_eval_arrays(SyntheticPerception(0, proj, noise=0.5), images,
                           records, det_thr=0.5, progress=False)
    oracle = time.perf_counter() - t
    log(f"eval2d (b): {len(images)} images drawn in {drawn:.3f}s; the oracle "
        f"in {oracle:.3f}s: det {res['det']}, pose {res['pose']}")
    if not (res["n_images"] == len(images) and res["det"]["AP50"] > 0.95
            and res["pose"]["AP50"] > 0.95 and res["det"]["mAP"] > 0.5):
        raise AssertionError(f"eval2d (b): oracle APs below the test's: {res}")
    s = 2048 / 640
    rows = (np.arange(1536) * 480) // 1536
    cols = (np.arange(2048) * 640) // 2048
    big = [img[rows][:, cols] for img in images[:COCO_FULL]]
    recs = [{**r, "boxes": r["boxes"] * s, "areas": r["areas"] * s * s,
             "keypoints": r["keypoints"] * np.array([s, s, 1.0])}
            for r in records[:COCO_FULL]]
    t = time.perf_counter()
    res = coco_eval_arrays(perception, big, recs, det_thr=EVAL2D_THR,
                           progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    aps = list(res["det"].values()) + list(res["pose"].values())
    log(f"eval2d (b): the parity networks on {COCO_FULL} images of 2048x1536 "
        f"in {wall:.3f}s ({wall / COCO_FULL:.4f}s an image): det {res['det']}, "
        f"pose {res['pose']}")
    if not (res["n_images"] == COCO_FULL
            and all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in aps)):
        raise AssertionError(f"eval2d (b): the networks' APs are off: {res}")


def check_sweep(root, dev="cuda"):
    """(c) ``tools/sweep.run_synthetic_sweep`` on the card in float32 with
    tests/test_sweep.py's two points (its slow test: 60 frames, 4 cameras;
    the stores RGBA, no cv2 here): precision and recall above 0.8 for each
    ranked row."""
    from macaque_tpu_torch.tools.sweep import (
        SweepPoint, rank_sweep, run_synthetic_sweep)

    grid = [SweepPoint(0.85, 0.50, 0.05, 72, True),
            SweepPoint(0.65, 0.30, 0.25, 36, False)]
    t = time.perf_counter()
    log_csv = run_synthetic_sweep(os.path.join(root, "sweep"), grid=grid,
                                  n_frame=SWEEP_FRAMES, n_cam=SWEEP_CAMS,
                                  verbose=False, device=dev,
                                  dtype=torch.float32)
    wall = time.perf_counter() - t
    ranking = rank_sweep(log_csv)
    log(f"eval2d (c): run_synthetic_sweep, {len(grid)} points of "
        f"{SWEEP_FRAMES} frames x {SWEEP_CAMS} cameras, float32: {wall:.3f}s "
        f"({wall / len(grid):.3f}s a point, the stores included); " + "; ".join(
            f"{r['match']}/{r['prox']}/{r['tlow']}/{r['tbuf']}/{r['fuse']}: "
            f"precision {r['precision']:.3f} recall {r['recall']:.3f}"
            for r in ranking))
    if len(ranking) != len(grid) or not all(
            r["precision"] > 0.8 and r["recall"] > 0.8 for r in ranking):
        raise AssertionError(f"eval2d (c): the sweep's rows are off: {ranking}")


def check_pictorial(dev="cuda"):
    """(d) ``association/pictorial.py`` on the card (float64) against the
    port's native C++ oracle (built with g++ here): the picks of 64 seeded
    problems at C = 16, and ``closure_to_clusters`` at N = 48 (step 2's M)
    against ``transform_closure``."""
    from macaque_tpu_torch.association.pictorial import (
        closure_to_clusters, infer_pictorial_3d)
    from macaque_tpu_torch.native import load_native

    t = time.perf_counter()
    nat = load_native()
    built = time.perf_counter() - t
    rng = np.random.default_rng(0)
    probs = [(rng.uniform(0, 1, (13, PICT_C)),
              rng.uniform(-500, 500, (13, PICT_C, 3)),
              rng.uniform(80, 150, 13), rng.uniform(5, 30, 13))
             for _ in range(PICT_PROBLEMS)]
    t = time.perf_counter()
    got = [infer_pictorial_3d(*(torch.as_tensor(a, device=dev)
                                for a in p)) for p in probs]
    got = torch.stack(got).cpu().numpy()
    wall = time.perf_counter() - t
    want = np.stack([nat.pictorial_infer(*p) for p in probs])
    rels = []
    for _ in range(8):
        X = (rng.uniform(size=(PICT_N, PICT_N)) < 1.5 / PICT_N).astype(np.uint8)
        X = ((X + X.T) > 0).astype(np.uint8)
        np.fill_diagonal(X, 0)
        rels.append(X)
    t = time.perf_counter()
    clusters = [closure_to_clusters(X, device=dev) for X in rels]
    t_cl = time.perf_counter() - t
    same = [np.array_equal(c, nat.transform_closure(X))
            for c, X in zip(clusters, rels)]
    log(f"eval2d (d): native oracle loaded in {built:.3f}s; "
        f"infer_pictorial_3d on the card, {PICT_PROBLEMS} problems at C = "
        f"{PICT_C}: {wall:.3f}s, picks equal to the oracle's: "
        f"{np.array_equal(got, want)}; closure_to_clusters at N = {PICT_N}, "
        f"{len(rels)} relations ({sum(int(c.any(0).sum()) for c in clusters)} "
        f"clusters): {t_cl:.3f}s, equal: {all(same)}")
    if not (np.array_equal(got, want) and all(same)):
        raise AssertionError("eval2d (d): pictorial inference differs from "
                             "the native oracle")


def phase_eval2d(perception, dev="cuda"):
    """The evaluation and 2D tools on the card: (a) the 2D path at full
    width through the parity networks, (b) COCO evaluation, (c) the
    tracker sweep, (d) pictorial inference against the native oracle, (e)
    only K1 and K2 launched. Returns (a)'s launches."""
    import tempfile

    from macaque_tpu_torch import kernels

    t0 = time.perf_counter()
    t = time.perf_counter()
    frames = synthetic_frames(EVAL2D_FRAMES)
    log(f"eval2d: {len(frames)} frames of 2048x1536 drawn in "
        f"{time.perf_counter() - t:.1f}s")
    launches = check_pose2d(perception, frames)     # resets the counts
    del frames
    check_coco(perception)
    with tempfile.TemporaryDirectory(dir=REPO,
                                     prefix=".chip_smoke_eval2d_") as root:
        check_sweep(root, dev)
    check_pictorial(dev)
    moved = {k: n for k, n in kernels.LAUNCHES.items() if n}
    log(f"eval2d (e): kernels launched in the phase {moved}; phase "
        f"{time.perf_counter() - t0:.1f}s")
    if set(moved) - {"packed_attention", "roi_align_windowed"}:
        raise AssertionError(f"eval2d (e): kernels other than K1 and K2 "
                             f"launched: {moved}")
    return launches


# tests/test_multichip.py's scene: 4 cameras (rig seed 21), 2 animals x 96
# frames (seed 22), alldata seed 23; step 4 at the JAX test's converged
# budget, where the sharded and the single run meet within 2 mm
MESH_SCENE = {"n_cam": 4, "rig_seed": 21, "n_animal": 2, "n_frame": 96,
              "kp3d_seed": 22, "alldata_seed": 23}
MESH_CONVERGED = {"lm_iters": 100, "cg_iters": 300, "cg_rtol": 1e-4}
MESH_FRAMES = 6       # frames of the perception under the mesh (not /4)


def mesh_steps(root, tag, rig, percam, mesh, budgets, times, dev="cuda"):
    """Steps 2-4 of the mesh scene under ``mesh`` into ``root/tag``, step 4
    once for each of ``budgets`` (None: the production budget). Returns
    the directory and each budget's ``kp3d.pickle``."""
    from macaque_tpu_torch.pipeline.artifacts import read_pickle, write_alldata
    from macaque_tpu_torch.pipeline.step2 import run_step2
    from macaque_tpu_torch.pipeline.step3 import run_step3
    from macaque_tpu_torch.pipeline.step4 import run_step4

    rd = os.path.join(root, tag)
    n = MESH_SCENE["n_frame"]
    for c, cam_id in enumerate(rig.camera_ids):
        write_alldata(os.path.join(rd, cam_id), percam[c],
                      np.arange(n, dtype=np.int32))
    on = {"device": dev, "mesh": mesh}
    t = time.perf_counter()
    t2d = times.setdefault("step2", {})
    run_step2(rd, rig, times=t2d, **on)
    run_step3(rd, rig, **on)
    calib_sync(dev)
    msg = [f"steps 2-3 {time.perf_counter() - t:.1f}s (SVT "
           f"{t2d['svt_iterations']} iterations)"]
    kp3d = []
    for budget in budgets:
        t4 = times.setdefault(f"step4 {budget}", {})
        t = time.perf_counter()
        run_step4(rd, rig, refine_overrides=budget, times=t4, redo=True, **on)
        calib_sync(dev)
        kp3d.append(read_pickle(os.path.join(rd, "kp3d.pickle")))
        msg.append(f"step 4 at {'the converged' if budget else 'the default'}"
                   f" budget {time.perf_counter() - t:.1f}s "
                   f"({t4['lm_lm_steps']} LM steps, {t4['lm_cg_sweeps']} CG "
                   f"sweeps, {t4['lm_host_reads']} host reads)")
    log(f"mesh (a) {tag}: " + "; ".join(msg))
    return rd, kp3d


def check_mesh_steps(root, dev="cuda"):
    """(a) Steps 2-4 under ``make_mesh()`` (one entry on a one-card machine)
    and under four entries of ``cuda:0`` against ``mesh=None``: the
    one-device mesh's pickles equal (step 4 at the production budget);
    the four-entry mesh's ``bcomb`` sets equal, ``kp2d`` within 1e-9 with
    equal NaN patterns, ``kp3d`` at the converged budget finite in the
    same places and within 2 mm (tests/test_multichip.py's bounds); the
    SVT's iterations and host reads those of one batch."""
    from macaque_tpu_torch.core.mesh import make_mesh
    from macaque_tpu_torch.pipeline.artifacts import read_pickle
    from macaque_tpu_torch.tools.synthetic import (
        make_test_rig, simulate_scene, synthesize_alldata)

    sc = MESH_SCENE
    rig = make_test_rig(sc["n_cam"], seed=sc["rig_seed"])
    kp3d = simulate_scene(sc["n_animal"], sc["n_frame"], seed=sc["kp3d_seed"])
    percam = synthesize_alldata(rig, kp3d, seed=sc["alldata_seed"])
    dev = torch.device(dev)
    entry = torch.device(dev.type, 0) if dev.type == "cuda" else dev
    runs = {"single": (None, (None, MESH_CONVERGED)),
            "one_device": (make_mesh() if dev.type == "cuda"
                           else make_mesh(devices=[dev]), (None,)),
            "four_entries": (make_mesh(devices=[entry] * 4),
                             (MESH_CONVERGED,))}
    rd, k3, times = {}, {}, {}
    for tag, (mesh, budgets) in runs.items():
        times[tag] = {}
        rd[tag], k3[tag] = mesh_steps(root, tag, rig, percam, mesh, budgets,
                                      times[tag], dev)

    def load(tag, name):
        return read_pickle(os.path.join(rd[tag], name))

    def bcombs(mk):
        return [(k["frame"], {tuple(np.asarray(b).tolist())
                              for b in k["bcomb"]}) for k in mk]

    for name in ("match_keyframe.pickle", "kp2d.pickle", "track.pickle",
                 "kp2d_f.pickle"):
        if pickle_bytes(load("single", name)) != pickle_bytes(
                load("one_device", name)):
            raise AssertionError(f"mesh (a): {name} under the one-device mesh "
                                 "differs from mesh=None")
    if pickle_bytes(k3["single"][0]) != pickle_bytes(k3["one_device"][0]):
        raise AssertionError("mesh (a): kp3d.pickle under the one-device "
                             "mesh differs from mesh=None")
    mk_s = load("single", "match_keyframe.pickle")
    mk_m = load("four_entries", "match_keyframe.pickle")
    if not (len(mk_s) == len(mk_m) > 3 and bcombs(mk_s) == bcombs(mk_m)):
        raise AssertionError("mesh (a): keyframe bcombs differ under the "
                             "four-entry mesh")
    k2s, k2m = (np.asarray(load(t, "kp2d.pickle"))
                for t in ("single", "four_entries"))
    ok = ~np.isnan(k2s)
    d2 = float(np.abs(k2s[ok] - k2m[ok]).max()) if ok.any() else 0.0
    if not ((np.isnan(k2s) == np.isnan(k2m)).all() and d2 <= 1e-9):
        raise AssertionError(f"mesh (a): kp2d differs under the four-entry "
                             f"mesh ({d2})")
    k3s, k3m = k3["single"][-1]["kp3d"], k3["four_entries"][-1]["kp3d"]
    fin = np.isfinite(k3s)
    d3 = float(np.abs(k3s[fin] - k3m[fin]).max())
    log(f"mesh (a): one-device mesh pickles equal; four entries: "
        f"{len(mk_s)} keyframes' bcombs equal, kp2d |d| {d2:.3e}, kp3d "
        f"|d| {d3:.6f} mm over {int(fin.sum())} finite values")
    if not ((fin == np.isfinite(k3m)).all() and fin.any() and d3 < 2.0):
        raise AssertionError(f"mesh (a): kp3d under the four-entry mesh "
                             f"beyond 2 mm ({d3})")
    svt = {t: (v["step2"]["svt_iterations"], v["step2"]["svt_host_reads"])
           for t, v in times.items()}
    if len(set(svt.values())) != 1:
        raise AssertionError(f"mesh (a): the SVT's iterations and host "
                             f"reads differ across the meshes {svt}")


def pickle_bytes(obj) -> bytes:
    import pickle

    return pickle.dumps(obj, protocol=4)


def check_mesh_perception(models):
    """(b) The parity perception's ``detect``, ``pose`` and ``classify`` on
    6 frames of 2048x1536 under four entries of ``cuda:0`` against
    ``mesh=None`` (shards of 2 frames, the last one padded), within the
    bounds of ``tests/test_torch_cuda.py``'s card test: boxes 0.05 px,
    scores 1e-4, labels equal, ID scores 1e-4; the pose's NaN pattern
    equal, keypoint scores 1e-4, keypoints 0.05 px where their score
    reaches 0.3 and at least 90 % of all joints within 0.05 px
    (tests/test_torch_run2d.py's rule). Returns the K1 and K2 launches of
    the sharded calls."""
    from macaque_tpu_torch import kernels
    from macaque_tpu_torch.core.mesh import make_mesh
    from macaque_tpu_torch.pipeline.perception import TorchPerception

    det, pose, idm = models[:3]
    single = TorchPerception(det, pose, idm, max_det=8, device="cuda")
    mesh = make_mesh(devices=[torch.device("cuda", 0)] * 4)
    sharded = TorchPerception(det, pose, idm, max_det=8, mesh=mesh)
    frames = synthetic_frames(MESH_FRAMES)
    b0, s0 = single.detect(frames)
    valid = s0 > 0.85
    k0 = single.pose(frames, b0, valid)
    l0, c0 = single.classify(frames, b0, valid)
    kernels.reset_launches()
    t = time.perf_counter()
    b1, s1 = sharded.detect(frames)
    k1 = sharded.pose(frames, b0, valid)
    l1, c1 = sharded.classify(frames, b0, valid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    if not (valid.any() and launches["packed_attention"] > 0
            and launches["roi_align_windowed"] > 0):
        raise AssertionError("mesh (b): the sharded perception launched no "
                             "K1 or no K2")
    db, ds = float(np.abs(b0 - b1).max()), float(np.abs(s0 - s1).max())
    dks = float(np.abs(k0[valid][..., 2] - k1[valid][..., 2]).max())
    sure = k0[..., 2] >= 0.3
    dk = float(np.abs(k0[sure][:, :2] - k1[sure][:, :2]).max()) \
        if sure.any() else 0.0
    moved = np.abs(k1[valid][..., :2] - k0[valid][..., :2]).max(-1)
    near = float(np.mean(moved <= 0.05))
    dc = float(np.abs(c0 - c1).max())
    log(f"mesh (b): perception on {MESH_FRAMES} frames under 4 entries "
        f"{wall:.3f}s; {int(valid.sum())} boxes kept; |d box| {db:.3e} px, "
        f"|d score| {ds:.3e}, |d keypoint score| {dks:.3e}, |d keypoint| "
        f"{dk:.3e} px where the score reaches 0.3, {near:.4f} of the joints "
        f"within 0.05 px, labels equal {bool((l0 == l1).all())}, |d id "
        f"score| {dc:.3e}; launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    if not (b1.shape == b0.shape and (np.isnan(k0) == np.isnan(k1)).all()
            and np.isfinite(b1).all()):
        raise AssertionError("mesh (b): malformed sharded perception output")
    if not (db <= 0.05 and ds <= 1e-4 and dks <= 1e-4 and dk <= 0.05
            and near >= 0.9 and (l0 == l1).all() and dc <= 1e-4):
        raise AssertionError("mesh (b): the sharded perception is outside "
                             "the card test's bounds")
    return launches


def phase_mesh(models):
    """``core/mesh.py`` on the card: (a) steps 2-4 under a one-device and a
    four-entry mesh against ``mesh=None``; (b) the parity perception under
    the four-entry mesh. Returns (b)'s launches."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=REPO,
                                     prefix=".chip_smoke_mesh_") as root:
        check_mesh_steps(root)
    launches = check_mesh_perception(models)
    log(f"mesh: phase {time.perf_counter() - t0:.1f}s")
    return launches


BENCH_FRAMES = 32     # the tools phase's pipeline_bench scene (x 4 cameras)
BENCH_KEYS = {"camera_frames", "stages_s", "pipeline_rest_s",
              "pipeline_rest_s_per_cf", "pipeline_cf_s",
              "device_round_trip_s", "device", "step1_real_s",
              "e2e_measured_s", "e2e_measured_cf_s"}


def check_pipeline_bench():
    """(a) ``tools.pipeline_bench.run`` at 32 frames x 4 cameras, render
    off, with the ``serving`` real tier alone: its keys, its stages, and
    the serving tier's K1, K2 and K5b launches. Returns the launches."""
    import tempfile

    from macaque_tpu_torch import kernels
    from macaque_tpu_torch.tools import pipeline_bench

    env = {"BENCH_STEP1_REAL": "1", "BENCH_STEP1_PARITY": "0",
           "BENCH_STEP1_FAST": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    kernels.reset_launches()
    try:
        with tempfile.TemporaryDirectory(dir=REPO,
                                         prefix=".chip_smoke_tools_") as root:
            t = time.perf_counter()
            out = pipeline_bench.run(n_frame=BENCH_FRAMES, n_cam=4,
                                     render=False, root=root)
            wall = time.perf_counter() - t
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    launches = dict(kernels.LAUNCHES)
    log(f"tools (a): pipeline_bench {wall:.1f}s: {json.dumps(out)}")
    if set(out) != BENCH_KEYS or out["camera_frames"] != 4 * BENCH_FRAMES:
        raise AssertionError(f"tools (a): pipeline_bench keys {sorted(out)}")
    if not (all(v > 0 for v in out["stages_s"].values())
            and out["step1_real_s"] > 0
            and np.isfinite(out["e2e_measured_cf_s"])):
        raise AssertionError("tools (a): malformed pipeline_bench line")
    for k in ("packed_attention", "roi_align_windowed", "quant_int8_matmul"):
        if launches[k] <= 0:
            raise AssertionError(f"tools (a): the serving tier launched no {k}")
    return launches


def check_probes():
    """(b) One cheap variant list of each probe: int8 ``micro`` on fc2 (all
    four routes), roialign at a 128-RoI chunk, the trunk as ``map1``."""
    from macaque_tpu_torch.tools import int8_probe, roialign_probe, trunk_probe

    dev = torch.device("cuda")
    t = time.perf_counter()
    lines = int8_probe.run_micro(dev, ["fc2"], iters=10)
    lines += roialign_probe.main(["128", "--iters", "2"])
    lines += trunk_probe.main(["map1", "--iters", "2"])
    log(f"tools (b): probes {time.perf_counter() - t:.1f}s")
    ms = [ln.get("ms", ln.get("ms_per_chunk")) for ln in lines]
    if not (len(lines) == 6 and all(m is not None and m > 0 for m in ms)
            and lines[4]["k2_launches"] > 0):
        raise AssertionError(f"tools (b): malformed probe lines {lines}")
    try:
        trunk_probe.main(["remat"])
    except NotImplementedError as e:
        log(f"tools (b): trunk_probe remat refused: {e}")
    else:
        raise AssertionError("tools (b): trunk_probe remat did not raise")


# a fixed bench.py-shaped line (made-up numbers, not a measurement) for
# ``check_perf_tables``; the card's name goes where pipeline_bench puts it
PERF_LINE = {
    "metric": "e2e_camera_frames_per_sec_per_chip", "value": 10.0,
    "detail": {
        "kernel_cf_s": 20.0, "kernel_cf_s_int8": 21.0,
        "kernel_cf_s_serving": 22.0, "kernel_cf_s_fast": 23.0,
        "kernel_ms_per_chunk": {"det": 500.0, "pose": 300.0, "id": 20.0,
                                "tri": 0.5},
        "det_fast_ms": 450.0, "det_640_ms": 400.0, "pose_int8_ms": 280.0,
        "pose_noflip_int8_ms": 150.0,
        "pipeline": {"camera_frames": 480,
                     "stages_s": {"step1_host": 2.0, "step4_3d": 3.0},
                     "pipeline_rest_s": 6.0, "pipeline_rest_s_per_cf": 0.0125},
        "tier_note": "value = parity-semantics additive e2e"}}


# Stand-ins for the two files ``perf_tables.main()`` rewrites: README.md with
# the JAX tool's ``BENCH`` block beside the port's, PERF.md with the port's.
MARKED_FILES = {
    "README.md": ("# README\n\n<!-- BENCH:START -->\nThe JAX tool's block, "
                  "which the port's tool leaves as it is.\n"
                  "<!-- BENCH:END -->\n\n<!-- TORCH_BENCH:START -->\n"
                  "No line of the card rendered yet.\n"
                  "<!-- TORCH_BENCH:END -->\n"),
    "PERF.md": ("# PERF\n\n<!-- TORCH_BENCH:START -->\n"
                "No line of the card rendered yet.\n"
                "<!-- TORCH_BENCH:END -->\n"),
}


def check_perf_tables():
    """(c) ``tools/perf_tables.py`` on the card's machine: ``PERF_LINE``
    with the card's name and power limit (``pipeline_bench.device_name``)
    rendered by its ``main()`` into a temporary README.md and PERF.md
    written here (``MARKED_FILES``), so the check reads no document of the
    checkout. Each file's ``TORCH_BENCH`` block must be the tool's block and
    name the card, README's ``BENCH`` block must stay as it was, and the
    same line naming the CPU must be refused."""
    import copy
    import tempfile

    from macaque_tpu_torch.tools import perf_tables, pipeline_bench

    card = pipeline_bench.device_name("cuda")
    line = copy.deepcopy(PERF_LINE)
    line["detail"]["pipeline"]["device"] = card
    header = f"| tier (semantics) | camera-frames/s (1x {card}) |"
    files = ("README.md", "PERF.md")
    blocks = (perf_tables.readme_block(line, "line.json"),
              perf_tables.arch_block(line, "line.json"))
    saved = perf_tables.repo_root
    with tempfile.TemporaryDirectory(dir=REPO,
                                     prefix=".chip_smoke_tools_") as root:
        for f in files:
            with open(os.path.join(root, f), "w") as fh:
                fh.write(MARKED_FILES[f])
        path = os.path.join(root, "line.json")
        with open(path, "w") as fh:
            json.dump(line, fh)
        perf_tables.repo_root = lambda: root
        try:
            perf_tables.main(["--bench", path])
            line["detail"]["pipeline"]["device"] = "cpu"
            with open(path, "w") as fh:
                json.dump(line, fh)
            try:
                perf_tables.main(["--bench", path])
            except SystemExit as e:
                refused = str(e)
            else:
                refused = None
        finally:
            perf_tables.repo_root = saved
        texts = {}
        for f in files:
            with open(os.path.join(root, f)) as fh:
                texts[f] = fh.read()

    def between(text, marker):
        start, end = f"<!-- {marker}:START -->\n", f"\n<!-- {marker}:END -->"
        return text.split(start)[1].split(end)[0]

    bench_kept = between(MARKED_FILES["README.md"], "BENCH") == between(
        texts["README.md"], "BENCH")
    rendered = all(between(texts[f], "TORCH_BENCH") == b
                   for f, b in zip(files, blocks))
    log(f"tools (c): perf_tables rendered a line of {card!r} into a "
        f"marked README.md and PERF.md: blocks equal {rendered}, header "
        f"names the card {header in texts['README.md']}, BENCH block kept "
        f"{bench_kept}; "
        f"a CPU line refused: {refused}")
    if not (rendered and header in texts["README.md"] and card in blocks[1]
            and bench_kept and refused):
        raise AssertionError("tools (c): perf_tables did not render the "
                             "card's line as it should")


def phase_tools():
    """The port's benchmark tool and probes on the card, and the table
    renderer. Returns the pipeline_bench serving tier's launches."""
    t0 = time.perf_counter()
    launches = check_pipeline_bench()
    check_probes()
    check_perf_tables()
    log(f"tools: phase {time.perf_counter() - t0:.1f}s")
    return launches


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
    ap.add_argument("--phases",
                    default="device,build,kernels,main,step2,step3,step4,"
                            "pipeline,tracker,eval2d,train,calib,session,"
                            "mesh,tools")
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
    entries, models, perception = [], None, None
    if {"kernels", "main", "pipeline", "eval2d"} & set(phases):
        models = build_models(torch.device("cuda"), torch.bfloat16)
    if "kernels" in phases:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        entries = [check_attention(gen), check_roialign(gen),
                   check_quantize_rows(gen), check_int8_matmul(gen),
                   check_window_attention(gen), check_unpacked_attention(gen),
                   check_swin_block(gen, models[0].backbone),
                   check_relpos_attention(gen)]
        torch.cuda.empty_cache()
    runs = {}
    if "main" in phases:
        runs, perception, store, T = phase_main(*models)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        runs["fused_trunk"] = phase_fused_trunk(models[0], perception,
                                                store.frames[:CHUNK])
        runs["attention"] = phase_attention_path(gen)
        runs["split_int8"] = phase_split_path(gen)
        if "profile" in phases:
            phase_profile(perception, store, T)
    steps = [p for p in ("step2", "step3", "step4") if p in phases]
    if steps:
        import tempfile

        # steps 3 and 4 read what the step before wrote: each step phase
        # runs the ones before it. The scene's large JSON goes to a
        # temporary directory inside the checkout (nothing is written
        # outside it), removed at the end
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=REPO,
                                         prefix=".chip_smoke_steps_") as root:
            rig, kp3d, wall = phase_step2(root)
            walls = [wall]
            if steps[-1] in ("step3", "step4"):
                walls.append(phase_step3(root, rig, kp3d))
            if steps[-1] == "step4":
                walls.append(phase_step4(root, rig, kp3d))
        log(f"steps 2-{steps[-1][-1]}: run_step* walls "
            f"{' + '.join(f'{w:.1f}' for w in walls)} = {sum(walls):.1f}s; "
            f"with the scene and the checks {time.perf_counter() - t:.1f}s")
    if {"pipeline", "tracker"} & set(phases):
        import tempfile

        # the scene's stores, in a temporary directory of the checkout
        # (nothing is written outside it), removed at the end
        with tempfile.TemporaryDirectory(
                dir=REPO, prefix=".chip_smoke_pipeline_") as root:
            scene = pipeline_stores(root)
            if "pipeline" in phases:
                from macaque_tpu_torch.pipeline.perception import (
                    TorchPerception)

                perception = perception or TorchPerception(
                    *models[:3], max_det=8, device=torch.device("cuda"))
                runs["pipeline_store"] = phase_pipeline(perception, root,
                                                        *scene)
            if "tracker" in phases:
                phase_tracker(root, *scene)
    if "eval2d" in phases:
        from macaque_tpu_torch.pipeline.perception import TorchPerception

        perception = perception or TorchPerception(
            *models[:3], max_det=8, device=torch.device("cuda"))
        runs["pose2d"] = phase_eval2d(perception)
    if "train" in phases:
        models = perception = None
        torch.cuda.empty_cache()
        phase_train()
    if "calib" in phases:
        torch.cuda.empty_cache()
        phase_calib()
    if "session" in phases:
        torch.cuda.empty_cache()
        phase_session()
    # the mesh and the tools run last: the phases of the earlier slices
    # keep their order, so their times compare with the earlier runs'
    if "mesh" in phases:
        torch.cuda.empty_cache()
        runs["mesh_perception"] = phase_mesh(
            models or build_models(torch.device("cuda"), torch.bfloat16))
    if "tools" in phases:
        models = perception = None
        torch.cuda.empty_cache()
        runs["pipeline_bench"] = phase_tools()
    launches = {}
    if "main" in phases:
        from macaque_tpu_torch import kernels

        # each kernel's launches on the paths, each run counted alone
        launches = {k: sum(r[k] for r in runs.values()) for k in kernels.LAUNCHES}
        log(f"launches on the paths: {launches}")
        for k, n in launches.items():
            if n <= 0:
                raise AssertionError(f"no path launched kernel {k}")
    for e in entries:
        e["launches"] = launches.get(e["name"], 0)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the keys every entry has, then any of an entry's own (K7's shapes)
    print(json.dumps({"kernels": [{**{k: e[k] for k in keys}, **e}
                                  for e in entries]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
