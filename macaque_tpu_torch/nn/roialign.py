"""Windowed pyramid RoIAlign for the detector's RoI head.

``roi_align_windowed`` is mmcv aligned RoIAlign (sampling ratio 2) over
FPN levels 0-3 in its separable form: the plain-PyTorch geometry
(``ops._roi_window_geometry``) gives each RoI a window start on the level
canvas and two interpolation matrices Ky, Kx (out x window), and
``roi_align_windows`` applies them to one window x window block per RoI.
On a CUDA tensor that step launches the hand-written kernel in
``csrc/roi_align_windowed.cu`` (bf16 canvas) or raises; on a CPU tensor it
runs ``roi_align_windows_reference``. Replaces
``macaque_tpu/nn/pallas_roialign.py::roi_align_windowed_fused`` and the
bucket dispatch of ``roi_align_windowed_switch``.
"""

from __future__ import annotations

import ctypes

import torch

from macaque_tpu_torch import kernels
from macaque_tpu_torch.nn.layers import acc_dtype
from macaque_tpu_torch.nn.ops import _roi_sample_grids, _roi_window_geometry

# Adaptive window ladder (roi_window_buckets). The last entry is the
# detector's worst-case window: RoIs no smaller bucket covers fall back to
# it, so bucketed outputs equal the fixed-window outputs by construction.
WINDOW_BUCKETS = (16, 24, 32, 48)


def roi_window_buckets(feats, rois, levels, out_size: int, strides,
                       sampling_ratio: int = 2, buckets=WINDOW_BUCKETS
                       ) -> torch.Tensor:
    """Per RoI, the index of the smallest window bucket that reproduces the
    largest bucket's RoIAlign output exactly: every bilinear stencil point
    of every in-bounds sample lies inside that bucket's window, placed by
    the same centring rule as the geometry. Returns (B, R) int64."""
    gy, gx, Hs, Ws = _roi_sample_grids(feats, rois, levels, out_size, strides,
                                       sampling_ratio)

    def axis_ok(g, ext, w):
        ext = ext.to(g.dtype)[..., None]
        inside = (g > -1.0) & (g < ext)
        gc = torch.minimum(g.clamp_min(0.0), (ext - 1.0).clamp_min(0.0))
        # the stencil of gc is {floor(gc), floor(gc)+1}; the upper neighbour
        # has zero weight when gc is integral, so ceil is the exact bound
        inf = torch.full_like(gc, float("inf"))
        lo = torch.where(inside, torch.floor(gc), inf).amin(-1)
        hi = torch.where(inside, torch.ceil(gc), -inf).amax(-1)
        center = 0.5 * (g[..., 0] + g[..., -1])
        start = torch.minimum((torch.floor(center) - w // 2).clamp_min(0.0),
                              (ext[..., 0] - w).clamp_min(0.0))
        ok = (start <= lo) & (hi <= start + w - 1)
        return ok | ~inside.any(-1)     # all-outside RoIs output zero anyway

    idx = torch.full(rois.shape[:2], len(buckets) - 1, dtype=torch.long,
                     device=rois.device)
    for i in range(len(buckets) - 2, -1, -1):
        w = buckets[i]
        ok = axis_ok(gy, Hs, w) & axis_ok(gx, Ws, w)
        idx = torch.where(ok, torch.full_like(idx, i), idx)
    return idx


def roi_align_windows_reference(canvas, plane, ys, xs, ky, kx,
                                chunk: int = 512) -> torch.Tensor:
    """Plain PyTorch version of the kernel. canvas (P, H0, W0, C); plane,
    ys, xs (R,) int; ky, kx (R, out, window) -> (R, out, out, C) in the
    canvas dtype, products accumulated in ky's dtype (f32 for a bf16
    canvas), ``chunk`` RoIs at a time to bound the window gather."""
    P, H0, W0, C = canvas.shape
    R, out_size, w = ky.shape
    ys = ys.clamp(0, H0 - w)
    xs = xs.clamp(0, W0 - w)
    ar = torch.arange(w, device=canvas.device)
    res = []
    for r0 in range(0, R, chunk):
        sl = slice(r0, r0 + chunk)
        iy = ys[sl, None] + ar
        ix = xs[sl, None] + ar
        win = canvas[plane[sl, None, None], iy[:, :, None], ix[:, None, :]]
        mid = torch.einsum("rpi,rijc->rpjc", ky[sl], win.to(ky.dtype))
        res.append(torch.einsum("rqj,rpjc->rpqc", kx[sl], mid))
    if not res:
        return canvas.new_zeros((0, out_size, out_size, C))
    return torch.cat(res).to(canvas.dtype)


def roi_align_windows(canvas, plane, ys, xs, ky, kx) -> torch.Tensor:
    """The RoI window step: the kernel on CUDA, the plain version on the
    CPU. Arguments as ``roi_align_windows_reference``; on CUDA the canvas
    is bf16 with a multiple of 32 channels, plane/ys/xs int32 and ky/kx
    float32 (ky's values bf16, as ``window_inputs`` rounds them; others
    are refused), all contiguous."""
    if canvas.device.type == "cpu":
        return roi_align_windows_reference(canvas, plane, ys, xs, ky, kx)
    if canvas.device.type != "cuda":
        raise ValueError(f"roi_align_windows: unsupported device {canvas.device}")
    kernels.refuse_grad("roi_align_windows", canvas, ky, kx)
    P, H0, W0, C = canvas.shape
    R, out_size, w = ky.shape
    if canvas.dtype != torch.bfloat16:
        raise TypeError(f"roi_align_windows: kernel takes a bfloat16 canvas, "
                        f"got {canvas.dtype}")
    # the kernel gives each warp 32 channels
    if out_size != 7 or kx.shape != ky.shape or C % 32 or w > min(64, H0, W0):
        raise ValueError(f"roi_align_windows: unsupported shapes canvas "
                         f"{tuple(canvas.shape)}, ky {tuple(ky.shape)}, "
                         f"kx {tuple(kx.shape)}")
    for name, t, dt in (("plane", plane, torch.int32), ("ys", ys, torch.int32),
                        ("xs", xs, torch.int32), ("ky", ky, torch.float32),
                        ("kx", kx, torch.float32)):
        if t.dtype != dt or t.device != canvas.device or t.shape[0] != R:
            raise TypeError(f"roi_align_windows: {name} must be {dt} with "
                            f"{R} rows on {canvas.device}")
    tensors = (canvas, plane, ys, xs, ky, kx)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("roi_align_windows: inputs must be contiguous")
    # the kernel multiplies by Ky on bf16 tensor cores, which is exact only
    # for bf16 values: one device-to-host read a call, which a CUDA graph's
    # capture cannot make (its warm-up call, made eagerly, is checked)
    if (not torch.cuda.is_current_stream_capturing()
            and not torch.equal(ky, ky.to(torch.bfloat16).to(torch.float32))):
        raise ValueError("roi_align_windows: ky must hold bfloat16 values "
                         "(as window_inputs rounds them)")
    out = torch.empty((R, out_size, out_size, C), dtype=canvas.dtype,
                      device=canvas.device)
    lib = kernels.library()
    err = lib.macaque_roi_align_windowed(
        *(ctypes.c_void_p(t.data_ptr()) for t in tensors),
        ctypes.c_void_p(out.data_ptr()), R, H0, W0, C, w,
        kernels.current_stream(canvas.device))
    kernels.check(err, "roi_align_windowed")
    kernels.LAUNCHES["roi_align_windowed"] += 1
    return out


def window_inputs(feats, rois, levels, out_size: int, strides,
                  sampling_ratio: int = 2, window: int = 48, canvas=None):
    """Geometry flattened to the window step's arguments: (canvas (B*L, H0,
    W0, C), plane, ys, xs (B*R,) int32, ky, kx (B*R, out, window)). The
    matrices are rounded to the canvas dtype (as the TPU kernel feeds
    them) and carried in at least f32."""
    canvas, ys, xs, Ky, Kx, window = _roi_window_geometry(
        feats, rois, levels, out_size, strides, sampling_ratio, window, canvas)
    B, L, H0, W0, C = canvas.shape
    n = ys.numel()
    acc = acc_dtype(canvas.dtype)
    plane = (torch.arange(B, device=rois.device)[:, None] * L + levels)
    as_i32 = lambda t: t.reshape(n).to(torch.int32).contiguous()  # noqa: E731
    as_k = lambda K: (K.reshape(n, out_size, window).to(canvas.dtype)  # noqa: E731
                      .to(acc).contiguous())
    return (canvas.reshape(B * L, H0, W0, C), as_i32(plane), as_i32(ys),
            as_i32(xs), as_k(Ky), as_k(Kx))


def roi_align_windowed(feats, rois, levels, out_size: int, strides,
                       sampling_ratio: int = 2, window: int = 48,
                       canvas=None) -> torch.Tensor:
    """feats: list of (B, H_l, W_l, C); rois (B, R, 4) image-coord xyxy;
    levels (B, R) int. Returns (B, R, out, out, C) in the feats' dtype.
    ``canvas`` may supply a prebuilt ``ops._roi_level_canvas(feats)``."""
    B, R = rois.shape[:2]
    args = window_inputs(feats, rois, levels, out_size, strides,
                         sampling_ratio, window, canvas)
    return roi_align_windows(*args).reshape(B, R, out_size, out_size,
                                            feats[0].shape[-1])


def roi_align_windowed_reference(feats, rois, levels, out_size: int, strides,
                                 sampling_ratio: int = 2, window: int = 48,
                                 canvas=None) -> torch.Tensor:
    """``roi_align_windowed`` through the plain window step on any device."""
    B, R = rois.shape[:2]
    args = window_inputs(feats, rois, levels, out_size, strides,
                         sampling_ratio, window, canvas)
    return roi_align_windows_reference(*args).reshape(
        B, R, out_size, out_size, feats[0].shape[-1])
