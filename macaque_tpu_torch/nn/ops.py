"""Detection ops: anchors, box coding, IoU, static-shape NMS, the exact
aligned RoIAlign by flat gather and the geometry of the windowed RoIAlign.

PyTorch counterparts of ``macaque_tpu/nn/ops.py`` (mmdet anchor
generation, DeltaXYWH decoding, greedy NMS, mmcv aligned RoIAlign), with
the same semantics. Box tensors may carry leading batch dimensions.
"""

from __future__ import annotations

import math

import numpy as np
import torch


# ----------------------------------------------------------------- anchors

def make_anchors(feat_sizes, strides, scales=(8.0,), ratios=(0.5, 1.0, 2.0)
                 ) -> list[np.ndarray]:
    """mmdet AnchorGenerator semantics (center_offset 0): per level, base
    anchors of area (scale*stride)^2 at each ratio, tiled over the feature
    grid. Returns one (H*W*A, 4) xyxy float32 array per level."""
    out = []
    for (H, W), stride in zip(feat_sizes, strides):
        base = []
        for r in ratios:
            for s in scales:
                size = s * stride
                w = size * np.sqrt(1.0 / r)
                h = size * np.sqrt(r)
                base.append([-w / 2, -h / 2, w / 2, h / 2])
        base = np.asarray(base)
        xs = (np.arange(W) * stride)[None, :, None]
        ys = (np.arange(H) * stride)[:, None, None]
        ctr = np.stack(
            [np.broadcast_to(xs, (H, W, 1)), np.broadcast_to(ys, (H, W, 1))],
            axis=-1,
        ).reshape(H, W, 1, 2)
        anchors = np.concatenate([ctr, ctr], axis=-1) + base[None, None]
        out.append(anchors.reshape(-1, 4).astype(np.float32))
    return out


# ------------------------------------------------------------- box coding

def delta2bbox(anchors, deltas, stds=(1.0, 1.0, 1.0, 1.0), max_shape=None,
               wh_ratio_clip=16 / 1000):
    """mmdet DeltaXYWHBBoxCoder.decode (means 0)."""
    d = deltas * torch.as_tensor(stds, dtype=deltas.dtype, device=deltas.device)
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) / 2
    ay = (anchors[..., 1] + anchors[..., 3]) / 2
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = d[..., 2].clamp(-max_ratio, max_ratio)
    dh = d[..., 3].clamp(-max_ratio, max_ratio)
    cx = ax + d[..., 0] * aw
    cy = ay + d[..., 1] * ah
    w = aw * torch.exp(dw)
    h = ah * torch.exp(dh)
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if max_shape is not None:
        h_img, w_img = max_shape
        boxes = torch.stack([
            boxes[..., 0].clamp(0, w_img), boxes[..., 1].clamp(0, h_img),
            boxes[..., 2].clamp(0, w_img), boxes[..., 3].clamp(0, h_img),
        ], -1)
    return boxes


# -------------------------------------------------------------------- IoU

def bbox_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., N, 4) x (..., M, 4) xyxy boxes -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]).clamp_min(0) * (a[..., 3] - a[..., 1]).clamp_min(0)
    area_b = (b[..., 2] - b[..., 0]).clamp_min(0) * (b[..., 3] - b[..., 1]).clamp_min(0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp_min(1e-9)


# -------------------------------------------------------------------- NMS

def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
              max_out: int):
    """Exact greedy NMS with a fixed output size, batched over leading dims.

    The greedy recurrence ``alive[i] = !any(j < i: alive[j] & iou > thr)``
    is solved by fixed-point sweeps from all-alive (each sweep one masked
    (N, N) product), as in the JAX package. boxes (..., N, 4), scores
    (..., N) with invalid entries at -inf. Returns (keep_idx (..., max_out),
    keep_valid (..., max_out) bool) in descending score order.
    """
    N = boxes.shape[-2]
    order = torch.argsort(scores, dim=-1, descending=True)
    b = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    s = torch.gather(scores, -1, order)
    tri = torch.ones((N, N), dtype=torch.bool, device=boxes.device).tril(-1)
    # sup[i, j] = 1 when higher-ranked j overlaps i
    sup = ((bbox_iou(b, b) > iou_thr) & tri).to(torch.float32)
    valid = s > -math.inf
    alive = valid
    for _ in range(N):
        hit = (sup @ alive.to(sup.dtype)[..., None])[..., 0] > 0
        new = valid & ~hit
        if torch.equal(new, alive):
            break
        alive = new
    alive_scores = torch.where(alive, s, torch.full_like(s, -math.inf))
    top_scores, top = torch.topk(alive_scores, max_out, dim=-1)
    return torch.gather(order, -1, top), top_scores > -math.inf


def batched_nms_fixed(boxes, scores, ids, iou_thr, max_out):
    """Class/level-aware NMS via the coordinate-offset trick (mmcv
    batched_nms semantics), per leading batch entry."""
    top = boxes.flatten(-2).amax(-1)[..., None, None]
    offset = ids.to(boxes.dtype)[..., None] * (top + 1.0)
    return nms_fixed(boxes + offset, scores, iou_thr, max_out)


# --------------------------------------------------- windowed RoIAlign

def _roi_level_canvas(feats) -> torch.Tensor:
    """Level stack on a common (H0, W0) canvas, zero beyond each level's
    extent: (B, L, H0, W0, C)."""
    B, H0, W0, C = feats[0].shape
    canvas = feats[0].new_zeros((B, len(feats), H0, W0, C))
    for l, f in enumerate(feats):
        canvas[:, l, :f.shape[1], :f.shape[2]] = f
    return canvas


def _roi_sample_grids(feats, rois, levels, out_size, strides, sampling_ratio):
    """Per-RoI bilinear sample coordinates in assigned-level feature-map
    units (mmcv aligned RoIAlign grid).

    Returns (gy (B, R, out*s), gx (B, R, out*s), Hs (B, R), Ws (B, R)),
    Hs/Ws the assigned level's valid extents."""
    L = len(feats)
    dev = rois.device
    Hs = torch.as_tensor([f.shape[1] for f in feats], device=dev)[levels]
    Ws = torch.as_tensor([f.shape[2] for f in feats], device=dev)[levels]
    scale = torch.as_tensor(1.0 / np.asarray(strides, np.float32)[:L],
                            dtype=rois.dtype, device=dev)[levels]
    gy, gx = _aligned_samples(rois, scale, out_size, sampling_ratio)
    return gy, gx, Hs, Ws


def _aligned_samples(rois, scale, out_size, sampling_ratio):
    """The mmcv aligned RoIAlign grid: rois (..., 4) image-coordinate xyxy,
    scale a float or (...,) per RoI. Returns (gy, gx), each (..., out*s)
    in feature-map units."""
    s = sampling_ratio
    x1 = rois[..., 0] * scale - 0.5
    y1 = rois[..., 1] * scale - 0.5
    x2 = rois[..., 2] * scale - 0.5
    y2 = rois[..., 3] * scale - 0.5
    grid = (torch.arange(out_size * s, dtype=rois.dtype,
                         device=rois.device) + 0.5) / s
    gy = y1[..., None] + grid * ((y2 - y1) / out_size)[..., None]
    gx = x1[..., None] + grid * ((x2 - x1) / out_size)[..., None]
    return gy, gx


def _roi_window_geometry(feats, rois, levels, out_size, strides,
                         sampling_ratio, window, canvas=None):
    """Front half of the windowed RoIAlign: the common level canvas, each
    RoI's window start and the separable interpolation matrices.

    Returns (canvas (B, L, H0, W0, C), ys (B, R) int, xs (B, R) int,
    Ky (B, R, out, window), Kx (B, R, out, window), window), the matrices
    in the RoIs' dtype with the s-sample average folded in."""
    B, H0, W0, C = feats[0].shape
    window = min(window, H0, W0)   # tiny inputs: window can't exceed canvas
    if canvas is None:
        canvas = _roi_level_canvas(feats)
    gy, gx, Hs, Ws = _roi_sample_grids(feats, rois, levels, out_size, strides,
                                       sampling_ratio)

    def axis_matrix(g, extent, max_start):
        center = 0.5 * (g[..., 0] + g[..., -1])
        start = torch.minimum(
            (torch.floor(center).long() - window // 2).clamp_min(0),
            max_start.clamp_min(0))
        ext = extent.to(g.dtype)[..., None]
        # mmcv semantics: samples fully outside (-1, extent) contribute 0;
        # inside samples clamp their stencil to [0, extent-1]
        inside = (g > -1.0) & (g < ext)
        gc = torch.minimum(g.clamp_min(0.0), ext - 1.0)
        rel = (gc - start.to(g.dtype)[..., None]).clamp(0.0, window - 1.0)
        idx = torch.arange(window, dtype=g.dtype, device=g.device)
        K = (1.0 - (rel[..., None] - idx).abs()).clamp_min(0.0)
        return start, K * inside[..., None]

    ys, Ky = axis_matrix(gy, Hs, Hs - window)
    xs, Kx = axis_matrix(gx, Ws, Ws - window)
    s = sampling_ratio
    Bq, Rq = rois.shape[:2]
    Ky = Ky.reshape(Bq, Rq, out_size, s, window).mean(3)
    Kx = Kx.reshape(Bq, Rq, out_size, s, window).mean(3)
    return canvas, ys, xs, Ky, Kx, window


# ------------------------------------------------------ exact RoIAlign

def _bilinear_pool(table, base, Hr, Wr, gy, gx, out_size, s, weight_dtype):
    """Aligned bilinear samples of the outer grid gy x gx, each RoI reading
    rows ``base + y * Wr + x`` of the flat ``table`` (N, C); averaged over
    the s x s samples of each bin.

    base, Hr, Wr (..., R) int; gy, gx (..., R, out*s) in level units.
    Samples fully outside (-1, extent) give 0; the stencil's corners clamp
    to the level's extent (index clipping, as the JAX package's gather).
    Returns (..., R, out, out, C)."""
    n = gy.shape[-1]
    yq = gy[..., :, None].expand(*gy.shape, n)
    xq = gx[..., None, :].expand(*gx.shape[:-1], n, n)
    y0, x0 = torch.floor(yq), torch.floor(xq)
    wy = (yq - y0)[..., None].to(weight_dtype)
    wx = (xq - x0)[..., None].to(weight_dtype)
    Hm, Wm = (Hr - 1)[..., None, None], (Wr - 1)[..., None, None]
    y0i = torch.minimum(y0.long().clamp_min(0), Hm)
    x0i = torch.minimum(x0.long().clamp_min(0), Wm)
    y1i = torch.minimum(y0i + 1, Hm)
    x1i = torch.minimum(x0i + 1, Wm)
    Hf, Wf = Hr.to(yq.dtype)[..., None, None], Wr.to(xq.dtype)[..., None, None]
    inside = (yq > -1.0) & (yq < Hf) & (xq > -1.0) & (xq < Wf)
    base, Wrow = base[..., None, None], Wr[..., None, None]
    v00 = table[base + y0i * Wrow + x0i]
    v01 = table[base + y0i * Wrow + x1i]
    v10 = table[base + y1i * Wrow + x0i]
    v11 = table[base + y1i * Wrow + x1i]
    val = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
           + v10 * wy * (1 - wx) + v11 * wy * wx)
    val = torch.where(inside[..., None], val, 0.0)
    lead = gy.shape[:-1]
    return val.reshape(*lead, out_size, s, out_size, s,
                       table.shape[-1]).mean((-4, -2))


def roi_align(feat: torch.Tensor, rois: torch.Tensor, out_size: int,
              spatial_scale: float, sampling_ratio: int = 2) -> torch.Tensor:
    """Aligned RoIAlign (mmcv aligned=True: half-pixel offset) on one
    feature map, by flat gather, with a fixed sampling ratio as in the JAX
    package (the reference's adaptive ratio 0 gives shapes that depend on
    the boxes).

    feat (H, W, C); rois (R, 4) xyxy in image coordinates. Returns (R, out,
    out, C), in the promoted dtype of feat and rois."""
    H, W, C = feat.shape
    gy, gx = _aligned_samples(rois, spatial_scale, out_size, sampling_ratio)
    zero = torch.zeros(rois.shape[0], dtype=torch.long, device=rois.device)
    return _bilinear_pool(feat.reshape(H * W, C), zero, zero + H, zero + W,
                          gy, gx, out_size, sampling_ratio, gy.dtype)


def roi_align_pyramid(feats, rois: torch.Tensor, levels: torch.Tensor,
                      out_size: int, strides, sampling_ratio: int = 2
                      ) -> torch.Tensor:
    """Aligned RoIAlign over an FPN pyramid in one gather: the level maps
    are flattened into one (sum(H*W), C) row table, and each RoI's bilinear
    samples index its assigned level through a per-level row offset. The
    exact oracle of the windowed route (``nn/roialign.py``).

    feats: list of (H_l, W_l, C); rois (R, 4) image-coordinate xyxy; levels
    (R,) int in [0, len(feats)). Returns (R, out, out, C). Batched inputs,
    feats (B, H_l, W_l, C), rois (B, R, 4), levels (B, R), flatten the batch
    into the same table (each image's rows after the last one's) and return
    (B, R, out, out, C). The interpolation weights are cast to the table's
    dtype, as the JAX package combines them."""
    batched = feats[0].dim() == 4
    if not batched:
        feats, rois, levels = [f[None] for f in feats], rois[None], levels[None]
    B, C, dev = feats[0].shape[0], feats[0].shape[-1], rois.device
    sizes = np.array([f.shape[1] * f.shape[2] for f in feats])
    offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(sizes)[:-1]]),
                              device=dev)
    table = torch.cat([f.reshape(B, -1, C) for f in feats], 1).reshape(-1, C)
    gy, gx, Hs, Ws = _roi_sample_grids(feats, rois, levels, out_size, strides,
                                       sampling_ratio)
    base = offsets[levels] + torch.arange(B, device=dev)[:, None] * int(sizes.sum())
    out = _bilinear_pool(table, base, Hs, Ws, gy, gx, out_size, sampling_ratio,
                         table.dtype)
    return out if batched else out[0]
