"""The detector's proposals, RoI head and NMS in plain PyTorch and NumPy.

mmdet's test-time semantics for the bbox-only Mask R-CNN: anchors of
scale 8 at ratios 0.5/1/2 on strides 4..64 (center offset 0), DeltaXYWH
decoding (RPN stds 1, RCNN stds 0.1/0.1/0.2/0.2, the 16/1000 clip),
per-level top-``nms_pre`` then level-aware NMS at 0.7 to ``rpn_max``
proposals, FPN level assignment ``floor(log2(sqrt(wh) / 56))`` on levels
0-3, aligned RoIAlign 7x7 with sampling ratio 2 by exact bilinear gather
(mmcv's border rule: coordinates in [-1, 0) read the first row),
softmax scores, score threshold 0.05, NMS at 0.5 to ``rcnn_max``. NMS is
the plain greedy loop.
"""

from __future__ import annotations

import math

import numpy as np
import torch

STRIDES = (4, 8, 16, 32, 64)


def anchors(sizes, strides=STRIDES, scale=8.0, ratios=(0.5, 1.0, 2.0)):
    """One (H*W*A, 4) xyxy array per level, in (H, W, A) order."""
    out = []
    for (H, W), s in zip(sizes, strides):
        base = []
        for r in ratios:
            w, h = scale * s * np.sqrt(1.0 / r), scale * s * np.sqrt(r)
            base.append([-w / 2, -h / 2, w / 2, h / 2])
        xs, ys = np.meshgrid(np.arange(W) * s, np.arange(H) * s)
        ctr = np.stack([xs, ys, xs, ys], -1)[:, :, None, :]
        out.append((ctr + np.asarray(base)[None, None]).reshape(-1, 4)
                   .astype(np.float32))
    return out


def decode(anc, deltas, stds=(1.0, 1.0, 1.0, 1.0), max_shape=None):
    d = deltas * torch.tensor(stds, dtype=deltas.dtype, device=deltas.device)
    aw, ah = anc[..., 2] - anc[..., 0], anc[..., 3] - anc[..., 1]
    ax, ay = (anc[..., 0] + anc[..., 2]) / 2, (anc[..., 1] + anc[..., 3]) / 2
    clip = abs(math.log(16 / 1000))
    w = aw * torch.exp(d[..., 2].clamp(-clip, clip))
    h = ah * torch.exp(d[..., 3].clamp(-clip, clip))
    cx, cy = ax + d[..., 0] * aw, ay + d[..., 1] * ah
    b = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if max_shape is not None:
        H, W = max_shape
        lim = torch.tensor([W, H, W, H], dtype=b.dtype, device=b.device)
        b = torch.minimum(b.clamp_min(0), lim)
    return b


def iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda x: np.clip(x[:, 2] - x[:, 0], 0, None) * np.clip(  # noqa: E731
        x[:, 3] - x[:, 1], 0, None)
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter, 1e-9)


def greedy_nms(boxes: np.ndarray, scores: np.ndarray, thr: float,
               max_out: int, device="cpu") -> np.ndarray:
    """Indices kept by greedy NMS, best first; entries scored -inf never
    kept. The overlaps are computed on ``device``, in float64."""
    order = np.argsort(-scores, kind="stable")
    order = order[np.isfinite(scores[order])]
    b = torch.as_tensor(boxes[order], dtype=torch.float64, device=device)
    lt = torch.maximum(b[:, None, :2], b[None, :, :2])
    rb = torch.minimum(b[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp_min(0).prod(-1)
    area = (b[:, 2:] - b[:, :2]).clamp_min(0).prod(-1)
    iou = (inter / (area[:, None] + area[None] - inter).clamp_min(1e-9) > thr)
    iou = iou.cpu().numpy()
    alive = np.ones(len(order), bool)
    keep = []
    for i in range(len(order)):
        if not alive[i]:
            continue
        keep.append(order[i])
        if len(keep) == max_out:
            break
        alive[i + 1:] &= ~iou[i, i + 1:]
    return np.asarray(keep, int)


def proposals(rpn_outs, c: dict, img_shape, dtype=torch.float32):
    """One frame's RPN outputs [(cls (H, W, A), reg (H, W, 4A))] per level ->
    (boxes (n, 4), in score order), at most ``rpn_max``; scores and boxes
    computed in ``dtype``."""
    anc = anchors([tuple(cls.shape[:2]) for cls, _ in rpn_outs])
    boxes, scores, lvl = [], [], []
    for l, ((cls, reg), a) in enumerate(zip(rpn_outs, anc)):
        s = torch.sigmoid(cls.reshape(-1).to(dtype))
        d = reg.reshape(-1, 4).to(dtype)
        k = min(c["rpn_nms_pre"], s.numel())
        top_s, top_i = torch.topk(s, k)
        boxes.append(decode(torch.as_tensor(a, device=d.device, dtype=d.dtype)[top_i],
                            d[top_i], max_shape=img_shape))
        scores.append(top_s)
        lvl.append(torch.full((k,), l))
    b = torch.cat(boxes).double().cpu().numpy()
    s = torch.cat(scores).double().cpu().numpy()
    lv = torch.cat(lvl).numpy()
    off = lv[:, None] * (b.max() + 1.0)
    keep = greedy_nms(b + off, s, c["rpn_iou_thr"], c["rpn_max"],
                      cls.device)
    return torch.as_tensor(b[keep], dtype=torch.float32)


def _bilinear(table, base, Hr, Wr, gy, gx, out, s):
    """mmcv's ``bilinear_interpolate``: a sample outside [-1, extent] reads
    0; else its coordinates clamp at 0 and its stencil at extent - 1."""
    n = gy.shape[-1]
    yq = gy[:, :, None].expand(-1, n, n)
    xq = gx[:, None, :].expand(-1, n, n)
    Hf, Wf = Hr.to(yq.dtype)[:, None, None], Wr.to(xq.dtype)[:, None, None]
    inside = (yq >= -1.0) & (yq <= Hf) & (xq >= -1.0) & (xq <= Wf)
    yq, xq = yq.clamp_min(0.0), xq.clamp_min(0.0)
    y0, x0 = torch.floor(yq), torch.floor(xq)
    wy, wx = (yq - y0)[..., None], (xq - x0)[..., None]
    Hm, Wm = (Hr - 1)[:, None, None], (Wr - 1)[:, None, None]
    y0i = torch.minimum(y0.long(), Hm)
    x0i = torch.minimum(x0.long(), Wm)
    y1i, x1i = torch.minimum(y0i + 1, Hm), torch.minimum(x0i + 1, Wm)
    base, Wrow = base[:, None, None], Wr[:, None, None]
    v = (table[base + y0i * Wrow + x0i] * (1 - wy) * (1 - wx)
         + table[base + y0i * Wrow + x1i] * (1 - wy) * wx
         + table[base + y1i * Wrow + x0i] * wy * (1 - wx)
         + table[base + y1i * Wrow + x1i] * wy * wx)
    v = torch.where(inside[..., None], v, 0.0)
    R = gy.shape[0]
    return v.reshape(R, out, s, out, s, -1).mean((2, 4))


def roi_align(maps4, rois, levels, out=7, sampling=2, strides=STRIDES):
    """Aligned RoIAlign of one frame's RoIs (R, 4) on its assigned levels
    (R,), maps4 the four (H, W, C) maps. Returns (R, out, out, C)."""
    C = maps4[0].shape[-1]
    sizes = [m.shape[0] * m.shape[1] for m in maps4]
    offs = torch.as_tensor(np.concatenate([[0], np.cumsum(sizes)[:-1]]),
                           device=rois.device)
    table = torch.cat([m.reshape(-1, C) for m in maps4])
    Hs = torch.as_tensor([m.shape[0] for m in maps4], device=rois.device)[levels]
    Ws = torch.as_tensor([m.shape[1] for m in maps4], device=rois.device)[levels]
    scale = torch.as_tensor([1.0 / s for s in strides[:4]], dtype=rois.dtype,
                            device=rois.device)[levels]
    grid = (torch.arange(out * sampling, dtype=rois.dtype, device=rois.device)
            + 0.5) / sampling
    x1, y1 = rois[:, 0] * scale - 0.5, rois[:, 1] * scale - 0.5
    x2, y2 = rois[:, 2] * scale - 0.5, rois[:, 3] * scale - 0.5
    gy = y1[:, None] + grid * ((y2 - y1) / out)[:, None]
    gx = x1[:, None] + grid * ((x2 - x1) / out)[:, None]
    return _bilinear(table, offs[levels], Hs, Ws, gy, gx, out, sampling)


def head(bbox_head, maps4, props, img_shape, dtype=torch.float32, block=256):
    """The RoI head on one frame's proposals (R, 4) and its four maps:
    (boxes (R, 4), foreground scores (R,)), in proposal order, computed in
    blocks of ``block`` RoIs; scores and boxes decoded in ``dtype``."""
    w = (props[:, 2] - props[:, 0]).clamp_min(0)
    h = (props[:, 3] - props[:, 1]).clamp_min(0)
    lvl = torch.floor(torch.log2(torch.sqrt(w * h) / 56.0 + 1e-6)).clamp(0, 3).long()
    boxes, fg = [], []
    for r0 in range(0, len(props), block):
        feats = roi_align(maps4, props[r0:r0 + block], lvl[r0:r0 + block])
        cls, reg = bbox_head(feats)
        fg.append(torch.softmax(cls.to(dtype), -1)[:, 0])
        boxes.append(decode(props[r0:r0 + block].to(dtype), reg.to(dtype),
                            stds=(0.1, 0.1, 0.2, 0.2), max_shape=img_shape))
    return torch.cat(boxes).float(), torch.cat(fg).float()


def detections(boxes, fg, c: dict, k: int):
    """NMS of the head's outputs: the best ``k`` (boxes, scores) kept, as
    numpy, and the scores of all that NMS keeps."""
    b = boxes.double().cpu().numpy()
    s = fg.double().cpu().numpy()
    s = np.where(s > c["rcnn_score_thr"], s, -np.inf)
    keep = greedy_nms(b, s, c["rcnn_iou_thr"], c["rcnn_max"], boxes.device)
    return b[keep[:k]], s[keep[:k]], s[keep]
