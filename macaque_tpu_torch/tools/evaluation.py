"""COCO-style component evaluation: bbox mAP and OKS keypoint AP.

Port of ``macaque_tpu/tools/evaluation.py`` (numpy, host): the
reference's detector/pose evaluation harness (notebooks/det_pose_optim.ipynb
runs COCOeval over the group-cage test set: bbox mAP 0.7195, keypoint AP
0.7203 at det_thr 0.85) as library functions — standard COCO 101-point AP
over IoU/OKS thresholds 0.50:0.05:0.95, with the macaque OKS sigmas
(model/pose/macaque.py:180-183).

One departure: with ground truth present and no prediction in any image,
the JAX package's ``_ap_from_matches`` raises ``TypeError`` (``~`` of an
empty float array); here the match flags are bool and that AP is 0.0,
COCO's value. Everywhere the JAX package returns a number, this
module returns the same one.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

MACAQUE_OKS_SIGMAS = np.array([
    0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
    0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
])

COCO_THRESHOLDS = np.arange(0.50, 0.96, 0.05)


def bbox_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(aa[:, None] + ab[None] - inter, 1e-9)


def oks(pred_kp: np.ndarray, gt_kp: np.ndarray, gt_area: np.ndarray,
        sigmas: np.ndarray = MACAQUE_OKS_SIGMAS) -> np.ndarray:
    """Object keypoint similarity (COCO definition).

    pred_kp (N, J, 2); gt_kp (M, J, 3) [x, y, visible]; gt_area (M,).
    Returns (N, M)."""
    d2 = np.sum(
        (pred_kp[:, None, :, :2] - gt_kp[None, :, :, :2]) ** 2, axis=-1
    )  # (N, M, J)
    vis = gt_kp[None, :, :, 2] > 0
    var = (2 * sigmas[None, None]) ** 2
    e = d2 / var / np.maximum(gt_area[None, :, None], 1e-9) / 2.0
    sim = np.where(vis, np.exp(-e), 0.0)
    nvis = np.maximum(vis.sum(axis=-1), 1)
    return sim.sum(axis=-1) / nvis


def _ap_from_matches(scores, matched, n_gt) -> float:
    """101-point interpolated AP given per-detection scores and per-
    threshold match flags."""
    if n_gt == 0:
        return float("nan")
    order = np.argsort(-np.asarray(scores))
    matched = np.asarray(matched, bool)[order]
    if not matched.size:
        return 0.0          # ground truth and no detection: nothing recalled
    tp = np.cumsum(matched)
    fp = np.cumsum(~matched)
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, 1)
    # precision envelope + 101-point sampling
    for i in range(len(precision) - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    rc = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, rc, side="left")
    p = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
    p[idx >= len(precision)] = 0.0
    return float(np.mean(p))


def _greedy_match(sim: np.ndarray, scores: np.ndarray, thr: float):
    """COCO greedy matching: detections by descending score claim the
    best unmatched GT with similarity >= thr. Returns bool matched flags."""
    order = np.argsort(-scores)
    gt_taken = np.zeros(sim.shape[1], bool)
    matched = np.zeros(sim.shape[0], bool)
    for d in order:
        best, best_sim = -1, thr
        for g in range(sim.shape[1]):
            if not gt_taken[g] and sim[d, g] >= best_sim:
                best, best_sim = g, sim[d, g]
        if best >= 0:
            gt_taken[best] = True
            matched[d] = True
    return matched


def evaluate_detections(
    pred_boxes: Sequence[np.ndarray],
    pred_scores: Sequence[np.ndarray],
    gt_boxes: Sequence[np.ndarray],
    thresholds: np.ndarray = COCO_THRESHOLDS,
) -> dict:
    """Per-image lists -> {'mAP', 'AP50', 'AP75'} (single-class bbox)."""
    aps = []
    for thr in thresholds:
        scores_all, matched_all, n_gt = [], [], 0
        for pb, ps, gb in zip(pred_boxes, pred_scores, gt_boxes):
            pb = np.asarray(pb, float).reshape(-1, 4)
            gb = np.asarray(gb, float).reshape(-1, 4)
            n_gt += gb.shape[0]
            if pb.shape[0] == 0:
                continue
            sim = bbox_iou_np(pb, gb) if gb.shape[0] else np.zeros((pb.shape[0], 0))
            matched_all.extend(_greedy_match(sim, np.asarray(ps), thr))
            scores_all.extend(np.asarray(ps))
        aps.append(_ap_from_matches(scores_all, matched_all, n_gt))
    aps = np.asarray(aps)
    return {
        "mAP": float(np.nanmean(aps)),
        "AP50": float(aps[0]),
        "AP75": float(aps[5]),  # thresholds[5] == 0.75
    }


def evaluate_keypoints(
    pred_kps: Sequence[np.ndarray],
    pred_scores: Sequence[np.ndarray],
    gt_kps: Sequence[np.ndarray],
    gt_areas: Sequence[np.ndarray],
    thresholds: np.ndarray = COCO_THRESHOLDS,
    sigmas: np.ndarray = MACAQUE_OKS_SIGMAS,
) -> dict:
    """Per-image lists of (N, J, 2) predictions + (M, J, 3) GT + areas ->
    {'AP', 'AP50', 'AP75'} over OKS."""
    aps = []
    for thr in thresholds:
        scores_all, matched_all, n_gt = [], [], 0
        for pk, ps, gk, ga in zip(pred_kps, pred_scores, gt_kps, gt_areas):
            pk = np.asarray(pk, float)
            gk = np.asarray(gk, float)
            n_gt += gk.shape[0]
            if pk.shape[0] == 0:
                continue
            sim = oks(pk, gk, np.asarray(ga), sigmas) if gk.shape[0] \
                else np.zeros((pk.shape[0], 0))
            matched_all.extend(_greedy_match(sim, np.asarray(ps), thr))
            scores_all.extend(np.asarray(ps))
        aps.append(_ap_from_matches(scores_all, matched_all, n_gt))
    aps = np.asarray(aps)
    return {
        "AP": float(np.nanmean(aps)),
        "AP50": float(aps[0]),
        "AP75": float(aps[5]),
    }
