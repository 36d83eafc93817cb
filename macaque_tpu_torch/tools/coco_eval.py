"""COCO-dataset detector/pose evaluation — the reference's
``det_pose_optim`` notebook flow (run_detection_inference /
run_pose_inference + COCOeval, cells 2-7) as one command:

    python -m macaque_tpu_torch eval-coco --ann test.json --images imgs/ \
        --weights ./model

Port of ``macaque_tpu/tools/coco_eval.py``. Loads a COCO-format
annotation file, runs the detector over every image, runs top-down pose
on detections above the threshold, and reports single-class bbox
mAP/AP50/AP75 + OKS keypoint AP (``tools/evaluation.py``, macaque sigmas).

The per-image work is split from the image files: ``coco_eval_arrays``
takes BGR uint8 arrays and ``load_coco``'s records, so it runs where cv2
is missing (the perception's networks on the card); ``run_coco_eval``
reads the images with cv2 and calls it.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Iterable, Optional, Sequence

import numpy as np


def load_coco(ann_file: str):
    """COCO json -> list of dicts {file_name, boxes (M,4) xyxy,
    keypoints (M,J,3), areas (M,)}."""
    with open(ann_file) as f:
        coco = json.load(f)
    imgs = {im["id"]: im for im in coco["images"]}
    per_img = defaultdict(list)
    for ann in coco["annotations"]:
        per_img[ann["image_id"]].append(ann)

    out = []
    for img_id, im in imgs.items():
        anns = per_img.get(img_id, [])
        boxes, kps, areas = [], [], []
        for a in anns:
            x, y, w, h = a["bbox"]
            boxes.append([x, y, x + w, y + h])
            areas.append(a.get("area", w * h))
            if "keypoints" in a:
                kps.append(np.asarray(a["keypoints"],
                                      float).reshape(-1, 3))
        out.append({
            "file_name": im["file_name"],
            "boxes": np.asarray(boxes, float).reshape(-1, 4),
            "keypoints": (np.stack(kps) if kps
                          else np.zeros((0, 17, 3))),
            "areas": np.asarray(areas, float),
        })
    return out


def coco_eval_arrays(perception, images: Iterable[np.ndarray],
                     records: Sequence[dict], det_thr: float = 0.85,
                     progress: bool = True) -> dict:
    """Evaluate a perception backend on images given as (H, W, 3) BGR uint8
    arrays, one per ``load_coco`` record (any iterable; an image that is
    None, unreadable, is skipped with its record). Returns {'det': {mAP,
    AP50, AP75}, 'pose': {AP, AP50, AP75}, 'n_images', 'det_thr'}."""
    from macaque_tpu_torch.tools.evaluation import (
        evaluate_detections, evaluate_keypoints,
    )

    pred_boxes, pred_scores = [], []
    pred_kps, pred_kp_scores = [], []
    gt_boxes, gt_kps, gt_areas = [], [], []
    n = 0
    for img, rec in zip(images, records):
        if img is None:
            continue
        n += 1
        boxes, scores = perception.detect(img[None])
        boxes, scores = boxes[0], scores[0]
        keep = scores > det_thr
        D = boxes.shape[0]
        tbl = np.zeros((1, D, 4), np.float32)
        valid = np.zeros((1, D), bool)
        nk = int(keep.sum())
        tbl[0, :nk] = boxes[keep]
        valid[0, :nk] = True
        kps = perception.pose(img[None], tbl, valid)[0]  # (D, J, 3)

        pred_boxes.append(boxes[keep])
        pred_scores.append(scores[keep])
        pred_kps.append(kps[:nk, :, :2])
        pred_kp_scores.append(
            np.nan_to_num(kps[:nk, :, 2]).mean(axis=1)
            if nk else np.zeros((0,)))
        gt_boxes.append(rec["boxes"])
        gt_kps.append(rec["keypoints"])
        gt_areas.append(rec["areas"])
        if progress and n % 50 == 0:
            print(f"[eval-coco] {n} images", flush=True)

    det = evaluate_detections(pred_boxes, pred_scores, gt_boxes)
    pose = evaluate_keypoints(pred_kps, pred_kp_scores, gt_kps, gt_areas)
    return {"det": det, "pose": pose, "n_images": n,
            "det_thr": det_thr}


def run_coco_eval(
    perception,
    images_dir: str,
    ann_file: str,
    det_thr: float = 0.85,
    max_images: Optional[int] = None,
    progress: bool = True,
) -> dict:
    """Evaluate a perception backend over a COCO dataset. Returns
    {'det': {mAP, AP50, AP75}, 'pose': {AP, AP50, AP75}, 'n_images'}."""
    import cv2

    data = load_coco(ann_file)
    if max_images is not None:
        data = data[:max_images]

    images = (cv2.imread(os.path.join(images_dir, rec["file_name"]))
              for rec in data)           # one at a time, as they are used
    return coco_eval_arrays(perception, images, data, det_thr, progress)
