"""2D-only inference on plain video files.

Port of ``macaque_tpu/tools/run2d.py``. The reference's ``run_2D.ipynb``
notebook runs detect -> pose frame by frame on a test mp4 and writes a
skeleton-overlay video with the synthetic neck joint
(notebooks/run_2D.ipynb cells 2-4); this module is that workflow as a
library/CLI surface, chunked through the batched perception backend.
``check_skeleton`` is the single-image sanity check
(notebooks/check_skeleton.ipynb).

The chunk's detect -> threshold -> pose is ``pose_2d_frames``, on arrays:
it runs where cv2 is missing (the perception's networks on the card).
Reading and writing videos and drawing use cv2, imported by the functions
that do them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from macaque_tpu_torch.tools.visualize import (KP_CON, COLORS, _clean_kp,
                                               draw_skeleton)


def _augment_neck(kp: np.ndarray) -> np.ndarray:
    """(D, J, 3) -> (D, J+1, 3) with neck = mean(shoulders 5, 6)
    (reference add_neckkp, visualize_result.py:64-69)."""
    neck = np.nanmean(kp[:, 5:7, :], axis=1, keepdims=True)
    return np.concatenate([kp, neck], axis=1)


def annotate_frame(frame_bgr: np.ndarray, kps: np.ndarray,
                   score_thr: float = 0.3, mrksize: int = 6) -> np.ndarray:
    """Draw skeletons (incl. synthetic neck) for every detection.
    kps: (D, J, 3) image-coord keypoints with scores."""
    img = frame_bgr.copy()
    kps = _augment_neck(np.asarray(kps, float))
    for d in range(kps.shape[0]):
        kp = kps[d].copy()
        kp[kp[:, 2] < score_thr, :2] = np.nan
        draw_skeleton(img, _clean_kp(kp[:, :2]), mrksize,
                      COLORS[d % len(COLORS)], KP_CON)
    return img


def pose_2d_frames(perception, frames_bgr: np.ndarray,
                   det_thr: float = 0.85):
    """Detect, keep the boxes scoring above ``det_thr``, and pose them, on
    a (B, H, W, 3) BGR uint8 chunk. Returns keypoints (B, D, J, 3) [x, y,
    score] in image coordinates (NaN in the slots not kept) and the
    (B, D) mask of the slots kept. No tracking and no collar ID:
    detections are independent each frame."""
    boxes, scores = perception.detect(frames_bgr)
    valid = np.asarray(scores) > det_thr
    kps = np.asarray(perception.pose(frames_bgr, np.asarray(boxes), valid))
    return kps, valid


def check_skeleton(frame_bgr: np.ndarray, perception,
                   det_thr: float = 0.85, score_thr: float = 0.3):
    """Single-image detect + pose + draw (reference
    check_skeleton.ipynb). Returns (annotated image, kps (D, J, 3))."""
    kps, valid = pose_2d_frames(perception, frame_bgr[None], det_thr)
    kps = kps[0][valid[0]]
    return annotate_frame(frame_bgr, kps, score_thr), kps


def render_2d_video(
    video_path: str,
    out_path: str,
    perception,
    det_thr: float = 0.85,
    score_thr: float = 0.3,
    chunk: int = 16,
    fps: Optional[float] = None,
    max_frames: Optional[int] = None,
) -> dict:
    """Run the 2D-only pipeline over a plain video file and write the
    skeleton overlay. Returns {frames, detections, out}.

    Matches the reference's run_2D notebook: detect -> pose per frame,
    NO tracking and NO collar-ID — detections are independent each
    frame. For a tracked/ID'd 2D pipeline over imgstore recordings use
    ``pipeline.step1.run_step1`` (CLI: ``python -m macaque_tpu_torch
    step1``).
    """
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(video_path)
    src_fps = cap.get(cv2.CAP_PROP_FPS) or 24.0
    writer = None
    n_frames = 0
    n_det = 0
    try:
        done = False
        while not done:
            frames = []
            while len(frames) < chunk:
                ok, frame = cap.read()
                if not ok or (max_frames is not None
                              and n_frames + len(frames) >= max_frames):
                    done = True
                    break
                frames.append(frame)
            if not frames:
                break
            kps, valid = pose_2d_frames(perception, np.stack(frames), det_thr)
            for bi, frame in enumerate(frames):
                img = annotate_frame(frame, kps[bi][valid[bi]], score_thr)
                if writer is None:
                    writer = cv2.VideoWriter(
                        out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                        fps or src_fps,
                        (img.shape[1], img.shape[0]),
                    )
                writer.write(img)
                n_det += int(valid[bi].sum())
            n_frames += len(frames)
    finally:
        cap.release()
        if writer is not None:
            writer.release()
    return {"frames": n_frames, "detections": n_det, "out": out_path}
