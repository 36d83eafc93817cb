"""BoT-SORT-style tracker over chunked detections (host control plane).

Semantics follow the published BoT-SORT/ByteTrack association that the
reference configures through boxmot (step1_proc2d.py:77-89):

  * two-stage association: high-score detections (>= track_high_thresh)
    match active+lost tracks by IoU (score-fused) with Hungarian at
    match_thresh; low-score detections (> track_low_thresh) then match the
    remaining tracked-state tracks at 0.5;
  * unconfirmed (single-frame) tracks get a third association against the
    leftover high-score detections at 0.7, else are removed;
  * unmatched tracks persist as "lost" for ``track_buffer`` frames;
  * unmatched high-score detections above ``new_track_thresh`` start new
    tracks (activated immediately only on the first frame);
  * constant-velocity Kalman filter in (cx, cy, w, h).

ReID and SIFT camera-motion compensation are intentionally omitted
(with_reid=False in the reference; cameras are static — SURVEY.md §7.3).

TPU design: detection for a whole frame-chunk runs batched on device; this
association loop then runs on the chunk's tiny box lists on host
(microseconds/frame); pose/ID crops batch back onto the device. One
transfer per chunk each way instead of a per-frame sync
(cf. reference step1:211-241, which syncs GPU<->CPU every frame).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from macaque_tpu_torch.tracking.kalman import KalmanXYWH
from macaque_tpu_torch.tracking.hungarian import hungarian


@dataclass
class TrackerParams:
    track_high_thresh: float = 0.85
    track_low_thresh: float = 0.10
    new_track_thresh: float = 0.85
    track_buffer: int = 72
    match_thresh: float = 0.80
    proximity_thresh: float = 0.5
    fuse_score: bool = True


def _xyxy_to_cxcywh(b):
    return np.array([
        (b[0] + b[2]) / 2, (b[1] + b[3]) / 2, b[2] - b[0], b[3] - b[1]
    ])


def _cxcywh_to_xyxy(m):
    cx, cy, w, h = m[:4]
    return np.array([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-9)


class _Track:
    __slots__ = ("mean", "cov", "tid", "state", "lost_frames", "score",
                 "activated")

    def __init__(self, box_xyxy, score, tid, activated):
        self.mean, self.cov = KalmanXYWH.initiate(_xyxy_to_cxcywh(box_xyxy))
        self.tid = tid
        self.state = "tracked"
        self.lost_frames = 0
        self.score = score
        self.activated = activated

    def predict(self):
        # non-tracked tracks keep zero w/h velocity (ByteTrack convention)
        if self.state != "tracked":
            self.mean[6] = 0.0
            self.mean[7] = 0.0
        self.mean, self.cov = KalmanXYWH.predict(self.mean, self.cov)

    def update(self, box_xyxy, score):
        self.mean, self.cov = KalmanXYWH.update(
            self.mean, self.cov, _xyxy_to_cxcywh(box_xyxy)
        )
        self.state = "tracked"
        self.activated = True
        self.lost_frames = 0
        self.score = score

    @property
    def xyxy(self):
        return _cxcywh_to_xyxy(self.mean)


class BotSortTracker:
    """Frame-sequential tracker; ``update`` returns (boxes (K, 4),
    track_ids (K,)) for activated tracks matched this frame."""

    def __init__(self, params: Optional[TrackerParams] = None):
        self.p = params or TrackerParams()
        self.tracks: List[_Track] = []
        self.next_id = 1
        self.frame = 0

    def _associate(self, tracks, boxes, scores, thresh, fuse):
        """Hungarian matching on (1 - fused IoU) with gating. Returns
        (matches [(t, d)], unmatched_track_idx, unmatched_det_idx)."""
        if len(tracks) == 0 or len(boxes) == 0:
            return [], list(range(len(tracks))), list(range(len(boxes)))
        t_boxes = np.stack([t.xyxy for t in tracks])
        iou = _iou_matrix(t_boxes, boxes)
        sim = np.where(iou >= self.p.proximity_thresh, iou, 0.0)
        if fuse:
            sim = sim * scores[None, :]
        cost = 1.0 - sim
        rows, cols = hungarian(cost)
        matches = [(r, c) for r, c in zip(rows, cols) if cost[r, c] <= thresh]
        mt = {r for r, _ in matches}
        md = {c for _, c in matches}
        um_t = [i for i in range(len(tracks)) if i not in mt]
        um_d = [i for i in range(len(boxes)) if i not in md]
        return matches, um_t, um_d

    def update(self, boxes_xyxy: np.ndarray, scores: np.ndarray):
        p = self.p
        self.frame += 1
        boxes_xyxy = np.asarray(boxes_xyxy, float).reshape(-1, 4)
        scores = np.asarray(scores, float).reshape(-1)

        high = scores >= p.track_high_thresh
        low = (scores > p.track_low_thresh) & ~high
        hb, hs = boxes_xyxy[high], scores[high]
        lb, ls = boxes_xyxy[low], scores[low]

        pool = [t for t in self.tracks if t.activated]
        unconfirmed = [t for t in self.tracks if not t.activated]
        for t in pool:
            t.predict()

        # 1) high-score association vs activated (tracked + lost) tracks
        matches, um_t, um_d = self._associate(
            pool, hb, hs, p.match_thresh, p.fuse_score
        )
        for r, c in matches:
            pool[r].update(hb[c], hs[c])

        # 2) low-score association vs remaining *tracked-state* tracks
        second_pool = [pool[i] for i in um_t if pool[i].state == "tracked"]
        m2, _, _ = self._associate(second_pool, lb, ls, 0.5, False)
        for r, c in m2:
            second_pool[r].update(lb[c], ls[c])

        # 3) unconfirmed tracks vs leftover high detections
        rest_hb = hb[um_d] if len(um_d) else np.zeros((0, 4))
        rest_hs = hs[um_d] if len(um_d) else np.zeros((0,))
        m3, um_u, um_d3 = self._associate(
            unconfirmed, rest_hb, rest_hs, 0.7, p.fuse_score
        )
        for r, c in m3:
            unconfirmed[r].update(rest_hb[c], rest_hs[c])
        removed = {id(unconfirmed[i]) for i in um_u}

        # mark unmatched activated tracks lost
        matched_now = (
            {id(pool[r]) for r, _ in matches}
            | {id(second_pool[r]) for r, _ in m2}
            | {id(unconfirmed[r]) for r, _ in m3}
        )
        for t in pool:
            if id(t) not in matched_now:
                t.state = "lost"
                t.lost_frames += 1

        # expire + drop removed unconfirmed
        self.tracks = [
            t for t in self.tracks
            if t.lost_frames <= p.track_buffer and id(t) not in removed
        ]

        # 4) births from still-unmatched high detections
        for c in um_d3:
            if rest_hs[c] >= p.new_track_thresh:
                self.tracks.append(
                    _Track(rest_hb[c], rest_hs[c], self.next_id,
                           activated=(self.frame == 1))
                )
                self.next_id += 1

        out_boxes, out_ids = [], []
        for t in self.tracks:
            if (t.state == "tracked" and t.activated
                    and t.lost_frames == 0):
                out_boxes.append(t.xyxy)
                out_ids.append(t.tid)
        if not out_boxes:
            return np.zeros((0, 4)), np.zeros((0,), int)
        return np.stack(out_boxes), np.asarray(out_ids, int)

    def track_chunk(self, boxes_list, scores_list):
        """Run over a chunk of frames (lists of per-frame boxes/scores)."""
        return [self.update(b, s) for b, s in zip(boxes_list, scores_list)]
