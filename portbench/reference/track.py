"""The camera loop's host logic, NumPy: tracking, box tables, rows.

A frozen copy of the published semantics the stage-1 loop follows:

* BoT-SORT / ByteTrack association as boxmot configures it for the
  reference (without ReID and camera-motion compensation): high-score
  detections match activated tracks by score-fused IoU, low-score ones the
  remaining tracked ones at 0.5, unconfirmed tracks the leftover
  high-score ones at 0.7; lost tracks live ``track_buffer`` frames; a
  constant-velocity Kalman filter over (cx, cy, w, h);
* the table of each frame: up to ``max_det`` tracked integer boxes, the
  pose box widened by a margin that shrinks with the box height and
  snapped to the 192:256 aspect;
* rows: joints under ``kp_thr`` blanked, an EMA per track gated by a
  20-pixel displacement, the collar id kept at a score of ``id_conf_thr``.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

POS, VEL = 1.0 / 20, 1.0 / 160

LOOP = dict(score_thr=0.85, kp_thr=0.30, ema_alpha=0.50, disp_thr=20.0,
            min_margin=0.20, max_margin=0.50, desired_ar=192.0 / 256.0,
            id_conf_thr=0.80, high=0.85, low=0.10, new=0.85, buffer=72,
            match=0.80, proximity=0.5)


def _kf_init(m):
    mean = np.zeros(8)
    mean[:4] = m
    w, h = m[2], m[3]
    std = np.array([2 * POS * w, 2 * POS * h, 2 * POS * w, 2 * POS * h,
                    10 * VEL * w, 10 * VEL * h, 10 * VEL * w, 10 * VEL * h])
    return mean, np.diag(std ** 2)


def _kf_predict(mean, cov):
    w, h = mean[2], mean[3]
    q = np.array([POS * w, POS * h, POS * w, POS * h,
                  VEL * w, VEL * h, VEL * w, VEL * h])
    Fm = np.eye(8)
    Fm[:4, 4:] = np.eye(4)
    return Fm @ mean, Fm @ cov @ Fm.T + np.diag(q ** 2)


def _kf_update(mean, cov, m):
    w, h = mean[2], mean[3]
    r = np.array([POS * w, POS * h, POS * w, POS * h])
    Hm = np.zeros((4, 8))
    Hm[:, :4] = np.eye(4)
    S = Hm @ cov @ Hm.T + np.diag(r ** 2)
    K = cov @ Hm.T @ np.linalg.inv(S)
    return mean + K @ (m - mean[:4]), (np.eye(8) - K @ Hm) @ cov


def _cxcywh(b):
    return np.array([(b[0] + b[2]) / 2, (b[1] + b[3]) / 2, b[2] - b[0],
                     b[3] - b[1]])


def _iou(a, b):
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-9)


class Track:
    def __init__(self, box, score, tid, activated):
        self.mean, self.cov = _kf_init(_cxcywh(box))
        self.tid, self.state, self.lost, self.score = tid, "tracked", 0, score
        self.activated = activated

    def predict(self):
        if self.state != "tracked":
            self.mean[6] = self.mean[7] = 0.0
        self.mean, self.cov = _kf_predict(self.mean, self.cov)

    def update(self, box, score):
        self.mean, self.cov = _kf_update(self.mean, self.cov, _cxcywh(box))
        self.state, self.activated, self.lost, self.score = \
            "tracked", True, 0, score

    @property
    def xyxy(self):
        cx, cy, w, h = self.mean[:4]
        return np.array([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])


class Tracker:
    def __init__(self, p=LOOP):
        self.p, self.tracks, self.next_id, self.frame = p, [], 1, 0

    def _associate(self, tracks, boxes, scores, thresh, fuse):
        if not tracks or not len(boxes):
            return [], list(range(len(tracks))), list(range(len(boxes)))
        iou = _iou(np.stack([t.xyxy for t in tracks]), boxes)
        sim = np.where(iou >= self.p["proximity"], iou, 0.0)
        if fuse:
            sim = sim * scores[None, :]
        cost = 1.0 - sim
        rows, cols = linear_sum_assignment(cost)
        m = [(r, c) for r, c in zip(rows, cols) if cost[r, c] <= thresh]
        mt, md = {r for r, _ in m}, {c for _, c in m}
        return (m, [i for i in range(len(tracks)) if i not in mt],
                [i for i in range(len(boxes)) if i not in md])

    def update(self, boxes, scores):
        p = self.p
        self.frame += 1
        boxes = np.asarray(boxes, float).reshape(-1, 4)
        scores = np.asarray(scores, float).reshape(-1)
        high = scores >= p["high"]
        low = (scores > p["low"]) & ~high
        hb, hs, lb, ls = boxes[high], scores[high], boxes[low], scores[low]
        pool = [t for t in self.tracks if t.activated]
        unconfirmed = [t for t in self.tracks if not t.activated]
        for t in pool:
            t.predict()
        m1, um_t, um_d = self._associate(pool, hb, hs, p["match"], True)
        for r, c in m1:
            pool[r].update(hb[c], hs[c])
        second = [pool[i] for i in um_t if pool[i].state == "tracked"]
        m2, _, _ = self._associate(second, lb, ls, 0.5, False)
        for r, c in m2:
            second[r].update(lb[c], ls[c])
        rest_b = hb[um_d] if um_d else np.zeros((0, 4))
        rest_s = hs[um_d] if um_d else np.zeros((0,))
        m3, um_u, um_d3 = self._associate(unconfirmed, rest_b, rest_s, 0.7, True)
        for r, c in m3:
            unconfirmed[r].update(rest_b[c], rest_s[c])
        removed = {id(unconfirmed[i]) for i in um_u}
        now = ({id(pool[r]) for r, _ in m1} | {id(second[r]) for r, _ in m2}
               | {id(unconfirmed[r]) for r, _ in m3})
        for t in pool:
            if id(t) not in now:
                t.state = "lost"
                t.lost += 1
        self.tracks = [t for t in self.tracks
                       if t.lost <= p["buffer"] and id(t) not in removed]
        for c in um_d3:
            if rest_s[c] >= p["new"]:
                self.tracks.append(Track(rest_b[c], rest_s[c], self.next_id,
                                         self.frame == 1))
                self.next_id += 1
        out = [(t.xyxy, t.tid) for t in self.tracks
               if t.state == "tracked" and t.activated and t.lost == 0]
        return out


def pose_box(box, p=LOOP):
    """Integer xyxy -> the widened, aspect-snapped float32 pose box."""
    x1, y1, x2, y2 = box
    w, h = float(x2 - x1), float(y2 - y1)
    cx, cy = x1 + 0.5 * w, y1 + 0.5 * h
    frac = np.clip((h - 50.0) / 150.0, 0.0, 1.0)
    margin = p["max_margin"] - (p["max_margin"] - p["min_margin"]) * frac
    wn, hn = w * (1 + margin), h * (1 + margin)
    ar = wn / hn
    if abs(ar - p["desired_ar"]) > 0.20:
        if ar < p["desired_ar"]:
            wn = hn * p["desired_ar"]
        else:
            hn = wn / p["desired_ar"]
    return [cx - wn / 2, cy - hn / 2, cx + wn / 2, cy + hn / 2]


def tables(tracker, boxes, scores, D, p=LOOP):
    """One chunk's detections (B, D, 4), (B, D) through the tracker ->
    (pose boxes (B, D, 4) float32, id boxes (B, D, 4) float32, valid (B, D),
    track ids (B, D))."""
    B = len(boxes)
    pose = np.zeros((B, D, 4), np.float32)
    idb = np.zeros((B, D, 4), np.float32)
    valid = np.zeros((B, D), bool)
    tids = np.full((B, D), -1, int)
    for f in range(B):
        keep = scores[f] > p["score_thr"]
        if not keep.any():
            continue
        ok = []
        for b, tid in tracker.update(boxes[f][keep], scores[f][keep]):
            xi = tuple(int(v) for v in b)
            if xi[2] > xi[0] and xi[3] > xi[1]:
                ok.append((xi, tid))
        ok = ok[:D]
        if ok:
            n = len(ok)
            idb[f, :n] = np.asarray([b for b, _ in ok], np.float32)
            pose[f, :n] = np.asarray([pose_box(b, p) for b, _ in ok], np.float32)
            valid[f, :n] = True
            tids[f, :n] = [t for _, t in ok]
    return pose, idb, valid, tids


class Ema:
    def __init__(self, p=LOOP):
        self.p, self.prev = p, {}

    def smooth(self, tid, kp):
        kp = kp.copy()
        prev = self.prev.get(tid)
        if prev is not None:
            vb = ~(np.isnan(prev[:, 0]) | np.isnan(kp[:, 0]))
            disp = np.zeros(kp.shape[0])
            disp[vb] = np.linalg.norm(kp[vb, :2] - prev[vb, :2], axis=1)
            m = (disp < self.p["disp_thr"]) & vb
            a = self.p["ema_alpha"]
            kp[m, :2] = a * prev[m, :2] + (1 - a) * kp[m, :2]
        self.prev[tid] = kp
        return kp


def rows(ema, idb, valid, tids, kps, labels, lscores, p=LOOP):
    """One chunk's rows of ``alldata.json``: per frame, per valid slot,
    [track id, x1, y1, x2, y2, 17 x [x, y, score], collar id, id score]."""
    out = []
    for f in range(len(valid)):
        frame = []
        for k in range(valid.shape[1]):
            if not valid[f, k]:
                continue
            kp = np.asarray(kps[f, k], np.float32).copy()
            low = kp[:, 2] < p["kp_thr"]
            kp[low, :2] = np.nan
            kp[low, 2] = 0.0
            kp = ema.smooth(int(tids[f, k]), kp)
            lsc = float(lscores[f, k])
            x1, y1, x2, y2 = idb[f, k]
            frame.append([int(tids[f, k]), float(x1), float(y1), float(x2),
                          float(y2), [[float(a), float(b), float(c)]
                                      for a, b, c in kp],
                          int(labels[f, k]) if lsc >= p["id_conf_thr"] else -1,
                          lsc])
        out.append(frame)
    return out
