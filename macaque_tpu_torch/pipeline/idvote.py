"""Collar-ID voting over tracklets (windowed majority + midpoint splits).

Vectorized restatement of the reference's 2D-tracklet ID labelling
(step2_crossviewmatching.py:717-850): duplicate collar colours in a frame
are disqualified, per-tracklet class sequences are voted over a sliding
window (p > 0.8 and >= 12 hits), and tracklets carrying several confident
identities are split at the midpoint between the last/first supporting
detections.
"""

from __future__ import annotations

import numpy as np

from macaque_tpu_torch.core.config import VALID_COLLAR_CLASSES

P_THR = 0.8
MIN_HITS = 12


def _window_counts(onehot: np.ndarray, wsize: int) -> np.ndarray:
    """Sliding sums over [f - w/2, f + w/2) per class via cumsum.
    onehot (n_frame, 4) -> (n_frame, 4)."""
    n = onehot.shape[0]
    half = wsize // 2
    cs = np.vstack([np.zeros((1, onehot.shape[1]), onehot.dtype),
                    np.cumsum(onehot, axis=0)])
    lo = np.clip(np.arange(n) - half, 0, n)
    hi = np.clip(np.arange(n) + half, 0, n)
    return cs[hi] - cs[lo]


def vote_tracklet_ids(arr: np.ndarray, n_frame: int, wsize: int) -> np.ndarray:
    """One tracklet's per-frame class observations -> per-frame animal ids.

    arr: (n_frame,) with -2 = absent, -1 = unknown, else a collar class in
    VALID_COLLAR_CLASSES. Returns (n_frame,) animal ids (index into the
    valid-class list) or -1.
    """
    valid_ids = list(VALID_COLLAR_CLASSES)
    onehot = np.zeros((n_frame, len(valid_ids)), int)
    for col, cls in enumerate(valid_ids):
        onehot[arr == cls, col] = 1

    present = np.where(arr >= -1)[0]
    if present.size == 0:
        return np.full(n_frame, -1, int)
    start_f, end_f = int(present.min()), int(present.max())

    labels = np.full(n_frame, -1, int)
    half = wsize // 2
    cnts = _window_counts(onehot, wsize)
    total = cnts.sum(axis=1)
    cmax = cnts.max(axis=1)
    conf = (total > 0) & (cmax >= MIN_HITS) & (cmax / np.maximum(total, 1) > P_THR)
    f_lo, f_hi = max(start_f, half), min(end_f, n_frame - half)
    in_range = np.zeros(n_frame, bool)
    in_range[f_lo:f_hi] = True
    sel = conf & in_range
    labels[sel] = np.argmax(cnts[sel], axis=1)

    uniq = np.unique(labels[start_f : end_f + 1])
    uniq = uniq[uniq >= 0]

    if uniq.size == 0:
        glob = onehot.sum(axis=0)
        if glob.sum() > 0:
            pmax = glob.max() / glob.sum()
            if pmax > P_THR and glob.max() >= MIN_HITS:
                labels[:] = int(np.argmax(glob))
        return labels
    if uniq.size == 1:
        labels[:] = int(uniq[0])
        return labels

    # multiple identities: midpoint split between supporting detections
    out = labels.copy()
    prev_id, prev_frame = -1, 0
    for f in range(n_frame):
        cur = labels[f]
        if cur >= 0 and cur != prev_id:
            if prev_id == -1:
                out[:f] = cur
            else:
                lo1, hi1 = max(1, prev_frame - half), f
                idx_prev = np.where(onehot[:, prev_id] > 0)[0]
                idx_prev = idx_prev[(idx_prev >= lo1) & (idx_prev <= hi1)]
                i_prev = int(idx_prev.max()) if idx_prev.size else prev_frame
                lo2, hi2 = prev_frame, min(f + half, n_frame)
                idx_cur = np.where(onehot[:, cur] > 0)[0]
                idx_cur = idx_cur[(idx_cur >= lo2) & (idx_cur <= hi2)]
                i_cur = int(idx_cur.min()) if idx_cur.size else f
                mid = (i_prev + i_cur) // 2
                out[prev_frame:mid] = prev_id
                out[mid:f] = cur
            prev_id, prev_frame = cur, f
    if prev_id >= 0:
        out[prev_frame:] = prev_id
    return out


def collar_ids_per_camera(
    alldata: list, n_frame: int, cid_thr: float = 0.8, wsize: int = 24 * 5
) -> dict[int, np.ndarray]:
    """One camera's alldata.json -> {track_id: per-frame animal id array}
    (reference get_id_of_2dtrack per-camera body, step2:819-848), after
    in-frame duplicate-colour disqualification."""
    valid = set(VALID_COLLAR_CLASSES)
    # duplicate disqualification mutates a copy of the confidences
    conf = {}
    for f, dets in enumerate(alldata):
        counts = {}
        for det in dets:
            cid, score = det[6], det[7]
            if cid in valid and score > cid_thr:
                counts[cid] = counts.get(cid, 0) + 1
        dup = {c for c, n in counts.items() if n > 1}
        for k, det in enumerate(dets):
            conf[(f, k)] = 0.0 if det[6] in dup else det[7]

    tracklets: dict[int, np.ndarray] = {}
    for f, dets in enumerate(alldata):
        for k, det in enumerate(dets):
            tid = det[0]
            if tid not in tracklets:
                tracklets[tid] = np.full(n_frame, -2, int)
            ok = det[6] in valid and conf[(f, k)] > cid_thr
            tracklets[tid][f] = det[6] if ok else -1

    return {
        tid: vote_tracklet_ids(arr, n_frame, wsize)
        for tid, arr in tracklets.items()
    }
