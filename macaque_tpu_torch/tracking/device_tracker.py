"""On-device multi-object tracker: BoT-SORT association over a chunk of
frames with the track table kept on the device.

The port of ``macaque_tpu/tracking/device_tracker.py``. A fixed-capacity
track table (means, covariances, states) stays on the device across a
chunk; each of a frame's three associations reads its cost matrix to the
host once and solves it there (``hungarian_torch``), and the JAX package's
``lax.scan`` over the chunk's frames is a loop here.
Semantics are the JAX package's (two-stage ByteTrack association,
unconfirmed births, track buffer), which match the host tracker.

Table layout (capacity K):
  mean (K, 8), cov (K, 8, 8), tid (K,), state (K,) in
  {0 empty, 1 tracked, 2 lost, 3 unconfirmed}, lost_frames (K,),
  next_id and frame scalars.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from macaque_tpu_torch.core.device import resolve_device
from macaque_tpu_torch.nn.ops import bbox_iou
from macaque_tpu_torch.tracking.hungarian import hungarian_torch
from macaque_tpu_torch.tracking.kalman import kalman_predict, kalman_update

EMPTY, TRACKED, LOST, UNCONFIRMED = 0, 1, 2, 3


class TrackTable(NamedTuple):
    mean: torch.Tensor          # (K, 8)
    cov: torch.Tensor           # (K, 8, 8)
    tid: torch.Tensor           # (K,) int32
    state: torch.Tensor         # (K,) int32
    lost_frames: torch.Tensor   # (K,) int32
    next_id: torch.Tensor       # () int32
    frame: torch.Tensor         # () int32


def make_table(capacity: int = 16, device=None,
               dtype: torch.dtype = torch.float32) -> TrackTable:
    """An empty table on ``device`` (the card unless told otherwise)."""
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    return TrackTable(
        mean=torch.zeros((capacity, 8), dtype=dtype, device=dev),
        cov=torch.eye(8, dtype=dtype, device=dev).repeat(capacity, 1, 1),
        tid=torch.full((capacity,), -1, **i32),
        state=torch.zeros(capacity, **i32),
        lost_frames=torch.zeros(capacity, **i32),
        next_id=torch.tensor(1, **i32),
        frame=torch.tensor(0, **i32),
    )


def _xyxy_to_cxcywh(b):
    return torch.stack([
        (b[..., 0] + b[..., 2]) / 2, (b[..., 1] + b[..., 3]) / 2,
        b[..., 2] - b[..., 0], b[..., 3] - b[..., 1],
    ], dim=-1)


def _cxcywh_to_xyxy(m):
    cx, cy, w, h = m[..., 0], m[..., 1], m[..., 2], m[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def _associate(track_boxes, track_ok, det_boxes, det_scores, det_ok,
               thresh, proximity, fuse, stats=None):
    """Hungarian matching on (1 - fused IoU) with gating. Returns
    det4track (K,): the detection matched to each track slot, -1 if
    unmatched."""
    K, D = track_boxes.shape[0], det_boxes.shape[0]
    iou = bbox_iou(track_boxes, det_boxes)
    sim = torch.where(iou >= proximity, iou, torch.zeros_like(iou))
    if fuse:
        sim = sim * det_scores[None, :]
    BIG = 10.0
    cost = torch.where(track_ok[:, None] & det_ok[None, :], 1.0 - sim,
                       torch.full_like(sim, BIG))
    # pad rows <= cols for JV: K x (D + K) with dummy columns
    cost = torch.cat([cost, torch.full((K, K), BIG + 1.0, dtype=cost.dtype,
                                       device=cost.device)], dim=1)
    col4row = hungarian_torch(cost, stats)
    matched = (col4row < D) & track_ok
    gate = cost.gather(1, col4row[:, None])[:, 0] <= thresh
    return torch.where(matched & gate, col4row, torch.full_like(col4row, -1))


def _mark_taken(taken, det4track):
    """``taken`` with the detections that ``det4track`` matched set."""
    D = taken.shape[0]
    hit = det4track[:, None] == torch.arange(D, device=taken.device)[None, :]
    return taken | hit.any(0)


def _step(tb: TrackTable, det_boxes, det_scores, high_thresh, low_thresh,
          new_thresh, match_thresh, track_buffer, proximity, stats):
    """One frame: predict, three association stages, Kalman updates,
    births, expiry. Returns (table', out_boxes (K, 4), out_tids (K,))."""
    K = tb.mean.shape[0]
    high = det_scores >= high_thresh
    low = (det_scores > low_thresh) & ~high
    activated = (tb.state == TRACKED) | (tb.state == LOST)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32,  # noqa: E731
                                 device=tb.state.device)

    # predict activated tracks (lost tracks freeze w/h velocity)
    frozen = torch.cat([tb.mean[:, :6], torch.where(
        (tb.state != TRACKED)[:, None], torch.zeros_like(tb.mean[:, 6:8]),
        tb.mean[:, 6:8])], dim=1)
    pm, pc = kalman_predict(frozen, tb.cov)
    mean = torch.where(activated[:, None], pm, tb.mean)
    cov = torch.where(activated[:, None, None], pc, tb.cov)
    tboxes = _cxcywh_to_xyxy(mean[:, :4])

    # stage 1: high dets vs activated tracks
    d1 = _associate(tboxes, activated, det_boxes, det_scores, high,
                    match_thresh, proximity, True, stats)
    # stage 2: low dets vs remaining tracked-state tracks
    rem = activated & (d1 < 0) & (tb.state == TRACKED)
    d2 = _associate(tboxes, rem, det_boxes, det_scores, low, 0.5, proximity,
                    False, stats)
    # stage 3: leftover high dets vs unconfirmed tracks
    det_taken = _mark_taken(_mark_taken(torch.zeros_like(high), d1), d2)
    unconf = tb.state == UNCONFIRMED
    d3 = _associate(tboxes, unconf, det_boxes, det_scores, high & ~det_taken,
                    0.7, proximity, True, stats)
    det4track = torch.where(d1 >= 0, d1, torch.where(d2 >= 0, d2, d3))
    det_taken = _mark_taken(det_taken, d3)

    # Kalman update for matched slots
    meas = _xyxy_to_cxcywh(det_boxes[det4track.clamp_min(0)])
    um, uc = kalman_update(mean, cov, meas)
    got = det4track >= 0
    mean = torch.where(got[:, None], um, mean)
    cov = torch.where(got[:, None, None], uc, cov)

    lost_frames = torch.where(got, i32(0), tb.lost_frames)
    state = torch.where(got, i32(TRACKED), tb.state)
    # unmatched: activated -> lost (+1), unconfirmed -> removed
    newly_lost = activated & ~got
    state = torch.where(newly_lost, i32(LOST), state)
    lost_frames = torch.where(newly_lost, tb.lost_frames + 1, lost_frames)
    state = torch.where(unconf & ~got, i32(EMPTY), state)
    # expire
    state = torch.where(lost_frames > track_buffer, i32(EMPTY), state)

    # births: unmatched high dets above new_thresh claim empty slots; the
    # k-th birth takes the k-th empty slot
    birth_det = high & ~det_taken & (det_scores >= new_thresh)
    empty_slots = state == EMPTY
    det_rank = torch.cumsum(birth_det, 0) - 1            # (D,)
    slot_rank = torch.cumsum(empty_slots, 0) - 1         # (K,)
    n_births = birth_det.sum()
    want = (det_rank[None, :] == slot_rank[:, None]) & birth_det[None, :]
    ok = empty_slots & (slot_rank < n_births) & want.any(1)
    bidx = torch.where(ok, want.to(torch.uint8).argmax(1),
                       torch.full_like(slot_rank, -1))
    born = bidx >= 0
    bm = _xyxy_to_cxcywh(det_boxes[bidx.clamp_min(0)])
    init_mean = torch.cat([bm, torch.zeros_like(bm)], dim=1)
    w, h = bm[:, 2], bm[:, 3]
    stds = torch.stack([
        2 / 20 * w, 2 / 20 * h, 2 / 20 * w, 2 / 20 * h,
        10 / 160 * w, 10 / 160 * h, 10 / 160 * w, 10 / 160 * h,
    ], dim=-1)
    mean = torch.where(born[:, None], init_mean, mean)
    cov = torch.where(born[:, None, None], torch.diag_embed(stds ** 2), cov)
    first_frame = tb.frame == 0
    state = torch.where(born, torch.where(first_frame, i32(TRACKED),
                                          i32(UNCONFIRMED)), state)
    tid = torch.where(born, (tb.next_id + slot_rank).to(torch.int32), tb.tid)
    lost_frames = torch.where(born, i32(0), lost_frames)
    next_id = (tb.next_id + n_births).to(torch.int32)

    # outputs: activated tracked slots matched this frame (or first-frame
    # births, which are immediately activated)
    emit = (state == TRACKED) & (got | (born & first_frame))
    out_boxes = torch.where(emit[:, None], _cxcywh_to_xyxy(mean[:, :4]),
                            torch.full_like(mean[:, :4], float("nan")))
    out_tids = torch.where(emit, tid, i32(-1))
    return (TrackTable(mean, cov, tid, state, lost_frames, next_id,
                       tb.frame + 1), out_boxes, out_tids)


@torch.no_grad()
def track_chunk_device(
    table: TrackTable,
    boxes,                 # (T, D, 4) xyxy
    scores,                # (T, D)
    high_thresh: float = 0.85,
    low_thresh: float = 0.10,
    new_thresh: float = 0.85,
    match_thresh: float = 0.80,
    track_buffer: int = 72,
    proximity: float = 0.5,
    stats: dict | None = None,
):
    """Track a chunk of frames on the table's device.

    Returns (table', out_boxes (T, K, 4), out_tids (T, K) with -1 for
    inactive slots), on that device; boxes and scores go there in the
    table's dtype. ``stats``, if given, counts the assignment's
    ``host_reads``."""
    dev, dt = table.mean.device, table.mean.dtype
    boxes = torch.as_tensor(boxes, device=dev).to(dt)
    scores = torch.as_tensor(scores, device=dev).to(dt)
    out_b, out_t = [], []
    for t in range(boxes.shape[0]):
        table, ob, ot = _step(table, boxes[t], scores[t], high_thresh,
                              low_thresh, new_thresh, match_thresh,
                              track_buffer, proximity, stats)
        out_b.append(ob)
        out_t.append(ot)
    K = table.mean.shape[0]
    if not out_b:
        return (table, boxes.new_zeros((0, K, 4)),
                torch.zeros((0, K), dtype=torch.int32, device=dev))
    return table, torch.stack(out_b), torch.stack(out_t)
