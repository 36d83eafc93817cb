"""Particle-Viterbi 2D keypoint filter, batched over independent streams.

Port of ``macaque_tpu/filters/viterbi.py``, which reimplements anipose's
``viterbi_path`` / ``filter_pose_viterbi`` (reference:
src/third_party/anipose/filter_pose.py:48-120, 151-186). Every stream (one
joint of one camera of one animal) is a row of one batch: the forward pass
is a loop over frames and the backtrack a loop back over them, each step
one set of batched tensor operations for all streams at once, on whichever
device the tensors lie.

Particle model (matching the reference):
  * frame i's candidates are the detections of frames i, i-1, .., i-n_back+1
    with scores discounted by 2^-j for a j-frame look-back;
  * transition log-prob between particles at distance d is
    ``log( Phi((d+2)/s) - Phi((d-2)/s) )`` clipped at -100, with a fixed
    ``log(0.001)`` for transitions to/from the missing particle;
  * emission log-prob is the discounted detection score.
"""

from __future__ import annotations

import math

import torch

_MISSING_LOGP = math.log(0.001)


def _dedup_frame(points: torch.Tensor, thres: float) -> torch.Tensor:
    """Within-frame duplicate removal (reference ``remove_dups``,
    filter_pose.py:26-46): of any pair closer than ``thres``, NaN-out the
    higher-indexed detection. points (..., P, 2)."""
    P = points.shape[-2]
    if P <= 1:
        return points
    d = torch.linalg.vector_norm(
        points[..., :, None, :] - points[..., None, :, :], dim=-1)
    idx = torch.arange(P, device=points.device)
    pair = (d < thres) & (idx[:, None] < idx[None, :])
    pair = torch.where(torch.isnan(d), False, pair)
    dup = pair.any(-2)  # j is a duplicate of some earlier i
    return torch.where(dup[..., None], torch.nan, points)


def _trans_logprob(pa, miss_a, pb, miss_b, sigma):
    """(..., S, 2) x (..., S, 2) -> (..., S_b, S_a) transition log-probs."""
    d = torch.linalg.vector_norm(pa[..., None, :, :] - pb[..., :, None, :],
                                 dim=-1)
    hi = torch.special.log_ndtr((d + 2.0) / sigma)
    lo = torch.special.log_ndtr((d - 2.0) / sigma)
    # log(exp(hi) - exp(lo)) = hi + log(-expm1(lo - hi)); expm1 keeps
    # precision when hi ~ lo (far particles)
    diff = -torch.expm1(lo - hi)
    lp = hi + torch.log(torch.clamp(diff, min=1e-45))
    lp = torch.clamp(lp, min=-100.0)
    return torch.where(miss_b[..., :, None] | miss_a[..., None, :],
                       _MISSING_LOGP, lp)


def viterbi_filter(
    points: torch.Tensor,
    scores: torch.Tensor,
    n_back: int = 3,
    thres_dist: float = 30.0,
    score_threshold: float = 0.3,
):
    """Filter streams of one joint's detections over time.

    points: (..., T, P, 2) candidate positions (NaN = missing);
    scores: (..., T, P) detection scores; leading axes are independent
    streams. Returns (points (..., T, 2), scores (..., T)).
    """
    lead = points.shape[:-3]
    T, P = points.shape[-3], points.shape[-2]
    pts = points.reshape(-1, T, P, 2)
    scs = scores.reshape(-1, T, P)
    B, dev = pts.shape[0], pts.device

    pts = torch.where((scs < score_threshold)[..., None], torch.nan, pts)
    pts = _dedup_frame(pts, thres=5.0)
    valid = ~torch.isnan(pts[..., 0])  # (B, T, P)

    t_idx = torch.arange(T, device=dev)
    pos_list, logp_list, active_list = [], [], []
    for j in range(n_back):
        sh_pts = torch.roll(pts, j, dims=1)
        sh_valid = torch.roll(valid, j, dims=1)
        sh_scores = torch.roll(scs, j, dims=1)
        act = sh_valid & (t_idx - j >= 0)[None, :, None]
        pos_list.append(torch.where(act[..., None], sh_pts, 0.0))
        logp_list.append(torch.where(
            act, torch.log(torch.clamp(sh_scores, min=1e-30))
            + math.log(2.0) * (-j), -torch.inf))
        active_list.append(act)

    pos = torch.cat(pos_list, dim=2)          # (B, T, P*n_back, 2)
    logp = torch.cat(logp_list, dim=2)        # (B, T, P*n_back)
    active = torch.cat(active_list, dim=2)

    none_active = ~active.any(2)               # (B, T)
    miss_pos = torch.full((B, T, 1, 2), -1.0, dtype=pos.dtype, device=dev)
    miss_logp = torch.where(none_active, _MISSING_LOGP, -torch.inf)
    pos = torch.cat([pos, miss_pos], dim=2)                    # (B, T, S, 2)
    logp = torch.cat([logp, miss_logp[..., None].to(logp.dtype)], dim=2)
    is_missing = torch.cat(
        [torch.zeros((B, T, P * n_back), dtype=torch.bool, device=dev),
         none_active[..., None]], dim=2)

    # every frame pair's transitions at once; the recursion then runs one
    # max/argmax a frame for all streams
    P_trans = _trans_logprob(pos[:, :-1], is_missing[:, :-1], pos[:, 1:],
                             is_missing[:, 1:], thres_dist)  # (B, T-1, S, S)
    lp = logp[:, 0]
    backs = []
    for i in range(T - 1):
        possible = lp[:, None, :] + P_trans[:, i]              # (B, S_b, S_a)
        best, back = possible.max(-1)
        lp = best + logp[:, i + 1]
        backs.append(back)

    path = torch.empty((B, T), dtype=torch.long, device=dev)
    nxt = lp.argmax(-1)
    path[:, T - 1] = nxt
    for i in range(T - 2, -1, -1):
        nxt = backs[i].gather(1, nxt[:, None])[:, 0]
        path[:, i] = nxt

    out_pos = pos.gather(2, path[:, :, None, None].expand(B, T, 1, 2))[:, :, 0]
    raw_score = torch.exp(logp)  # undo log; discounted scores
    out_score = raw_score.gather(2, path[..., None])[..., 0]
    missing = is_missing.gather(2, path[..., None])[..., 0]
    out_score = torch.where(missing, 0.001, out_score)
    return out_pos.reshape(*lead, T, 2), out_score.reshape(*lead, T)


def viterbi_filter_joints(
    points: torch.Tensor,
    scores: torch.Tensor,
    n_back: int = 3,
    thres_dist: float = 30.0,
    score_threshold: float = 0.3,
):
    """:func:`viterbi_filter` over the joint axis (and any leading axes).

    points: (..., T, J, P, 2); scores: (..., T, J, P).
    Returns (points (..., T, J, 2), scores (..., T, J)): every joint of every
    leading index is one stream of the same batch (the JAX package's vmap;
    the reference's process pool, filter_pose.py:151-186).
    """
    pts = points.movedim(-3, -4)  # (..., J, T, P, 2)
    scs = scores.movedim(-2, -3)  # (..., J, T, P)
    out_pos, out_score = viterbi_filter(pts, scs, n_back, thres_dist,
                                        score_threshold)
    return out_pos.movedim(-3, -2), out_score.movedim(-2, -1)
