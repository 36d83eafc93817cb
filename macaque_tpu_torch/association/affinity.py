"""Cross-view geometric affinity from 3D viewing-ray distances.

Port of ``macaque_tpu/association/affinity.py``: the rays of every
(keyframe, detection, joint) triple in one batched unprojection, the
pairwise line-line distances as one broadcast tensor op, the z-score and
sigmoid normalization batched over keyframes.
"""

from __future__ import annotations

import torch

from macaque_tpu_torch.cameras.omnidir import (
    OmnidirCamera,
    unproject_ray_from_undistorted,
)

THR_KP = 0.1      # keypoint confidence threshold (reference step2:21)
DTH2 = 150.0      # affinity distance cutoff, mm (reference step2:391)
SIGMOID_SLOPE = 5.0  # (reference step2:430)


def build_rays(cam: OmnidirCamera, und_points: torch.Tensor,
               cam_idx: torch.Tensor, far_depth: float = 1000.0):
    """Viewing rays for detections assigned to cameras.

    und_points: (..., M, J, 2) undistorted normalized keypoint coords.
    cam_idx: (M,) camera index per detection.
    Returns (origin (..., M, J, 3), unit direction (..., M, J, 3)).
    """
    sub_cam = OmnidirCamera(*[f[cam_idx] for f in cam])
    near = unproject_ray_from_undistorted(sub_cam, und_points, 0.0)
    far = unproject_ray_from_undistorted(sub_cam, und_points, far_depth)
    d = far - near
    d = d / torch.linalg.vector_norm(d + 1e-12, dim=-1, keepdim=True)
    return near, d


def line_distance_matrix(origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Pairwise line-line distances: origins/dirs (..., M, J, 3) ->
    (..., M, M, J), ``|(p2 - p1) . (d1 x d2)| / |d1 x d2|``."""
    p1 = origins[..., :, None, :, :]
    p2 = origins[..., None, :, :, :]
    d1 = dirs[..., :, None, :, :]
    d2 = dirs[..., None, :, :, :]
    c = torch.linalg.cross(*torch.broadcast_tensors(d1, d2), dim=-1)
    cn = torch.linalg.vector_norm(c, dim=-1)
    num = torch.abs(((p2 - p1) * c).sum(-1))
    return num / torch.clamp(cn, min=1e-12)


def geometry_affinity(cam: OmnidirCamera, und_points: torch.Tensor,
                      scores: torch.Tensor, cam_idx: torch.Tensor,
                      det_valid: torch.Tensor) -> torch.Tensor:
    """Affinity matrix over padded detections, batched over keyframes.

    und_points (T, M, J, 2), scores (T, M, J), cam_idx (M,), det_valid
    (T, M) -> affinity (T, M, M) in [0, 1]; 0 for same-camera pairs,
    invalid detections and pairs farther than DTH2.
    """
    origins, dirs = build_rays(cam, und_points, cam_idx)
    dist = line_distance_matrix(origins, dirs)  # (T, M, M, J)

    conf = scores > THR_KP
    pair_conf = conf[..., :, None, :] & conf[..., None, :, :]
    n_joint = pair_conf.sum(-1)
    mean_dist = torch.where(pair_conf, dist, 0.0).sum(-1) / torch.clamp(
        n_joint, min=1)

    same_cam = cam_idx[:, None] == cam_idx[None, :]
    pair_valid = (det_valid[..., :, None] & det_valid[..., None, :]
                  & ~same_cam & (n_joint >= 3))
    dist_mat = torch.where(pair_valid, mean_dist, DTH2 * 2)
    eye = torch.eye(dist_mat.shape[-1], dtype=torch.bool,
                    device=dist_mat.device)
    dist_mat = torch.where(eye, 0.0, dist_mat)

    # z-score over in-range entries (the zero diagonal included, as the
    # reference does: step2:426-428), then sigmoid
    in_range = dist_mat < DTH2 * 2
    cnt = torch.clamp(in_range.sum((-2, -1)), min=1)
    mean = torch.where(in_range, dist_mat, 0.0).sum((-2, -1)) / cnt
    var = torch.where(in_range, (dist_mat - mean[..., None, None]) ** 2,
                      0.0).sum((-2, -1)) / cnt
    std = torch.sqrt(torch.clamp(var, min=1e-12))
    z = -(dist_mat - mean[..., None, None]) / std[..., None, None]
    aff = 1.0 / (1.0 + torch.exp(-SIGMOID_SLOPE * z))
    return torch.where(dist_mat > DTH2, 0.0, aff)


def combined_affinity(geo_aff: torch.Tensor, collar_ids: torch.Tensor,
                      cam_idx: torch.Tensor, alpha_id=0.2) -> torch.Tensor:
    """``alpha * [same collar id] + (1 - alpha) * geo``, gated by
    ``geo > 0``. collar_ids (T, M) int, -1 = unknown."""
    same_id = (collar_ids[..., :, None] >= 0) & (
        collar_ids[..., :, None] == collar_ids[..., None, :])
    diff_cam = cam_idx[:, None] != cam_idx[None, :]
    cid_mat = (same_id & diff_cam).to(geo_aff.dtype)
    W = alpha_id * cid_mat + (1 - alpha_id) * geo_aff
    W = W * (geo_aff > 0)
    return torch.nan_to_num(W)
