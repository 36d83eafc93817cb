"""Batched pose-triangulation helpers shared by steps 2 and 3.

Port of ``macaque_tpu/pipeline/geometry3d.py``: undistort, triangulate and
reproject whole batches of poses at once, on whichever device the tensors
lie.
"""

from __future__ import annotations

import torch

from macaque_tpu_torch.cameras.omnidir import (
    OmnidirCamera,
    omnidir_project,
    omnidir_undistort,
)
from macaque_tpu_torch.geometry.triangulate import triangulate_dlt_pinv

THR_KP = 0.1  # reference step2:21


def triangulate_poses(cam: OmnidirCamera, kp2d: torch.Tensor) -> torch.Tensor:
    """kp2d: (..., C, J, 3) raw pixels [x, y, score] -> (..., J, 3) 3D:
    undistort, mask NaN or score < 0.1, pinv-DLT per joint, NaN when <2
    cameras."""
    und = omnidir_undistort(cam, kp2d[..., :2])  # cams broadcast over (...)
    valid = (~torch.isnan(kp2d[..., 0])) & (kp2d[..., 2] >= THR_KP)
    # (..., C, J, *) -> per joint (..., J, C, *)
    undJ = torch.nan_to_num(und).transpose(-3, -2)
    validJ = valid.transpose(-2, -1)
    return triangulate_dlt_pinv(undJ, cam.pmat, validJ)


def reproject_poses(cam: OmnidirCamera, p3d: torch.Tensor) -> torch.Tensor:
    """p3d: (..., J, 3) -> (..., C, J, 2) pixel reprojections."""
    batch, J = p3d.shape[:-2], p3d.shape[-2]
    out = omnidir_project(cam, p3d.reshape(-1, 1, J, 3))   # (B, C, J, 2)
    return out.reshape(*batch, out.shape[1], J, 2)


def reprojection_rmse(cam: OmnidirCamera, p3d: torch.Tensor,
                      kp2d: torch.Tensor, use_cam: torch.Tensor) -> torch.Tensor:
    """Per-sample RMSE of reprojection vs observed keypoints over selected
    cameras and confident joints (residuals stacked over cameras, joints
    and both coordinates). p3d (..., J, 3); kp2d (..., C, J, 3); use_cam
    (..., C) bool."""
    proj = reproject_poses(cam, p3d)
    valid = (kp2d[..., 2] > THR_KP) & use_cam[..., None]
    diff = torch.where(valid[..., None], kp2d[..., :2] - proj, 0.0)
    diff = torch.nan_to_num(diff)
    n = valid.sum((-2, -1)) * 2
    ss = (diff ** 2).sum((-3, -2, -1))
    return torch.sqrt(ss / torch.clamp(n, min=1))
