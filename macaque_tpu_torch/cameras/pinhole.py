"""Pinhole (Brown-Conrady) camera model on tensors.

Port of ``macaque_tpu/cameras/pinhole.py``: ``cv2.projectPoints`` and
``cv2.undistortPoints`` semantics, distortion ``[k1, k2, p1, p2, k3]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from macaque_tpu_torch.cameras.rotation import mat3_apply, rodrigues

_UNDIST_ITERS = 20


class PinholeCamera(NamedTuple):
    """Batched pinhole camera. Distortion [k1, k2, p1, p2, k3]."""

    K: torch.Tensor     # (..., 3, 3)
    dist: torch.Tensor  # (..., 5)
    rvec: torch.Tensor  # (..., 3)
    tvec: torch.Tensor  # (..., 3)

    @property
    def R(self) -> torch.Tensor:
        return rodrigues(self.rvec)

    @property
    def pmat(self) -> torch.Tensor:
        return torch.cat([self.R, self.tvec[..., :, None]], dim=-1)


def _distort(x, y, dist):
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def pinhole_project(cam: PinholeCamera, points: torch.Tensor) -> torch.Tensor:
    """World points ``(..., N, 3)`` -> pixels ``(..., N, 2)``."""
    Xc = mat3_apply(cam.R, points) + cam.tvec[..., None, :]
    x = Xc[..., 0] / Xc[..., 2]
    y = Xc[..., 1] / Xc[..., 2]
    xd, yd = _distort(x, y, cam.dist[..., None, :])
    fx = cam.K[..., None, 0, 0]
    fy = cam.K[..., None, 1, 1]
    s = cam.K[..., None, 0, 1]
    cx = cam.K[..., None, 0, 2]
    cy = cam.K[..., None, 1, 2]
    return torch.stack([fx * xd + s * yd + cx, fy * yd + cy], dim=-1)


def pinhole_undistort(cam: PinholeCamera, pixels: torch.Tensor) -> torch.Tensor:
    """Pixels ``(..., N, 2)`` -> ideal normalized coords on z=1, by
    ``_UNDIST_ITERS`` fixed-point steps."""
    fx = cam.K[..., None, 0, 0]
    fy = cam.K[..., None, 1, 1]
    s = cam.K[..., None, 0, 1]
    cx = cam.K[..., None, 0, 2]
    cy = cam.K[..., None, 1, 2]
    ppy = (pixels[..., 1] - cy) / fy
    ppx = (pixels[..., 0] - cx - s * ppy) / fx

    dist = cam.dist[..., None, :]
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))

    x, y = ppx, ppy
    for _ in range(_UNDIST_ITERS):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        x, y = (
            (ppx - 2.0 * p1 * x * y - p2 * (r2 + 2.0 * x * x)) / radial,
            (ppy - 2.0 * p2 * x * y - p1 * (r2 + 2.0 * y * y)) / radial,
        )
    return torch.stack([x, y], dim=-1)
