"""Equidistant (Kannala-Brandt) fisheye camera model on tensors.

Port of ``macaque_tpu/cameras/fisheye.py`` (``cv2.fisheye`` semantics).
Projection of a camera-frame point ``Xc``:
  1. pinhole normalize                  ``x = Xc_xy / Xc_z``
  2. equidistant distortion             ``r = |x|``, ``theta = atan(r)``,
     ``theta_d = theta * (1 + k1 th^2 + k2 th^4 + k3 th^6 + k4 th^8)``
  3. radial rescale                     ``xd = x * theta_d / r``
  4. pixels via fx, fy, cx, cy (no skew)

Undistortion inverts step 2 with ``_NEWTON_ITERS`` Newton steps, then
returns to the z=1 plane with ``tan``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from macaque_tpu_torch.cameras.rotation import mat3_apply, rodrigues

_NEWTON_ITERS = 10  # matches cv2.fisheye.undistortPoints' iteration budget


class FisheyeCamera(NamedTuple):
    """Batched equidistant-fisheye camera parameters; every field may carry
    leading batch axes."""

    K: torch.Tensor     # (..., 3, 3) pinhole intrinsics (skew unused)
    D: torch.Tensor     # (..., 4) distortion [k1, k2, k3, k4]
    rvec: torch.Tensor  # (..., 3) world->camera rotation (Rodrigues)
    tvec: torch.Tensor  # (..., 3) world->camera translation

    @property
    def R(self) -> torch.Tensor:
        return rodrigues(self.rvec)

    @property
    def pmat(self) -> torch.Tensor:
        """Extrinsics matrix ``[R | t]`` of shape (..., 3, 4)."""
        return torch.cat([self.R, self.tvec[..., :, None]], dim=-1)


def _theta_d(theta, D):
    k1, k2, k3, k4 = D[..., 0], D[..., 1], D[..., 2], D[..., 3]
    t2 = theta * theta
    return theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))


def fisheye_distort(x, y, D):
    """Equidistant-distort z=1-plane coords; scale 1 at ``r <= 1e-8``."""
    r = torch.sqrt(x * x + y * y)
    theta = torch.arctan(r)
    big = r > 1e-8
    scale = torch.where(
        big, _theta_d(theta, D) / torch.where(big, r, torch.ones_like(r)),
        torch.ones_like(r))
    return x * scale, y * scale


def fisheye_project(cam: FisheyeCamera, points: torch.Tensor) -> torch.Tensor:
    """Project world points ``(..., N, 3)`` to pixel coords ``(..., N, 2)``."""
    Xc = mat3_apply(cam.R, points) + cam.tvec[..., None, :]
    x = Xc[..., 0] / Xc[..., 2]
    y = Xc[..., 1] / Xc[..., 2]
    xd, yd = fisheye_distort(x, y, cam.D[..., None, :])
    fx = cam.K[..., None, 0, 0]
    fy = cam.K[..., None, 1, 1]
    cx = cam.K[..., None, 0, 2]
    cy = cam.K[..., None, 1, 2]
    return torch.stack([fx * xd + cx, fy * yd + cy], dim=-1)


def fisheye_undistort(cam: FisheyeCamera, pixels: torch.Tensor) -> torch.Tensor:
    """Undistort pixel coords ``(..., N, 2)`` to ideal normalized coords on
    the ``z=1`` plane (``cv2.fisheye.undistortPoints(points, K, D)``):
    ``theta_d`` clamped to [-pi/2, pi/2], the polynomial inverted by
    Newton's method; a point whose iteration flips sign gets cv2's
    ``-1e6``. NaN in, NaN out."""
    fx = cam.K[..., None, 0, 0]
    fy = cam.K[..., None, 1, 1]
    cx = cam.K[..., None, 0, 2]
    cy = cam.K[..., None, 1, 2]
    pwx = (pixels[..., 0] - cx) / fx
    pwy = (pixels[..., 1] - cy) / fy

    D = cam.D[..., None, :]
    k1, k2, k3, k4 = D[..., 0], D[..., 1], D[..., 2], D[..., 3]

    theta_d = torch.clamp(torch.sqrt(pwx * pwx + pwy * pwy),
                          -math.pi / 2, math.pi / 2)
    theta = theta_d
    for _ in range(_NEWTON_ITERS):
        t2 = theta * theta
        t4 = t2 * t2
        t6 = t4 * t2
        t8 = t6 * t2
        num = theta * (1 + k1 * t2 + k2 * t4 + k3 * t6 + k4 * t8) - theta_d
        den = 1 + 3 * k1 * t2 + 5 * k2 * t4 + 7 * k3 * t6 + 9 * k4 * t8
        theta = theta - num / den

    small = torch.abs(theta_d) <= 1e-8
    flipped = ((theta_d < 0) & (theta > 0)) | ((theta_d > 0) & (theta < 0))
    one = torch.ones_like(theta_d)
    scale = torch.where(small, one,
                        torch.tan(theta) / torch.where(small, one, theta_d))
    bad = flipped & ~small
    ux = torch.where(bad, -1e6, pwx * scale)
    uy = torch.where(bad, -1e6, pwy * scale)
    return torch.stack([ux, uy], dim=-1)
