"""Mei omnidirectional camera model on tensors.

Port of ``macaque_tpu/cameras/omnidir.py``: intrinsics ``K`` (3x3 with
skew), mirror parameter ``xi`` and distortion ``D = [k1, k2, p1, p2]``, the
model OpenCV's ``cv2.omnidir`` calibrates.

Projection of a camera-frame point ``Xc``:
  1. normalize to the unit sphere           ``Xs = Xc / |Xc|``
  2. perspective from the mirror center     ``m = Xs_xy / (Xs_z + xi)``
  3. radial-tangential distortion on ``m``  (k1, k2, p1, p2)
  4. pixel coords via K (fx, fy, skew s, cx, cy)

Undistortion inverts 4..2: a fixed-point iteration of ``_UNDIST_ITERS``
steps for the distortion, a closed-form quadratic for the sphere lift.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from macaque_tpu_torch.cameras.rotation import (
    mat3_apply, mat3_apply_t, rodrigues)

_UNDIST_ITERS = 20  # matches OpenCV omnidir's fixed-point iteration count


class OmnidirCamera(NamedTuple):
    """Batched omnidir camera parameters; every field may carry leading
    batch axes (e.g. ``(n_cam, ...)``)."""

    K: torch.Tensor     # (..., 3, 3) intrinsics for the omnidir model
    xi: torch.Tensor    # (...,) mirror parameter
    D: torch.Tensor     # (..., 4) distortion [k1, k2, p1, p2]
    rvec: torch.Tensor  # (..., 3) world->camera rotation (Rodrigues)
    tvec: torch.Tensor  # (..., 3) world->camera translation

    @property
    def R(self) -> torch.Tensor:
        return rodrigues(self.rvec)

    @property
    def pmat(self) -> torch.Tensor:
        """Extrinsics matrix ``[R | t]`` of shape (..., 3, 4)."""
        return torch.cat([self.R, self.tvec[..., :, None]], dim=-1)


def _distort(mx, my, D):
    """Apply radial-tangential distortion to normalized coords."""
    k1, k2, p1, p2 = D[..., 0], D[..., 1], D[..., 2], D[..., 3]
    r2 = mx * mx + my * my
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = mx * radial + 2.0 * p1 * mx * my + p2 * (r2 + 2.0 * mx * mx)
    yd = my * radial + p1 * (r2 + 2.0 * my * my) + 2.0 * p2 * mx * my
    return xd, yd


def omnidir_project(cam: OmnidirCamera, points: torch.Tensor) -> torch.Tensor:
    """Project world points ``(..., N, 3)`` to pixel coords ``(..., N, 2)``
    (``cv2.omnidir.projectPoints``), batched over cameras and points."""
    Xc = mat3_apply(cam.R, points) + cam.tvec[..., None, :]

    norm = torch.linalg.vector_norm(Xc, dim=-1, keepdim=True)
    Xs = Xc / torch.clamp(norm, min=1e-12)

    xi = cam.xi[..., None]
    denom = Xs[..., 2] + xi
    mx = Xs[..., 0] / denom
    my = Xs[..., 1] / denom

    xd, yd = _distort(mx, my, cam.D[..., None, :])

    fx = cam.K[..., None, 0, 0]
    fy = cam.K[..., None, 1, 1]
    s = cam.K[..., None, 0, 1]
    cx = cam.K[..., None, 0, 2]
    cy = cam.K[..., None, 1, 2]
    u = fx * xd + s * yd + cx
    v = fy * yd + cy
    return torch.stack([u, v], dim=-1)


def omnidir_undistort(cam: OmnidirCamera, pixels: torch.Tensor) -> torch.Tensor:
    """Undistort pixel coords ``(..., N, 2)`` to ideal normalized coords on
    the ``z=1`` plane (``cv2.omnidir.undistortPoints(..., R=eye(3))``):
    invert K (with skew), fixed-point undistort, lift to the unit sphere,
    reproject to the plane. NaN in, NaN out."""
    fx = cam.K[..., None, 0, 0]
    fy = cam.K[..., None, 1, 1]
    s = cam.K[..., None, 0, 1]
    cx = cam.K[..., None, 0, 2]
    cy = cam.K[..., None, 1, 2]

    ppy = (pixels[..., 1] - cy) / fy
    ppx = (pixels[..., 0] - cx - s * ppy) / fx

    D = cam.D[..., None, :]
    k1, k2, p1, p2 = D[..., 0], D[..., 1], D[..., 2], D[..., 3]

    pux, puy = ppx, ppy
    for _ in range(_UNDIST_ITERS):
        r2 = pux * pux + puy * puy
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        pux, puy = (
            (ppx - 2.0 * p1 * pux * puy - p2 * (r2 + 2.0 * pux * pux)) / radial,
            (ppy - 2.0 * p2 * pux * puy - p1 * (r2 + 2.0 * puy * puy)) / radial,
        )

    # lift to the unit sphere: Zs with |Xs| = 1, Xs_xy = pu * (Zs + xi)
    xi = cam.xi[..., None]
    r2 = pux * pux + puy * puy
    a = r2 + 1.0
    b = 2.0 * xi * r2
    c = r2 * xi * xi - 1.0
    Zs = (-b + torch.sqrt(torch.clamp(b * b - 4.0 * a * c, min=0.0))) / (2.0 * a)

    scale = (Zs + xi) / Zs
    return torch.stack([pux * scale, puy * scale], dim=-1)


def unproject_ray_from_undistorted(
    cam: OmnidirCamera, und: torch.Tensor, depths
) -> torch.Tensor:
    """World-frame points at ``depths`` along the rays of undistorted
    normalized coords ``und (..., N, 2)``: camera-frame ``(x d, y d, d)``,
    world ``R^T (p - t)``."""
    d = torch.as_tensor(depths, dtype=und.dtype, device=und.device)
    d = torch.broadcast_to(d, und.shape[:-1])[..., None]
    pc = torch.cat([und * d, d], dim=-1)
    return mat3_apply_t(cam.R, pc - cam.tvec[..., None, :])


def omnidir_unproject_ray(
    cam: OmnidirCamera, pixels: torch.Tensor, depths
) -> torch.Tensor:
    """Back-project pixels to world-frame 3D points along the viewing ray;
    ``depths`` a scalar or broadcastable to ``(..., N)``."""
    return unproject_ray_from_undistorted(
        cam, omnidir_undistort(cam, pixels), depths)
