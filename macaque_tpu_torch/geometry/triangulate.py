"""Masked, batched DLT triangulation on tensors.

Port of ``macaque_tpu/geometry/triangulate.py``. Two variants:

* :func:`triangulate_dlt` - homogeneous DLT: the last right-singular
  vector of the stacked ``2C x 4`` system.
* :func:`triangulate_dlt_pinv` - inhomogeneous 3-unknown least squares
  ``a X = b`` with ``P = -X``, through the 3x3 normal equations.

Both take undistorted normalized image coords, per-camera ``[R|t]``
projection matrices and a validity mask; fewer than 2 valid cameras
yields NaN. The normal equations are elementwise sums, not ``matmul``:
they square the conditioning, and a CUDA float32 ``matmul`` may run in
TF32 (``torch.backends.cuda.matmul.allow_tf32``).
"""

from __future__ import annotations

import torch

from macaque_tpu_torch.cameras.dispatch import project_points


def _dlt_rows(points: torch.Tensor, pmats: torch.Tensor, mask: torch.Tensor):
    """Masked DLT row pairs: points (..., C, 2), pmats (..., C, 3, 4) or
    (C, 3, 4), mask (..., C) -> A (..., 2C, 4), invalid rows zeroed and
    NaN scrubbed."""
    x = points[..., 0:1]
    y = points[..., 1:2]
    p0 = pmats[..., 0, :]
    p1 = pmats[..., 1, :]
    p2 = pmats[..., 2, :]
    r1 = x * p2 - p0
    r2 = y * p2 - p1
    A = torch.cat([r1[..., None, :], r2[..., None, :]], dim=-2)
    A = A.reshape(*A.shape[:-3], -1, 4)
    m2 = torch.repeat_interleave(mask, 2, dim=-1)[..., None]
    A = torch.where(m2, A, 0.0)
    return torch.nan_to_num(A)


def triangulate_dlt(points: torch.Tensor, pmats: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Homogeneous DLT. Returns (..., 3) 3D points; NaN where <2 cams."""
    A = _dlt_rows(points, pmats, mask)
    _, _, Vh = torch.linalg.svd(A, full_matrices=False)
    v = Vh[..., -1, :]
    p3d = v[..., :3] / v[..., 3:4]
    ncam = mask.sum(-1)
    return torch.where((ncam >= 2)[..., None], p3d, torch.nan)


def triangulate_dlt_pinv(points: torch.Tensor, pmats: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Inhomogeneous DLT: solve ``a X = b`` by its normal equations (zeroed
    rows contribute nothing), return ``-X``; NaN where <2 cams."""
    A = _dlt_rows(points, pmats, mask)
    a = A[..., :3]
    b = A[..., 3]
    ata = (a[..., :, :, None] * a[..., :, None, :]).sum(-3)
    atb = (a * b[..., None]).sum(-2)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    X = torch.linalg.solve(ata + 1e-12 * eye, atb[..., None])[..., 0]
    ncam = mask.sum(-1)
    return torch.where((ncam >= 2)[..., None], -X, torch.nan)


def reprojection_error(cam, p3d: torch.Tensor, p2d: torch.Tensor) -> torch.Tensor:
    """Per-camera signed residuals ``observed - projected``: p3d (N, 3),
    p2d (C, N, 2) observed pixels (NaN = missing) -> (C, N, 2)."""
    return p2d - project_points(cam, p3d)


def reprojection_error_mean(cam, p3d: torch.Tensor,
                            p2d: torch.Tensor) -> torch.Tensor:
    """Mean-over-cameras reprojection error per point, NaN if <2 cameras
    observe it."""
    err = reprojection_error(cam, p3d, p2d)
    norm = torch.linalg.vector_norm(err, dim=-1)  # (C, N)
    good = ~torch.isnan(norm)
    norm = torch.where(good, norm, 0.0)
    denom = good.sum(0).to(norm.dtype)
    out = norm.sum(0) / denom
    return torch.where(denom < 1.5, torch.nan, out)
