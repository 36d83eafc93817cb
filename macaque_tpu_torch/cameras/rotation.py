"""Rotation utilities: Rodrigues vector <-> matrix, batched on tensors.

Port of ``macaque_tpu/cameras/rotation.py``; it stands in for
``cv2.Rodrigues`` wherever the port needs it. The 3x3 products are
elementwise sums, never ``matmul``: on CUDA a float32 ``matmul`` follows
``torch.backends.cuda.matmul.allow_tf32``, and TF32's 10-bit mantissa is
millimetres of error at the rig's scale (the JAX package asks for
``Precision.HIGHEST`` for the same reason).
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def mat3_apply(R: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """``R (..., 3, 3)`` applied to ``points (..., N, 3)`` -> ``(..., N, 3)``
    (``einsum('...ij,...nj->...ni')``), leading axes broadcast."""
    return (R[..., None, :, :] * points[..., :, None, :]).sum(-1)


def mat3_apply_t(R: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """``R^T`` applied to ``points`` (``einsum('...ji,...nj->...ni')``)."""
    return mat3_apply(R.transpose(-1, -2), points)


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Rotation vector(s) ``(..., 3)`` -> rotation matrix(es) ``(..., 3, 3)``:
    ``R = I + sin(t)/t K + (1 - cos(t))/t^2 K^2``, Taylor-switched near
    ``t = 0``."""
    theta2 = (rvec * rvec).sum(-1, keepdim=True)[..., None]  # (..., 1, 1)
    small = theta2 < 1e-14
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))

    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    half = theta / 2.0
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    2.0 * (torch.sin(half) / theta) ** 2)

    x, y, z = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    zeros = torch.zeros_like(x)
    K = torch.stack([
        torch.stack([zeros, -z, y], dim=-1),
        torch.stack([z, zeros, -x], dim=-1),
        torch.stack([-y, x, zeros], dim=-1),
    ], dim=-2)
    KK = (K[..., :, :, None] * K[..., None, :, :]).sum(-2)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + a * K + b * KK


def rodrigues_inv(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix(es) ``(..., 3, 3)`` -> rotation vector(s) ``(..., 3)``.

    The log map from the trace and the skew part, with the theta ~ pi
    branch of the JAX package: there the axis is the largest column of
    ``R + R^T - 2 cos(theta) I``, its sign taken from the residual skew
    part."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_t)

    w = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    sin_t = torch.sin(theta)
    scale = torch.where(sin_t > 1e-7, theta / (2.0 * sin_t + _EPS),
                        0.5 + theta * theta / 12.0)
    r_skew = w * scale[..., None]

    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    A = R + R.transpose(-1, -2) - 2.0 * cos_t[..., None, None] * eye
    col_n = torch.linalg.vector_norm(A, dim=-2)            # (..., 3)
    j = torch.argmax(col_n, dim=-1)
    col = torch.take_along_dim(
        A, j[..., None, None].expand(*A.shape[:-1], 1), dim=-1)[..., 0]
    axis = col / (torch.linalg.vector_norm(col, dim=-1, keepdim=True) + _EPS)
    sgn = torch.where((w * axis).sum(-1) < 0.0, -1.0, 1.0).to(R.dtype)
    r_pi = theta[..., None] * axis * sgn[..., None]

    near_pi = (sin_t < 1e-4) & (cos_t < 0.0)
    return torch.where(near_pi[..., None], r_pi, r_skew)


def rotate_points(rvec: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Rotate ``points (..., N, 3)`` by rotation vector(s) ``rvec (..., 3)``."""
    return mat3_apply(rodrigues(rvec), points)
