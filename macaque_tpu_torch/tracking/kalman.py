"""Constant-velocity Kalman filter over (cx, cy, w, h) boxes.

Standard BoT-SORT/ByteTrack filter: 8-dim state
[cx, cy, w, h, vcx, vcy, vw, vh], process/measurement noise scaled by the
box size with std_weight_position=1/20, std_weight_velocity=1/160.

NumPy on the host, inside the chunked tracker (:class:`KalmanXYWH`), and
batched over tensors on any device for the on-device track table
(:func:`kalman_predict`, :func:`kalman_update`, the counterparts of the JAX
package's ``kalman_predict_jax`` and ``kalman_update_jax``).
"""

from __future__ import annotations

import numpy as np
import torch

_W_POS = 1.0 / 20
_W_VEL = 1.0 / 160


class KalmanXYWH:
    """NumPy implementation (host tracker). All methods are static and
    operate on (8,) mean / (8, 8) covariance."""

    ndim = 4

    @staticmethod
    def initiate(measurement: np.ndarray):
        """measurement: (4,) cx cy w h."""
        mean = np.zeros(8)
        mean[:4] = measurement
        w, h = measurement[2], measurement[3]
        std = np.array([
            2 * _W_POS * w, 2 * _W_POS * h, 2 * _W_POS * w, 2 * _W_POS * h,
            10 * _W_VEL * w, 10 * _W_VEL * h, 10 * _W_VEL * w, 10 * _W_VEL * h,
        ])
        cov = np.diag(std ** 2)
        return mean, cov

    @staticmethod
    def predict(mean: np.ndarray, cov: np.ndarray):
        w, h = mean[2], mean[3]
        q = np.array([
            _W_POS * w, _W_POS * h, _W_POS * w, _W_POS * h,
            _W_VEL * w, _W_VEL * h, _W_VEL * w, _W_VEL * h,
        ])
        F = np.eye(8)
        F[:4, 4:] = np.eye(4)
        mean = F @ mean
        cov = F @ cov @ F.T + np.diag(q ** 2)
        return mean, cov

    @staticmethod
    def update(mean: np.ndarray, cov: np.ndarray, measurement: np.ndarray):
        w, h = mean[2], mean[3]
        r = np.array([_W_POS * w, _W_POS * h, _W_POS * w, _W_POS * h])
        H = np.zeros((4, 8))
        H[:, :4] = np.eye(4)
        S = H @ cov @ H.T + np.diag(r ** 2)
        K = cov @ H.T @ np.linalg.inv(S)
        innov = measurement - mean[:4]
        mean = mean + K @ innov
        cov = (np.eye(8) - K @ H) @ cov
        return mean, cov


def _motion(mean: torch.Tensor) -> torch.Tensor:
    """F: identity plus the velocity block (x' = x + v)."""
    F = torch.eye(8, dtype=mean.dtype, device=mean.device)
    F[:4, 4:] = torch.eye(4, dtype=mean.dtype, device=mean.device)
    return F


def kalman_predict(mean: torch.Tensor, cov: torch.Tensor):
    """:meth:`KalmanXYWH.predict` batched over leading dims: mean (..., 8),
    cov (..., 8, 8)."""
    w, h = mean[..., 2], mean[..., 3]
    q = torch.stack([
        _W_POS * w, _W_POS * h, _W_POS * w, _W_POS * h,
        _W_VEL * w, _W_VEL * h, _W_VEL * w, _W_VEL * h,
    ], dim=-1)
    F = _motion(mean)
    mean = torch.einsum("ij,...j->...i", F, mean)
    cov = torch.einsum("ij,...jk,lk->...il", F, cov, F) + torch.diag_embed(q ** 2)
    return mean, cov


def kalman_update(mean: torch.Tensor, cov: torch.Tensor,
                  measurement: torch.Tensor):
    """:meth:`KalmanXYWH.update` batched over leading dims; measurement
    (..., 4) cx cy w h."""
    w, h = mean[..., 2], mean[..., 3]
    r = torch.stack([_W_POS * w, _W_POS * h, _W_POS * w, _W_POS * h], dim=-1)
    H = torch.zeros((4, 8), dtype=mean.dtype, device=mean.device)
    H[:, :4] = torch.eye(4, dtype=mean.dtype, device=mean.device)
    S = torch.einsum("ij,...jk,lk->...il", H, cov, H) + torch.diag_embed(r ** 2)
    PHt = torch.einsum("...ij,kj->...ik", cov, H)
    K = torch.linalg.solve(S, PHt.transpose(-1, -2)).transpose(-1, -2)
    mean = mean + torch.einsum("...ij,...j->...i", K, measurement - mean[..., :4])
    eye = torch.eye(8, dtype=mean.dtype, device=mean.device)
    cov = torch.einsum("...ij,...jk->...ik", eye - K @ H, cov)
    return mean, cov
