"""Constant-velocity Kalman filter over (cx, cy, w, h) boxes.

Standard BoT-SORT/ByteTrack filter: 8-dim state
[cx, cy, w, h, vcx, vcy, vw, vh], process/measurement noise scaled by the
box size with std_weight_position=1/20, std_weight_velocity=1/160.

NumPy on the host, inside the chunked tracker. (The on-device track table
of the JAX package is not ported yet.)
"""

from __future__ import annotations

import numpy as np

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
