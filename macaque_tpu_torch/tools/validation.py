"""3D tracking validation: precision/recall against ground-truth
annotations.

Port of ``macaque_tpu/tools/validation.py`` on the port's ``hungarian``.
Replicates the reference's north-star integration metric
(notebooks/validation_track3.ipynb ``check_performance``): predicted
animal centroids (mean of the shoulder keypoints 5:7) are matched to
ground-truth positions per frame with the Hungarian algorithm; a match
within 400 mm is a true positive; positions inside the cage-exit exclusion
zone are ignored. Reference recorded precision 0.9247 / recall 0.8508.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from macaque_tpu_torch.tracking.hungarian import hungarian


@dataclass
class ValidationResult:
    tp: int
    fp: int
    fn: int

    @property
    def precision(self) -> float:
        return self.tp / max(self.tp + self.fp, 1)

    @property
    def recall(self) -> float:
        return self.tp / max(self.tp + self.fn, 1)

    def __repr__(self):
        return (f"ValidationResult(tp={self.tp}, fp={self.fp}, fn={self.fn},"
                f" precision={self.precision:.4f}, recall={self.recall:.4f})")


def centroids_from_kp3d(kp3d: np.ndarray) -> np.ndarray:
    """(A, T, J, 3) -> (A, T, 3) shoulder-midpoint centroids
    (reference: mean of kp 5:7)."""
    return np.nanmean(kp3d[:, :, 5:7, :], axis=2)


def check_performance(
    pred_centroids: np.ndarray,
    gt_centroids: np.ndarray,
    tp_threshold: float = 400.0,
    exit_point: Optional[np.ndarray] = np.array([5000.0, 0.0, 800.0]),
    exit_radius: float = 500.0,
) -> ValidationResult:
    """pred/gt: (A_pred, T, 3) / (A_gt, T, 3) with NaN = absent.

    Per frame: Hungarian match on centroid distance; TP if < threshold.
    GT points within ``exit_radius`` of the exit point are excluded
    (animals leaving the cage; reference validation_track3 cell 2).
    """
    T = min(pred_centroids.shape[1], gt_centroids.shape[1])
    tp = fp = fn = 0
    for t in range(T):
        p = pred_centroids[:, t]
        g = gt_centroids[:, t]
        p = p[~np.isnan(p[:, 0])]
        g = g[~np.isnan(g[:, 0])]
        if exit_point is not None and g.shape[0]:
            keep = np.linalg.norm(g - exit_point[None], axis=1) > exit_radius
            g = g[keep]
        if p.shape[0] == 0:
            fn += g.shape[0]
            continue
        if g.shape[0] == 0:
            fp += p.shape[0]
            continue
        d = np.linalg.norm(p[:, None] - g[None], axis=2)
        rows, cols = hungarian(d)
        matched = d[rows, cols] < tp_threshold
        tp += int(matched.sum())
        fp += p.shape[0] - int(matched.sum())
        fn += g.shape[0] - int(matched.sum())
    return ValidationResult(tp, fp, fn)


def validate_kp3d_file(kp3d_pickle: str, gt_pickle: str,
                       tp_threshold: float = 400.0) -> ValidationResult:
    """Convenience wrapper over saved kp3d + ground-truth pickles."""
    from macaque_tpu_torch.pipeline.artifacts import read_pickle

    pred = np.asarray(read_pickle(kp3d_pickle)["kp3d"])
    gt = np.asarray(read_pickle(gt_pickle))
    return check_performance(
        centroids_from_kp3d(pred),
        gt if gt.ndim == 3 else centroids_from_kp3d(gt),
        tp_threshold,
    )
