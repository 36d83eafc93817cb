"""Post-hoc analysis over kp3d results: trajectories, inter-animal
proximity, joint-length statistics.

Port of ``macaque_tpu/tools/analysis.py``, the same host code (numpy;
``h5py`` inside :func:`inspect_calibration_h5`). Covers the analysis
surface of the reference's notebooks (analysis_plots.ipynb
trajectory/proximity plots, bbox_optimisation_algorithm.ipynb
joint-length stats) as library functions.
"""

from __future__ import annotations

import numpy as np


def trajectories(kp3d: np.ndarray) -> np.ndarray:
    """(A, T, J, 3) -> (A, T, 3) body-centre trajectories (median joints)."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.nanmedian(kp3d, axis=2)


def pairwise_proximity(kp3d: np.ndarray) -> np.ndarray:
    """(A, T, J, 3) -> (A, A, T) inter-animal centre distances (mm)."""
    c = trajectories(kp3d)
    return np.linalg.norm(c[:, None] - c[None, :], axis=-1)


def proximity_events(kp3d: np.ndarray, threshold_mm: float = 500.0):
    """Frames where animal pairs are closer than ``threshold_mm``.
    Returns dict (a, b) -> bool array (T,)."""
    d = pairwise_proximity(kp3d)
    A = d.shape[0]
    return {
        (a, b): d[a, b] < threshold_mm
        for a in range(A) for b in range(a + 1, A)
    }


def joint_length_stats(kp3d: np.ndarray, constraints) -> dict:
    """Per-constraint bone-length median/MAD over animals and time
    (feeds the fixed-joint-length mode, reference step4:179-183)."""
    out = {}
    for (a, b) in constraints:
        seg = kp3d[:, :, a] - kp3d[:, :, b]
        lengths = np.linalg.norm(seg, axis=-1).ravel()
        lengths = lengths[~np.isnan(lengths)]
        med = float(np.median(lengths)) if lengths.size else float("nan")
        mad = float(np.median(np.abs(lengths - med))) if lengths.size else float("nan")
        out[(a, b)] = {"median": med, "mad": mad, "n": int(lengths.size)}
    return out


def speed(kp3d: np.ndarray, fps: float = 24.0) -> np.ndarray:
    """(A, T, J, 3) -> (A, T-1) centre speed in mm/s."""
    c = trajectories(kp3d)
    return np.linalg.norm(np.diff(c, axis=1), axis=-1) * fps


# --------------------------------------------------------------------------
# training-log and calibration inspection (the id_eval /
# bbox_optimisation_algorithm notebook surfaces)
# --------------------------------------------------------------------------


def class_weights_from_counts(counts) -> list:
    """Inverse-frequency class weights: total / (n_classes * count)
    (reference notebooks/id_eval.ipynb cell 1 — feeds the ID configs'
    LabelSmoothLoss class_weight, model/id/*.py:51-71)."""
    counts = list(counts)
    total = sum(counts)
    n = len(counts)
    return [total / (n * c) for c in counts]


def moving_average(arr, window: int = 5) -> np.ndarray:
    """Edge-padded moving average (id_eval.ipynb smoothing helper)."""
    arr = np.asarray(arr, float)
    if window < 2 or arr.size == 0:
        return arr
    pad_l = window // 2
    pad_r = window - 1 - pad_l
    padded = np.pad(arr, (pad_l, pad_r), mode="edge")
    return np.convolve(padded, np.ones(window) / window, mode="valid")


def parse_training_log(json_log: str) -> dict:
    """Parse an mmengine vis_data JSONL training log into per-epoch mean
    loss + validation top-1 accuracy curves with the best epoch
    (reference notebooks/id_eval.ipynb cells 2-5).

    Returns {train_epochs, avg_loss, val_steps, val_acc, best_step,
    best_acc} (numpy arrays / scalars; empty arrays when absent)."""
    import json as _json

    epoch_loss: dict = {}
    val_steps, val_acc = [], []
    with open(json_log) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = _json.loads(line)
            if "loss" in rec and "epoch" in rec:
                epoch_loss.setdefault(int(rec["epoch"]), []).append(
                    float(rec["loss"]))
            if "accuracy/top1" in rec and "step" in rec \
                    and "loss" not in rec:
                val_steps.append(int(rec["step"]))
                val_acc.append(float(rec["accuracy/top1"]))

    train_epochs = np.array(sorted(epoch_loss), int)
    avg_loss = np.array([np.mean(epoch_loss[e]) for e in train_epochs])
    val_steps = np.array(val_steps, int)
    val_acc = np.array(val_acc, float)
    best = int(np.argmax(val_acc)) if val_acc.size else -1
    return {
        "train_epochs": train_epochs,
        "avg_loss": avg_loss,
        "val_steps": val_steps,
        "val_acc": val_acc,
        "best_step": int(val_steps[best]) if best >= 0 else None,
        "best_acc": float(val_acc[best]) if best >= 0 else None,
    }


def joint_length_summary(joint_len: np.ndarray) -> dict:
    """Mean/std per joint segment from a stacked joint_len array
    (reference notebooks/bbox_optimisation_algorithm.ipynb cell 0;
    the calib/joint_len.npy fixed-length prior, step4:179-183)."""
    joint_len = np.asarray(joint_len, float)
    if joint_len.ndim == 1:
        joint_len = joint_len[None]
    return {
        "mean": np.nanmean(joint_len, axis=0),
        "std": np.nanstd(joint_len, axis=0),
        "labels": [f"J{i}" for i in range(joint_len.shape[-1])],
    }


def inspect_calibration_h5(path: str) -> dict:
    """Summarize a calibration h5 (cameras, dataset shapes, focal/center
    per camera) — bbox_optimisation_algorithm.ipynb cell 1."""
    import h5py

    out: dict = {}
    with h5py.File(path, "r") as f:
        for cam in f:
            g = f[cam]
            info = {k: tuple(g[k].shape) for k in g}
            for k in g:
                if tuple(g[k].shape) == (3, 3):
                    m = np.asarray(g[k])
                    info["fx"], info["fy"] = float(m[0, 0]), float(m[1, 1])
                    info["cx"], info["cy"] = float(m[0, 2]), float(m[1, 2])
            out[cam] = info
    return out
