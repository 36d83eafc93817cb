"""Joint-angle computation and 3D post-filters.

Port of ``macaque_tpu/tools/angles.py``, the same host code (numpy and
scipy). Covers the anipose CLI analysis surface the reference vendors
(src/third_party/anipose/compute_angles.py, filter_3d.py): joint angles
from bodypart triplets and median-filter-based 3D smoothing with
error-threshold gating — vectorized over animals/frames.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from macaque_tpu_torch.core.config import MACAQUE_BODYPARTS

# default angle triplets (vertex at the middle bodypart)
DEFAULT_ANGLES = {
    "left_elbow": ("left_shoulder", "left_elbow", "left_wrist"),
    "right_elbow": ("right_shoulder", "right_elbow", "right_wrist"),
    "left_knee": ("left_hip", "left_knee", "left_ankle"),
    "right_knee": ("right_hip", "right_knee", "right_ankle"),
    "left_shoulder": ("left_elbow", "left_shoulder", "left_hip"),
    "right_shoulder": ("right_elbow", "right_shoulder", "right_hip"),
    "left_hip": ("left_shoulder", "left_hip", "left_knee"),
    "right_hip": ("right_shoulder", "right_hip", "right_knee"),
}


def compute_angles(
    kp3d: np.ndarray,
    angles: dict | None = None,
    bodyparts: Sequence[str] = tuple(MACAQUE_BODYPARTS),
) -> dict:
    """(..., J, 3) -> {name: (...,) angle in degrees at the vertex}."""
    angles = angles or DEFAULT_ANGLES
    idx = {b: i for i, b in enumerate(bodyparts)}
    out = {}
    for name, (a, b, c) in angles.items():
        va = kp3d[..., idx[a], :] - kp3d[..., idx[b], :]
        vc = kp3d[..., idx[c], :] - kp3d[..., idx[b], :]
        cos = np.sum(va * vc, axis=-1) / (
            np.linalg.norm(va, axis=-1) * np.linalg.norm(vc, axis=-1) + 1e-12
        )
        out[name] = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
    return out


def _normalize(u: np.ndarray) -> np.ndarray:
    return u / np.linalg.norm(u, axis=-1, keepdims=True)


def _ortho(u, v) -> np.ndarray:
    """Component of ``u`` orthogonal to ``v`` (rows). anipose
    compute_angles.py:16-23 semantics, including NaN propagation."""
    u = np.broadcast_to(np.asarray(u, float), np.shape(v)).copy()
    v = np.asarray(v, float)
    coef = np.sum(u * v, axis=-1) / np.sum(v * v, axis=-1)
    return u - v * coef[..., None]


def angles_flex(vecs: dict, angle) -> np.ndarray:
    """Flexion angle at vertex b of (a, b, c), degrees
    (anipose compute_angles.py:104-111)."""
    a, b, c = angle
    v1 = _normalize(vecs[a] - vecs[b])
    v2 = _normalize(vecs[c] - vecs[b])
    return np.degrees(np.arccos(np.sum(v1 * v2, axis=-1)))


def angles_axis(vecs: dict, angle) -> np.ndarray:
    """Rotation of segment (b - c) about the (a - b) axis, degrees
    (anipose compute_angles.py:113-123): the axis frame takes world-x
    orthogonalized against the segment as its zero direction."""
    a, b, c = angle
    v1 = vecs[a] - vecs[b]
    v2 = vecs[b] - vecs[c]
    z = _normalize(v1)
    x = _normalize(_ortho([1.0, 0.0, 0.0], z))
    y = np.cross(z, x)
    return np.degrees(np.arctan2(np.sum(v2 * y, axis=-1),
                                 np.sum(v2 * x, axis=-1)))


def angles_crossaxis(vecs: dict, angle) -> np.ndarray:
    """Rotation of (c - a) about the normal of the (a,b,c) plane,
    degrees (anipose compute_angles.py:125-136)."""
    a, b, c = angle
    v1 = vecs[a] - vecs[b]
    v2 = vecs[b] - vecs[c]
    point = vecs[c] - vecs[a]
    z = _normalize(np.cross(v1, v2))
    x = _normalize(_ortho([1.0, 0.0, 0.0], z))
    y = np.cross(z, x)
    return np.degrees(np.arctan2(np.sum(point * y, axis=-1),
                                 np.sum(point * x, axis=-1)))


def angles_chain(vecs: dict, chain_list) -> dict:
    """Euler-decomposed angles along a kinematic chain
    (anipose compute_angles.py:47-102). Chain entries ending in "/"
    flip the flexion sign convention for that joint. Per inner joint
    the local frame takes the next segment as +z and the following
    bone's orthogonal component as +x; consecutive frames' relative
    rotation is decomposed as intrinsic z-y-x Euler angles, and inner
    joints are re-wrapped so the flex channel matches the plain
    three-point flexion angle. Returns {joint_flex / joint_rot /
    joint_abduct: (F,) degrees}."""
    from scipy.spatial.transform import Rotation

    chain, sign = [], []
    for c in chain_list:
        chain.append(c[:-1] if c.endswith("/") else c)
        sign.append(-1.0 if c.endswith("/") else 1.0)
    n = len(chain)
    kps = [np.asarray(vecs[c], float) for c in chain]
    F = kps[0].shape[0]

    frames = [Rotation.identity(F)]
    for i in range(n - 1):
        z = _normalize(kps[i + 1] - kps[i])
        if i == n - 2:
            # arbitrary reference axis for the terminal joint
            x = _ortho([1.0, 0.0, 0.0], z)
            if np.linalg.norm(x) < 1e-5:
                x = _ortho([0.0, 1.0, 0.0], z)
        else:
            x = _ortho(kps[i + 2] - kps[i + 1], z) * sign[i + 1]
        x = _normalize(x)
        frames.append(Rotation.from_matrix(
            np.stack([x, np.cross(z, x), z], axis=-1)))

    out = {}
    for i in range(n - 1):
        ang = (frames[i].inv() * frames[i + 1]).as_euler(
            "zyx", degrees=True)
        if i != 0:
            flex = angles_flex(
                {k: vecs[k] for k in chain[i - 1:i + 2]},
                chain[i - 1:i + 2]) * sign[i]
            flip = ~np.isclose(flex, ang[:, 1])
            ang[:, 0] += 180.0 * flip
            ang[:, 1] = np.where(flip, np.mod(-(ang[:, 1] + 180.0), 360.0),
                                 ang[:, 1])
            ang = np.mod(ang + 180.0, 360.0) - 180.0
        out[chain[i] + "_flex"] = ang[:, 1]
        if i != n - 2:
            out[chain[i] + "_rot"] = ang[:, 0]
        if i == 0:
            out[chain[i] + "_abduct"] = ang[:, 2]
    return out


def get_angles(vecs: dict, angles: dict) -> dict:
    """anipose config-style angle dispatcher
    (compute_angles.py:29-44): values are ["chain", j1, j2, ...],
    ["axis", a, b, c], ["cross-axis", a, b, c], or a plain (a, b, c)
    flexion triplet (optionally prefixed with "flex")."""
    out = {}
    for name, spec in angles.items():
        spec = list(spec)
        if spec[0] == "chain":
            out.update(angles_chain(vecs, spec[1:]))
        elif len(spec) == 4 and spec[0] == "axis":
            out[name] = angles_axis(vecs, spec[1:])
        elif len(spec) == 4 and spec[0] == "cross-axis":
            out[name] = angles_crossaxis(vecs, spec[1:])
        else:
            out[name] = angles_flex(vecs, spec[-3:])
    return out


def filter_3d_medfilt(
    kp3d: np.ndarray,
    errors: np.ndarray | None = None,
    error_threshold: float = 15.0,
    size: int = 15,
    max_nan_frac: float = 0.85,
) -> np.ndarray:
    """Median-filter 3D trajectories over time, NaN-ing high-error frames
    first (reference filter_3d.py:14-43 semantics: interpolate, medfilt
    kernel 15 with median padding, skip series that are mostly NaN).

    kp3d (..., T, J, 3) with time on axis -3."""
    from scipy import signal

    out = np.array(kp3d, float)
    if errors is not None:
        bad = np.nan_to_num(errors, nan=1e5) > error_threshold
        out[bad] = np.nan

    flat = out.reshape(-1, *out.shape[-3:])
    padsize = size + 5
    for b in range(flat.shape[0]):
        for j in range(flat.shape[-2]):
            for c in range(3):
                v = flat[b, :, j, c]
                nans = np.isnan(v)
                if nans.mean() > max_nan_frac:
                    continue
                t = np.arange(v.shape[0])
                vi = v.copy()
                vi[nans] = np.interp(t[nans], t[~nans], v[~nans])
                vp = np.pad(vi, (padsize, padsize), mode="median",
                            stat_length=5)
                flat[b, :, j, c] = signal.medfilt(vp, size)[padsize:-padsize]
    return flat.reshape(out.shape)
