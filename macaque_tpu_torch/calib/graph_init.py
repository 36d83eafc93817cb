"""Initial multi-camera extrinsics from shared board detections.

Equivalent of aniposelib's camera-graph initialization
(src/third_party/aniposelib/utils.py:105-190): cameras are nodes, edges
weighted by the number of views in which both cameras see the board;
relative poses are averaged over shared views with outlier rejection,
then propagated over a maximum spanning tree from camera 0.

Port of ``macaque_tpu/calib/graph_init.py``: host code on numpy, with the
Rodrigues maps of ``cameras/rotation.py`` on float64 CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from macaque_tpu_torch.cameras.rotation import rodrigues, rodrigues_inv


def _f64(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64))


def make_M(rvec: np.ndarray, tvec: np.ndarray) -> np.ndarray:
    M = np.eye(4)
    M[:3, :3] = rodrigues(_f64(rvec)).numpy()
    M[:3, 3] = np.asarray(tvec).ravel()
    return M


def get_rtvec(M: np.ndarray):
    rvec = rodrigues_inv(_f64(M[:3, :3])).numpy()
    return rvec, M[:3, 3].copy()


def compose_rtvecs(rvec1, tvec1, rvec2, tvec2, inv: bool = False):
    """Compose two rvec/tvec extrinsics: ``M1 @ M2`` (``inv`` inverts M1
    first). Reference ``multicam_toolbox.applytransform``
    (src/utils/multicam_toolbox.py:922-940); returns (rvec (3,),
    tvec (3, 1)) in the reference's column-vector layout."""
    M1 = make_M(np.asarray(rvec1).ravel(), tvec1)
    M2 = make_M(np.asarray(rvec2).ravel(), tvec2)
    if inv:
        M1 = np.linalg.pinv(M1)
    rvec, tvec = get_rtvec(M1 @ M2)
    return rvec.reshape(3), tvec.reshape(3, 1)


def mean_transform(Ms: Sequence[np.ndarray], reject_sigma: float = 2.0):
    """Robust average of SE(3) transforms: mean rvec/tvec with one round
    of sigma-based outlier rejection (aniposelib utils:41-60 behaviour)."""
    rv = np.stack([get_rtvec(M)[0] for M in Ms])
    tv = np.stack([get_rtvec(M)[1] for M in Ms])
    if len(Ms) > 2:
        med_r = np.median(rv, axis=0)
        med_t = np.median(tv, axis=0)
        dr = np.linalg.norm(rv - med_r, axis=1)
        dt = np.linalg.norm(tv - med_t, axis=1)
        keep = (dr < dr.mean() + reject_sigma * dr.std() + 1e-9) & (
            dt < dt.mean() + reject_sigma * dt.std() + 1e-9
        )
        if keep.sum() >= 2:
            rv, tv = rv[keep], tv[keep]
    return make_M(rv.mean(axis=0), tv.mean(axis=0))


def initial_extrinsics_from_board_poses(
    board_poses: Sequence[Sequence[Optional[tuple]]],
):
    """board_poses[cam][view] = (rvec, tvec) of the board in that camera's
    frame, or None if undetected. Returns (rvecs (C,3), tvecs (C,3)) with
    camera 0 as the world frame."""
    C = len(board_poses)
    V = len(board_poses[0])

    # pairwise relative transforms M_ij: cam_j -> cam_i
    rel: dict[tuple, np.ndarray] = {}
    weight = np.zeros((C, C), int)
    for i in range(C):
        for j in range(C):
            if i == j:
                continue
            Ms = []
            for v in range(V):
                pi = board_poses[i][v]
                pj = board_poses[j][v]
                if pi is None or pj is None:
                    continue
                Mi = make_M(*pi)
                Mj = make_M(*pj)
                Ms.append(Mi @ np.linalg.inv(Mj))
            if Ms:
                rel[(i, j)] = mean_transform(Ms)
                weight[i, j] = len(Ms)

    # maximum spanning tree from camera 0 (Prim)
    extr = {0: np.eye(4)}
    visited = {0}
    while len(visited) < C:
        best = None
        for i in visited:
            for j in range(C):
                if j in visited or weight[j, i] == 0:
                    continue
                if best is None or weight[j, i] > best[2]:
                    best = (i, j, weight[j, i])
        if best is None:
            raise ValueError(
                "camera graph is disconnected: cameras "
                f"{sorted(set(range(C)) - visited)} share no views"
            )
        i, j, _ = best
        # board->cam_j = M_ji @ board->cam_i; world frame = cam 0
        extr[j] = rel[(j, i)] @ extr[i]
        visited.add(j)

    rvecs = np.zeros((C, 3))
    tvecs = np.zeros((C, 3))
    for c in range(C):
        rvecs[c], tvecs[c] = get_rtvec(extr[c])
    return rvecs, tvecs
