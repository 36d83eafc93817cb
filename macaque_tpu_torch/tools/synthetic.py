"""Synthetic multi-camera scene generator: the host parts that feed step 2.

Port of the step-2 inputs of ``macaque_tpu/tools/synthetic.py``: an
omnidir rig in a ring around a cage, N 'macaques' as rigid 17-joint
skeletons random-walking in 3D, and per-camera ``alldata.json`` rows
derived from their projections. Every function draws the same numpy
random numbers in the same order as the JAX package's, so one seed gives
both packages the same rig and rows. Projection runs in float64 on the
CPU. (Rendering frames and the oracle perception backend are not ported
yet.)
"""

from __future__ import annotations

import numpy as np
import torch

from macaque_tpu_torch.cameras.omnidir import omnidir_project
from macaque_tpu_torch.cameras.rig import CameraRig
from macaque_tpu_torch.cameras.rotation import rodrigues_inv
from macaque_tpu_torch.core.config import VALID_COLLAR_CLASSES

IMG_W, IMG_H = 640, 480


def make_test_rig(n_cam=4, seed=0) -> CameraRig:
    """``n_cam`` omnidir cameras on a 2.8 m ring, 0.9 m up, looking at the
    centre."""
    rng = np.random.default_rng(seed)
    K = np.zeros((n_cam, 3, 3))
    K[:, 0, 0] = 260 + rng.uniform(-10, 10, n_cam)
    K[:, 1, 1] = 262 + rng.uniform(-10, 10, n_cam)
    K[:, 0, 2] = IMG_W / 2
    K[:, 1, 2] = IMG_H / 2
    K[:, 2, 2] = 1.0
    xi = 1.0 + rng.uniform(-0.05, 0.05, n_cam)
    D = rng.uniform(-0.02, 0.02, (n_cam, 4))
    Rs, tvecs, mtx = [], [], []
    for i in range(n_cam):
        ang = 2 * np.pi * i / n_cam
        pos = np.array([2800 * np.cos(ang), 2800 * np.sin(ang), 900.0])
        z = -pos / np.linalg.norm(pos)
        up = np.array([0.0, 0.0, -1.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        Rs.append(R)
        tvecs.append(-R @ pos)
        mtx.append(K[i] * 2)  # auxiliary pinhole intrinsics
    rvecs = rodrigues_inv(torch.from_numpy(np.stack(Rs))).numpy()
    return CameraRig(
        camera_ids=[f"{10000 + i}" for i in range(n_cam)],
        K=K, xi=xi, D=D,
        rvec=rvecs, tvec=np.stack(tvecs),
        mtx=np.stack(mtx), dist=np.zeros((n_cam, 5)),
        size=(IMG_W, IMG_H),
    )


def make_skeleton_offsets(rng) -> np.ndarray:
    """17-joint 'macaque' offsets (mm), loosely body-shaped."""
    base = np.array([
        [0, 0, 160],      # nose
        [-25, 0, 175], [25, 0, 175],     # eyes
        [-55, 0, 165], [55, 0, 165],     # ears
        [-90, 0, 80], [90, 0, 80],       # shoulders
        [-120, 0, 0], [120, 0, 0],       # elbows
        [-130, 0, -80], [130, 0, -80],   # wrists
        [-70, -160, 0], [70, -160, 0],   # hips
        [-90, -160, -90], [90, -160, -90],   # knees
        [-95, -160, -175], [95, -160, -175],  # ankles
    ], float)
    return base + rng.normal(0, 5, base.shape)


def simulate_scene(n_animal=2, n_frame=120, seed=0):
    """Ground-truth 3D joints (A, T, 17, 3), well-separated random walks."""
    rng = np.random.default_rng(seed)
    offsets = np.stack([make_skeleton_offsets(rng) for _ in range(n_animal)])
    starts = np.array([
        [600.0, 0.0, 400.0], [-600.0, 100.0, 500.0],
        [0.0, 650.0, 450.0], [50.0, -600.0, 350.0],
    ])[:n_animal]
    steps = rng.normal(0, 6.0, (n_animal, n_frame, 3))
    centers = starts[:, None, :] + np.cumsum(steps, axis=1)
    return centers[:, :, None, :] + offsets[:, None, :, :]


def project_scene(rig: CameraRig, kp3d: np.ndarray) -> np.ndarray:
    """(A, T, J, 3) -> (C, A, T, J, 2) pixel projections (float64, CPU)."""
    A, T, J, _ = kp3d.shape
    cam = rig.omni("cpu", torch.float64)
    proj = omnidir_project(cam, torch.from_numpy(kp3d.reshape(-1, 3)))
    return proj.numpy().reshape(rig.n_cam, A, T, J, 2)


def synthesize_alldata(rig, kp3d, seed=0):
    """Synthetic per-camera alldata in the reference's row schema
    [track_id, x1,y1,x2,y2, [[x,y,s]x17], cid, cid_score] (step1:353-359),
    with dropped detections, sub-threshold keypoints, a ghost duplicate
    detection, and occasional unknown collar reads."""
    rng = np.random.default_rng(seed)
    A, T, J, _ = kp3d.shape
    proj = project_scene(rig, kp3d)
    collars = [int(VALID_COLLAR_CLASSES[a]) for a in range(A)]

    percam = []
    for c in range(rig.n_cam):
        frames = []
        for t in range(T):
            dets = []
            for a in range(A):
                if rng.random() < 0.03:  # missed detection
                    continue
                pts = proj[c, a, t] + rng.normal(0, 0.4, (J, 2))
                scores = np.clip(rng.normal(0.9, 0.05, J), 0, 1)
                # a few keypoints drop below THR_KP
                low = rng.random(J) < 0.05
                scores[low] = 0.05
                x1, y1 = pts.min(axis=0) - 5
                x2, y2 = pts.max(axis=0) + 5
                kp = [[float(x), float(y), float(s)]
                      for (x, y), s in zip(pts, scores)]
                cid = collars[a] if rng.random() > 0.1 else 4  # 4=unknown
                cs = float(np.clip(rng.normal(0.92, 0.04), 0, 1))
                dets.append([a + 1, float(x1), float(y1), float(x2),
                             float(y2), kp, int(cid), cs])
                if c == 0 and a == 0 and 30 <= t < 60 and rng.random() < 0.5:
                    # ghost duplicate near animal 0 (exercises best-comb)
                    pts2 = pts + rng.normal(20, 4, 2)
                    kp2 = [[float(x), float(y), float(s)]
                           for (x, y), s in zip(pts2, scores)]
                    dets.append([A + 7, float(pts2[:, 0].min() - 5),
                                 float(pts2[:, 1].min() - 5),
                                 float(pts2[:, 0].max() + 5),
                                 float(pts2[:, 1].max() + 5), kp2, 4, 0.2])
            frames.append(dets)
        percam.append(frames)
    return percam
