"""Synthetic multi-camera scene generator for end-to-end pipeline runs.

Port of ``macaque_tpu/tools/synthetic.py``: an omnidir rig in a ring
around a cage, N 'macaques' as rigid 17-joint skeletons random-walking in
3D, minimal frames (coloured body boxes) written as imgstore recordings,
a ``SyntheticPerception`` backend that emits detections/poses/IDs from
the ground-truth projections (with optional noise), so the whole
tracking/matching/3D stack runs end to end without network weights, and
per-camera ``alldata.json`` rows for step 2 alone. Every function draws
the same numpy random numbers in the same order as the JAX package's, so
one seed gives both packages the same rig, frames, detections and rows.
Projection runs in float64 on the CPU.

The frame index is encoded losslessly into each frame (8x8 binary blocks)
so the perception oracle stays order-independent.
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


def encode_index(img: np.ndarray, idx: int) -> None:
    """16 binary 8x8 blocks along the top edge encode the frame index."""
    for bit in range(16):
        v = 255 if (idx >> bit) & 1 else 0
        img[0:8, 8 * bit : 8 * (bit + 1)] = v


def decode_index(img: np.ndarray) -> int:
    idx = 0
    for bit in range(16):
        if img[0:8, 8 * bit : 8 * (bit + 1)].mean() > 127:
            idx |= 1 << bit
    return idx


def draw_frames(proj: np.ndarray, c: int) -> np.ndarray:
    """Camera ``c``'s (T, IMG_H, IMG_W, 3) BGR frames of ``render_stores``:
    grey, each animal's projected joints' bounding box filled in its
    colour, the frame index in the top edge. The JAX package's filled
    ``cv2.rectangle`` is NumPy slicing here (corners truncated by
    ``int()``, both inclusive, clipped to the image): the same bits."""
    colors = [(255, 64, 64), (64, 255, 64), (64, 64, 255), (255, 255, 64)]
    _, A, T, J, _ = proj.shape
    frames = np.zeros((T, IMG_H, IMG_W, 3), np.uint8)
    for t in range(T):
        img = frames[t]
        img[:] = 30
        for a in range(A):
            pts = proj[c, a, t]
            ok = np.isfinite(pts).all(axis=1)
            if ok.sum() < 3:
                continue
            x1, y1 = pts[ok].min(axis=0)
            x2, y2 = pts[ok].max(axis=0)
            x1, y1, x2, y2 = int(x1), int(y1), int(x2), int(y2)
            img[max(y1, 0):max(y2 + 1, 0),
                max(x1, 0):max(x2 + 1, 0)] = colors[a % 4]
        encode_index(img, t)
    return frames


def render_stores(
    root: str, data_name: str, rig: CameraRig, proj: np.ndarray,
    fps: float = 24.0, fourcc: str = "FFV1", chunksize: int = 10000,
):
    """Write one imgstore per camera of ``draw_frames``' frames (the JAX
    package's ``render_stores``).

    ``fourcc``/``chunksize`` select the store flavor: the FFV1 default
    is the lossless test fixture (cv2 encodes it); ``fourcc='RGBA'``
    writes uncompressed chunks without cv2; ``fourcc='mp4v',
    chunksize=<T`` makes multi-chunk VideoImgStoreFFMPEG-layout stores
    like the reference's production recordings
    (videos/example.22972495/metadata.yaml)."""
    import os

    from macaque_tpu_torch.video.imgstore import write_imgstore

    for c in range(proj.shape[0]):
        write_imgstore(
            os.path.join(root, f"{data_name}.{rig.camera_ids[c]}"),
            draw_frames(proj, c), fps=fps, fourcc=fourcc,
            chunksize=chunksize,
        )


class SyntheticPerception:
    """Oracle backend: detections/poses/IDs from ground-truth projections
    with Gaussian noise; per-camera instance (factory pattern). The JAX
    package's ``SyntheticPerception``, drawing from the same
    ``default_rng(seed + cam_index)`` in the same order."""

    def __init__(self, cam_index: int, proj: np.ndarray, noise=1.0,
                 max_det=8, seed=0, id_classes=None, drop_prob=0.0):
        self.cam = cam_index
        self.proj = proj  # (C, A, T, J, 2)
        self.noise = noise
        self.max_det = max_det
        self.rng = np.random.default_rng(seed + cam_index)
        A = proj.shape[1]
        self.id_classes = id_classes or [
            VALID_COLLAR_CLASSES[a % 4] for a in range(A)
        ]
        self.drop_prob = drop_prob

    def _gt(self, frames):
        idx = [decode_index(f) for f in frames]
        return np.asarray(idx)

    def detect(self, frames_bgr):
        ts = self._gt(frames_bgr)
        B = len(ts)
        D = self.max_det
        boxes = np.zeros((B, D, 4), np.float32)
        scores = np.zeros((B, D), np.float32)
        A = self.proj.shape[1]
        for bi, t in enumerate(ts):
            k = 0
            for a in range(A):
                if self.rng.uniform() < self.drop_prob:
                    continue
                pts = self.proj[self.cam, a, t]
                ok = np.isfinite(pts).all(axis=1)
                if ok.sum() < 3:
                    continue
                x1, y1 = pts[ok].min(axis=0) - 6
                x2, y2 = pts[ok].max(axis=0) + 6
                if x2 < 0 or y2 < 0 or x1 > IMG_W or y1 > IMG_H:
                    continue
                boxes[bi, k] = [x1, y1, x2, y2]
                scores[bi, k] = self.rng.uniform(0.9, 0.99)
                k += 1
        return boxes, scores

    def _match_animal(self, t, box):
        """Identify which animal a tracked box corresponds to (by centre)."""
        cx = (box[0] + box[2]) / 2
        cy = (box[1] + box[3]) / 2
        best, bd = -1, 1e18
        for a in range(self.proj.shape[1]):
            pts = self.proj[self.cam, a, t]
            ok = np.isfinite(pts).all(axis=1)
            if ok.sum() < 3:
                continue
            c = pts[ok].mean(axis=0)
            d = (c[0] - cx) ** 2 + (c[1] - cy) ** 2
            if d < bd:
                bd, best = d, a
        return best

    def pose(self, frames_bgr, boxes, valid):
        ts = self._gt(frames_bgr)
        B, D = valid.shape
        J = self.proj.shape[3]
        out = np.full((B, D, J, 3), np.nan)
        for bi, t in enumerate(ts):
            for k in range(D):
                if not valid[bi, k]:
                    continue
                a = self._match_animal(t, boxes[bi, k])
                if a < 0:
                    continue
                pts = self.proj[self.cam, a, t]
                out[bi, k, :, :2] = pts + self.rng.normal(
                    0, self.noise, pts.shape
                )
                out[bi, k, :, 2] = self.rng.uniform(0.75, 0.99, J)
        return out

    def classify(self, frames_bgr, boxes, valid):
        ts = self._gt(frames_bgr)
        B, D = valid.shape
        labels = np.full((B, D), -1, int)
        scores = np.zeros((B, D))
        for bi, t in enumerate(ts):
            for k in range(D):
                if not valid[bi, k]:
                    continue
                a = self._match_animal(t, boxes[bi, k])
                if a < 0:
                    continue
                labels[bi, k] = self.id_classes[a]
                scores[bi, k] = self.rng.uniform(0.9, 0.99)
        return labels, scores


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
