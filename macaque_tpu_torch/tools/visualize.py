"""Overlay rendering: reproject kp3d into a camera and draw skeletons.

Port of ``macaque_tpu/tools/visualize.py`` (reference visualize_result.py
/ visualize_result_2.py). All frames' reprojections are computed in one
batched call (``overlay_points``), on the card unless the caller asks for
the CPU; the JAX package pins that call to the host CPU. Drawing and
mp4v encoding stay on the host with cv2, imported by the functions that
draw or encode.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from macaque_tpu_torch.cameras.omnidir import omnidir_project
from macaque_tpu_torch.cameras.rig import CameraRig
from macaque_tpu_torch.pipeline.artifacts import read_pickle
from macaque_tpu_torch.video.imgstore import ImgStoreReader

# drawn skeleton incl. synthetic neck joint 17 = mean(shoulders)
# (reference visualize_result.py:219-228 kp_con + neck)
KP_CON = [
    (0, 2), (0, 1), (2, 4), (1, 3),
    (6, 8), (5, 7), (8, 10), (7, 9),
    (12, 14), (11, 13), (14, 16), (13, 15),
    (0, 17), (17, 6), (17, 5), (17, 12), (17, 11),
]

# richer variant with torso diagonals, eyes hidden
# (visualize_result_2.py:97-126)
KP_CON_V2 = KP_CON + [(5, 12), (6, 11), (5, 11), (6, 12)]

COLORS = [(0, 0, 255), (0, 255, 0), (255, 0, 0), (255, 255, 0)]


def _ellipse_line(img, x1, x2, mrksize, clr):
    import cv2

    dx, dy = x2[0] - x1[0], x2[1] - x1[1]
    ang = 90 if dx == 0 else math.degrees(math.atan(dy / dx))
    # float center/axes: cv2 rounds the rotated rect internally, exactly
    # like the reference's ellipse_line (visualize_result.py:19-28)
    cen = ((x1[0] + x2[0]) / 2, (x1[1] + x2[1]) / 2)
    length = math.hypot(dx, dy)
    cv2.ellipse(img, (cen, (length, float(mrksize)), ang), clr, -1)


def _clean_kp(kp2d: np.ndarray) -> list:
    """Bounds/NaN check -> list of [x, y] or None (reference clean_kp)."""
    out = []
    for x, y in kp2d:
        if np.isnan(x) or not (-1000 < x < 3000) or not (-1000 < y < 3000):
            out.append(None)
        else:
            out.append([float(x), float(y)])
    return out


def draw_skeleton(img, kp, mrksize=6, clr=(0, 255, 0), kp_con=KP_CON,
                  hide_eyes=False):
    import cv2

    for idx in reversed(range(len(kp))):
        if kp[idx] is None or (hide_eyes and idx in (1, 2)):
            continue
        r = mrksize + 1 if idx in (1, 2) else mrksize
        cv2.circle(img, (int(kp[idx][0]), int(kp[idx][1])), r, clr, -1)
    for i1, i2 in kp_con:
        if i1 < len(kp) and i2 < len(kp) and kp[i1] is not None \
                and kp[i2] is not None:
            _ellipse_line(img, kp[i1], kp[i2], mrksize, clr)


def overlay_points(data: dict, rig: CameraRig, i_cam: int, device=None,
                   dtype: torch.dtype = torch.float64):
    """The reprojection half of the JAX package's ``render_overlay``
    (visualize.py:100-130): ``data``'s ``kp3d`` (A, T, J, 3) with a neck
    joint (the shoulders' mean) added, projected into camera ``i_cam`` in
    one call on ``device`` (the card when None) in ``dtype``. Returns the
    (A, T, J + 1, 2) pixels, NaN where the joint is NaN, and the (A, T)
    mask of the animals drawn in each frame."""
    kp3d = np.asarray(data["kp3d"])  # (A, T, J, 3)
    A, T, J, _ = kp3d.shape

    # add synthetic neck = mean of shoulders (kp 5, 6)
    neck = (kp3d[:, :, 5] + kp3d[:, :, 6]) / 2
    kp3d_n = np.concatenate([kp3d, neck[:, :, None, :]], axis=2)

    # reference clean_kp (show_as_possible) aggregate rule: an animal is
    # drawn in a frame only if at least one keypoint has nonzero
    # coordinates AND positive score (visualize_result.py:30-48,229-236;
    # NaN coords pass the !=0 test by numpy semantics, exactly as there)
    score = np.asarray(data.get("kp3d_score", np.ones((A, T, J))))
    neck_s = (score[:, :, 5] + score[:, :, 6]) / 2
    score_n = np.concatenate([score, neck_s[:, :, None]], axis=2)
    with np.errstate(invalid="ignore"):
        draw_any = np.sum(
            np.logical_not(kp3d_n[..., 0] == 0) & (score_n > 0.0),
            axis=2) > 0  # (A, T)

    cam = rig.subset([i_cam]).omni(device, dtype)
    p3_flat = np.nan_to_num(kp3d_n.reshape(-1, 3), nan=1e8)
    pts = torch.as_tensor(p3_flat, dtype=dtype, device=cam.K.device)
    proj = omnidir_project(cam, pts)[0].cpu().numpy().astype(np.float64)
    proj = proj.reshape(A, T, J + 1, 2)
    proj[np.isnan(kp3d_n[..., 0])] = np.nan
    return proj, draw_any


def render_overlay(
    data_name: str,
    i_cam: int,
    result_dir: str,
    raw_data_dir: str,
    rig: CameraRig,
    fps: float = 24.0,
    out_path: Optional[str] = None,
    style: str = "v1",
    mrksize: int = 6,
    colors=None,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> Optional[str]:
    """Draw the kp3d skeletons reprojected into camera ``i_cam`` over its
    recording and write ``overlay_<cam>.mp4`` (the JAX package's
    ``render_overlay``). The reprojection runs on ``device`` (the card
    when None) in ``dtype``; drawing and encoding need cv2."""
    import cv2

    kp3d_path = os.path.join(result_dir, "kp3d_fxdJointLen.pickle")
    if not os.path.exists(kp3d_path):
        kp3d_path = os.path.join(result_dir, "kp3d.pickle")
    if not os.path.exists(kp3d_path):
        print("[vis] no kp3d pickle; skipping render")
        return None
    data = read_pickle(kp3d_path)
    proj, draw_any = overlay_points(data, rig, i_cam, device, dtype)
    A, T = draw_any.shape

    cam_id = rig.camera_ids[i_cam]
    store = ImgStoreReader(
        os.path.join(raw_data_dir, f"{data_name}.{cam_id}")
    )
    fnums = np.load(os.path.join(result_dir, str(cam_id), "frame_num.npy"))
    valid = set(int(f) for f in store.get_frame_metadata()["frame_number"])

    out_path = out_path or os.path.join(
        result_dir, f"overlay_{cam_id}.mp4"
    )
    H, W = store.metadata["imgshape"][:2]
    vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                         fps, (W, H))
    kp_con = KP_CON_V2 if style == "v2" else KP_CON
    palette = COLORS if colors is None else colors
    n = min(T, len(fnums))
    for t in range(n):
        fn = int(fnums[t])
        if fn not in valid:
            continue
        img, _ = store.get_image(frame_number=fn)
        for a in range(A):
            if not draw_any[a, t]:
                continue
            kp = _clean_kp(proj[a, t])
            draw_skeleton(img, kp, mrksize, palette[a % len(palette)],
                          kp_con, hide_eyes=(style == "v2"))
        vw.write(img)
    vw.release()
    store.close()
    print(f"[vis] wrote {out_path}")
    return out_path
