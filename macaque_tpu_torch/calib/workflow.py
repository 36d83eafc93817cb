"""Calibration-from-video drivers: recorded board/marker videos -> a
calibrated multi-camera rig, using the reference's file protocol.

Replaces the reference's driver layer (src/utils/multicam_toolbox.py):

  * ``analyze_chessboard_videos``  <- ``analyze_chessboardvid`` (:22-72)
  * ``calibrate_intrinsics_driver`` <- ``calibrate_intrinsic`` (:74-116)
  * ``get_extrinsics_from_cage_keypoints`` <-
    ``get_extrinsic_from_cagekeypoints`` (:213-242)
  * ``analyze_aruco_marker_videos`` <- ``analyze_aruco_marker_vid``
    (:244-305)
  * ``analyze_aruco_cube_videos`` <- ``analyze_aruco_cube_vid`` (:307-391)
  * ``optimize_extrinsics_driver`` <- ``optimize_extrinsic`` (:488-636)
  * ``optimize_all_camera_params_driver`` <-
    ``optimize_all_camera_params`` (:638-824)
  * ``fix_extrinsic_optim`` <- ``fix_extrinsic_optim`` (:942-975,
    shipped commented-out in the reference)
  * ``extract_frames_for_3dannotation`` <- (:826-918)

File protocol (all next to config.yaml, reference layouts):
  chessboard_points.h5   /<id>/{imp, objp}
  cam_intrinsic.h5       /<id>/{mtx, dist, K, xi, D}
  cagepoints_annotation.h5  /<id> -> (n_kp, 6) [flag, x, y, X, Y, Z]
  cam_extrinsic.h5       /<id>/{rvec, tvec}
  marker_trace.h5        /<id> -> (n_frame, 2), -1 = missing
  cam_extrinsic_optim.h5 /<id>/{rvec, tvec}
  cam_intrinsic_optim.h5 /<id>/{mtx, dist, K, xi, D}

Board/marker *detection* is host OpenCV; every solver is the LM-CGLS
engine (calib/bundle.py) — no cv2.omnidir, no scipy sparse TRF.

Port of ``macaque_tpu/calib/workflow.py``, with the same file protocol,
dataset names, shapes and dtypes. ``yaml``, ``h5py`` and ``cv2`` are
imported by the functions that read or detect, so the module imports where
they are missing. The drivers that run a solver or the DLT take ``device``
(the card when None) and ``dtype`` (float32) last.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
from typing import Optional, Sequence

import numpy as np
import torch

from macaque_tpu_torch.calib.videos import Checkerboard, detect_board_video


# --------------------------------------------------------------------------
# config + small helpers
# --------------------------------------------------------------------------


def load_calib_config(config_path: str):
    import yaml

    with open(config_path) as f:
        cfg = yaml.safe_load(f)
    return cfg, os.path.dirname(os.path.abspath(config_path))


def _cam_video(vid_dir: str, cam_id: str) -> str:
    """Find the one recording for a camera inside a folder: an mp4 file
    or an imgstore directory (reference globs ``<id>*.mp4`` mct:42 and
    ``*<id>*/metadata.yaml`` mct:259,322)."""
    pats = [
        os.path.join(vid_dir, f"{cam_id}*.mp4"),
        os.path.join(vid_dir, f"*{cam_id}*.mp4"),
        os.path.join(vid_dir, f"*{cam_id}*", "metadata.yaml"),
        os.path.join(vid_dir, f"*{cam_id}*", "*.mp4"),
    ]
    for pat in pats:
        hits = sorted(glob.glob(pat))
        if hits:
            return hits[0]
    raise FileNotFoundError(
        f"no video for camera {cam_id} under {vid_dir}")


def rodrigues_np(rvec: np.ndarray) -> np.ndarray:
    from macaque_tpu_torch.cameras.rotation import rodrigues

    return rodrigues(torch.from_numpy(
        np.asarray(rvec, np.float64).ravel().copy())).numpy()


def camera_position(rvec: np.ndarray, tvec: np.ndarray) -> np.ndarray:
    """World-frame camera center: -R^T t (reference mct:239-242)."""
    R = rodrigues_np(rvec)
    return (-R.T @ np.asarray(tvec, float).reshape(3, 1)).ravel()


# --------------------------------------------------------------------------
# step 1: chessboard detection -> chessboard_points.h5
# --------------------------------------------------------------------------


def analyze_chessboard_videos(
    config_path: str,
    frame_intv: int = 5,
    board: Optional[Checkerboard] = None,
    verbose: bool = True,
) -> str:
    """Detect chessboard corners in each camera's board video and store
    per-view image/object points (reference mct:22-72; 9x6 corners at
    ``chessboard_square_size``). Returns the h5 path."""
    import h5py

    cfg, base = load_calib_config(config_path)
    if board is None:
        board = Checkerboard(9, 6, float(cfg.get(
            "chessboard_square_size", 1.0)))
    vid_dir = os.path.join(base, cfg["chessboard_vid_folder"])
    out = os.path.join(base, "chessboard_points.h5")

    objp = board.object_points()
    with h5py.File(out, "w") as h5:
        for cam_id in cfg["camera_id"]:
            vf = _cam_video(vid_dir, str(cam_id))
            rows = detect_board_video(vf, board, skip=frame_intv)
            # full-board detections only (plain chessboards are
            # all-or-nothing, reference mct:59-63)
            imp = np.stack([r["filled"] for r in rows]) if rows \
                else np.zeros((0, board.n_points, 2))
            if verbose:
                print(f"{cam_id}: {len(imp)} board views")
            h5.create_dataset(f"/{cam_id}/imp",
                              data=imp[:, :, None, :])  # (V, N, 1, 2)
            h5.create_dataset(f"/{cam_id}/objp",
                              data=np.tile(objp, (len(imp), 1, 1)))
    return out


# --------------------------------------------------------------------------
# step 2: intrinsic calibration -> cam_intrinsic.h5
# --------------------------------------------------------------------------


def calibrate_intrinsics_driver(
    config_path: str,
    mtx_init: Optional[np.ndarray] = None,
    dist_init: Optional[np.ndarray] = None,
    verbose: bool = True,
    device=None,
    dtype=torch.float32,
) -> str:
    """Per-camera intrinsics from detected board views (reference
    mct:74-116): pinhole ``mtx``/``dist`` via cv2.calibrateCamera (host)
    plus the omnidir (Mei) ``K``/``xi``/``D`` via the LM fit —
    replacing ``cv2.omnidir.calibrate``, which this OpenCV build lacks.
    Per-view poses are initialized by PnP under the pinhole model."""
    import cv2
    import h5py

    from macaque_tpu_torch.calib.bundle import calibrate_intrinsics_omnidir

    cfg, base = load_calib_config(config_path)
    imsize = tuple(int(v) for v in cfg["img_size"])
    pts_path = os.path.join(base, "chessboard_points.h5")
    out = os.path.join(base, "cam_intrinsic.h5")

    with h5py.File(out, "w") as h5o, h5py.File(pts_path, "r") as h5i:
        for cam_id in cfg["camera_id"]:
            imp = np.asarray(h5i[f"/{cam_id}/imp"])    # (V, N, 1, 2)
            objp = np.asarray(h5i[f"/{cam_id}/objp"])  # (V, N, 3)
            V = imp.shape[0]
            if V < 3:
                raise ValueError(
                    f"camera {cam_id}: only {V} board views — need >= 3")

            imp32 = [imp[v].astype(np.float32) for v in range(V)]
            obj32 = [objp[v].reshape(-1, 1, 3).astype(np.float32)
                     for v in range(V)]
            ret, mtx, dist, rvecs, tvecs = cv2.calibrateCamera(
                obj32, imp32, imsize, mtx_init, dist_init)

            K, xi, D, _, _, rms = calibrate_intrinsics_omnidir(
                objp, imp.reshape(V, -1, 2),
                init_f=float(mtx[0, 0]),
                init_c=(float(mtx[0, 2]), float(mtx[1, 2])),
                img_size=imsize,
                init_rvecs=np.stack([r.ravel() for r in rvecs]),
                init_tvecs=np.stack([t.ravel() for t in tvecs]),
                device=device, dtype=dtype,
            )
            if verbose:
                print(f"{cam_id}: pinhole rms {ret:.3f} px, "
                      f"omnidir rms {rms:.3f} px ({V} views)")

            h5o.create_dataset(f"/{cam_id}/mtx", data=mtx)
            h5o.create_dataset(f"/{cam_id}/dist", data=dist)
            h5o.create_dataset(f"/{cam_id}/K", data=K)
            h5o.create_dataset(f"/{cam_id}/xi",
                               data=np.array([[xi]]))
            h5o.create_dataset(f"/{cam_id}/D",
                               data=np.asarray(D).reshape(1, 4))
    return out


# --------------------------------------------------------------------------
# step 3: initial extrinsics from labeled cage keypoints
# --------------------------------------------------------------------------


def save_cage_annotations(config_path: str, data: dict) -> str:
    """Write ``cagepoints_annotation.h5`` (``/<id>`` -> (n_kp, 6) rows of
    [flag, x_640, y_480, X, Y, Z]). Programmatic stand-in for the
    reference's interactive labeling GUI (mct:118-211 ``label_
    cagekeypoints``) — annotations come from any labeling tool."""
    import h5py

    _, base = load_calib_config(config_path)
    path = os.path.join(base, "cagepoints_annotation.h5")
    with h5py.File(path, "w") as f:
        for k, v in data.items():
            f.create_dataset(f"/{k}", data=np.asarray(v, float))
    return path


def get_extrinsics_from_cage_keypoints(
    config_path: str, verbose: bool = True,
) -> str:
    """Initial camera poses by PnP on labeled cage keypoints (reference
    mct:213-242). Annotation pixel coordinates are stored at 640-wide
    display scale and scaled back up by img_size/640."""
    import cv2
    import h5py

    cfg, base = load_calib_config(config_path)
    imsize = tuple(int(v) for v in cfg["img_size"])
    out = os.path.join(base, "cam_extrinsic.h5")

    with h5py.File(os.path.join(base, "cagepoints_annotation.h5"),
                   "r") as f_cage, \
         h5py.File(os.path.join(base, "cam_intrinsic.h5"), "r") as f_in, \
         h5py.File(out, "w") as f_ex:
        for cam_id in cfg["camera_id"]:
            mtx = np.asarray(f_in[f"/{cam_id}/mtx"])
            dist = np.asarray(f_in[f"/{cam_id}/dist"])
            cp = np.asarray(f_cage[f"/{cam_id}"])
            cp = cp[cp[:, 0] > 0, 1:]
            imgp = cp[:, 0:2] * imsize[0] / 640.0
            objp = cp[:, 2:]
            ok, rvec, tvec = cv2.solvePnP(
                np.ascontiguousarray(objp.reshape(-1, 1, 3)),
                np.ascontiguousarray(imgp.reshape(-1, 1, 2)),
                mtx, np.asarray(dist, float).ravel())
            if not ok:
                raise RuntimeError(f"solvePnP failed for camera {cam_id}")
            f_ex.create_dataset(f"/{cam_id}/rvec", data=rvec)
            f_ex.create_dataset(f"/{cam_id}/tvec", data=tvec)
            if verbose:
                print(f"3D pos of camera {cam_id}:",
                      camera_position(rvec, tvec))
    return out


# --------------------------------------------------------------------------
# step 4: aruco marker traces -> marker_trace.h5
# --------------------------------------------------------------------------


def _aruco_detector(dict_id: Optional[int] = None):
    import cv2

    aruco = cv2.aruco
    dictionary = aruco.getPredefinedDictionary(
        dict_id if dict_id is not None else aruco.DICT_4X4_50)
    return aruco.ArucoDetector(dictionary)


def marker_pose_pnp(corner: np.ndarray, marker_len: float,
                    mtx: np.ndarray, dist: np.ndarray):
    """Single-marker pose via planar PnP on its 4 corners (replaces the
    removed ``aruco.estimatePoseSingleMarkers``; same object-point
    convention: marker centered at origin in its own plane)."""
    import cv2

    h = marker_len / 2.0
    obj = np.array([[-h, h, 0], [h, h, 0], [h, -h, 0], [-h, -h, 0]],
                   np.float64)
    flags = getattr(cv2, "SOLVEPNP_IPPE_SQUARE", 0)
    ok, rvec, tvec = cv2.solvePnP(
        obj.reshape(-1, 1, 3),
        np.asarray(corner, np.float64).reshape(-1, 1, 2),
        np.asarray(mtx, np.float64),
        np.asarray(dist, np.float64).ravel(), flags=flags)
    if not ok:
        return None
    return rvec.ravel(), tvec.ravel()


def _trace_marker_video(frames, mtx, dist, marker_len,
                        center_offset=None, detector=None,
                        downscale_w: int = 640,
                        gate_px: Optional[float] = None):
    """Core of both aruco analyzers: detect markers per frame (at 640-wide
    downscale, reference mct:269-283), estimate each marker's pose at
    full resolution, project ``center_offset`` (origin for flat markers,
    cube center for the calibration cube) and return the (F, 2) pixel
    trace with [-1, -1] where undetected."""
    import cv2

    det = detector if detector is not None else _aruco_detector()
    trace = []
    for frame in frames:
        ratio = frame.shape[1] / downscale_w
        small = cv2.resize(
            frame, (downscale_w, int(frame.shape[0] / ratio)))
        gray = cv2.cvtColor(small, cv2.COLOR_BGR2GRAY) \
            if small.ndim == 3 else small
        corners, ids, _ = det.detectMarkers(gray)
        pt = [-1.0, -1.0]
        if ids is not None and len(ids) > 0:
            offset = np.zeros((1, 3)) if center_offset is None \
                else np.asarray(center_offset, float).reshape(1, 3)
            hits = []
            for corner in corners:
                pose = marker_pose_pnp(
                    np.asarray(corner).reshape(4, 2) * ratio,
                    marker_len, mtx, dist)
                if pose is None:
                    continue
                rvec, tvec = pose
                R = rodrigues_np(rvec)
                p3 = (R @ offset.T).T + tvec  # (1, 3) camera frame
                if p3[0, 2] <= 0:
                    continue
                uv = (np.asarray(mtx, float) @ (p3.T / p3[0, 2])).T[0, :2]
                if gate_px is not None:
                    mc = np.asarray(corner).reshape(4, 2).mean(0) * ratio
                    if np.linalg.norm(uv - mc) > gate_px:
                        continue  # cube-center sanity gate (mct:369-372)
                hits.append(uv)
            if hits:
                pt = list(np.mean(np.stack(hits), axis=0))
        trace.append(pt)
    return np.asarray(trace, np.float64)


def analyze_aruco_marker_videos(config_path: str,
                                verbose: bool = True) -> str:
    """Flat aruco marker trace per camera (reference mct:244-305): every
    frame, detect the marker, estimate pose with the pinhole intrinsics,
    record the projected marker origin."""
    import h5py

    from macaque_tpu_torch.calib.videos import iter_video_frames

    cfg, base = load_calib_config(config_path)
    marker_len = float(cfg["marker_size"])
    vid_dir = os.path.join(base, cfg["marker_vid_folder"])
    out = os.path.join(base, "marker_trace.h5")

    with h5py.File(out, "w") as f_tr, \
         h5py.File(os.path.join(base, "cam_intrinsic.h5"), "r") as f_in:
        for cam_id in cfg["camera_id"]:
            vf = _cam_video(vid_dir, str(cam_id))
            mtx = np.asarray(f_in[f"/{cam_id}/mtx"])
            dist = np.asarray(f_in[f"/{cam_id}/dist"])
            frames = (img for _, img in iter_video_frames(vf))
            C = _trace_marker_video(frames, mtx, dist, marker_len)
            if verbose:
                n = int((C[:, 0] >= 0).sum())
                print(f"{cam_id}: {n}/{len(C)} frames with marker")
            f_tr.create_dataset(f"/{cam_id}", data=C)
    return out


def analyze_aruco_cube_videos(config_path: str, frame_intv: int = 5,
                              fps: float = 24.0,
                              verbose: bool = True) -> str:
    """Calibration-cube trace per camera over PTP-synchronized imgstores
    (reference mct:307-391): sample a common time grid, detect every
    visible face marker, project each face's estimate of the cube
    center, gate outliers, average."""
    import h5py

    from macaque_tpu_torch.video.imgstore import ImgStoreReader

    cfg, base = load_calib_config(config_path)
    marker_len = float(cfg["marker_size"])
    cube_len = float(cfg["cube_size"])
    offset = np.array([[0.0, 0.0, -cube_len / 2]])
    vid_dir = os.path.join(base, cfg["marker_vid_folder"])
    out = os.path.join(base, "marker_trace.h5")

    ids = [str(c) for c in cfg["camera_id"]]
    stores = [ImgStoreReader(_cam_video(vid_dir, cid)) for cid in ids]
    t0 = stores[0].get_frame_metadata()["frame_time"][0]
    duration = len(stores[0]) / fps
    # skip 5 s at both ends (reference mct:328-329)
    grid = np.arange(int(fps * 5), int(duration * fps) - int(fps * 5),
                     frame_intv) / fps + t0

    try:
        with h5py.File(out, "w") as f_tr, \
             h5py.File(os.path.join(base, "cam_intrinsic.h5"),
                       "r") as f_in:
            for cid, store in zip(ids, stores):
                mtx = np.asarray(f_in[f"/{cid}/mtx"])
                dist = np.asarray(f_in[f"/{cid}/dist"])
                frames = (store.get_nearest_image(t)[0] for t in grid)
                C = _trace_marker_video(
                    frames, mtx, dist, marker_len, center_offset=offset,
                    gate_px=mtx[0, 2] / 8)  # ~w/16 gate like mct:369
                if verbose:
                    n = int((C[:, 0] >= 0).sum())
                    print(f"{cid}: {n}/{len(C)} grid frames with cube")
                f_tr.create_dataset(f"/{cid}", data=C)
    finally:
        for s in stores:
            s.close()
    return out


# --------------------------------------------------------------------------
# step 5: bundle adjustment -> cam_extrinsic_optim.h5 (+intrinsic_optim)
# --------------------------------------------------------------------------


def _load_marker_problem(base: str, ids: Sequence[str]):
    """marker_trace.h5 + calib h5s -> (obs (C, F, 2) NaN-masked pixels,
    rig arrays). Mirrors the reference's frame_use construction
    (mct:501-528) including dropping the last 5 frames."""
    import h5py

    with h5py.File(os.path.join(base, "marker_trace.h5"), "r") as f:
        pos = [np.asarray(f[f"/{cid}"]) for cid in ids]
    F = min(p.shape[0] for p in pos) - 5
    obs = np.stack([p[:F].astype(float) for p in pos])  # (C, F, 2)
    obs[obs[..., 0] < 0] = np.nan

    K = np.zeros((len(ids), 3, 3))
    xi = np.zeros(len(ids))
    D = np.zeros((len(ids), 4))
    rvec = np.zeros((len(ids), 3))
    tvec = np.zeros((len(ids), 3))
    with h5py.File(os.path.join(base, "cam_intrinsic.h5"), "r") as f_in, \
         h5py.File(os.path.join(base, "cam_extrinsic.h5"), "r") as f_ex:
        for i, cid in enumerate(ids):
            K[i] = np.asarray(f_in[f"/{cid}/K"])
            xi[i] = np.asarray(f_in[f"/{cid}/xi"]).ravel()[0]
            D[i] = np.asarray(f_in[f"/{cid}/D"]).ravel()[:4]
            rvec[i] = np.asarray(f_ex[f"/{cid}/rvec"]).ravel()
            tvec[i] = np.asarray(f_ex[f"/{cid}/tvec"]).ravel()
    return obs, K, xi, D, rvec, tvec


def _triangulate_trace(obs, K, xi, D, rvec, tvec, device=None,
                       dtype=torch.float32):
    """DLT-triangulate the marker trace (>=2 cameras) with the current
    calibration — the BA structure init (reference mct:511) — on
    ``device`` in ``dtype``."""
    from macaque_tpu_torch.cameras.omnidir import omnidir_undistort
    from macaque_tpu_torch.cameras.rig import CameraRig
    from macaque_tpu_torch.geometry.triangulate import triangulate_dlt

    rig = CameraRig(camera_ids=[str(i) for i in range(len(K))],
                    K=K, xi=xi, D=D, rvec=rvec, tvec=tvec)
    cam = rig.omni(device, dtype)
    dev = cam.K.device
    und = omnidir_undistort(cam, torch.as_tensor(
        np.nan_to_num(obs), dtype=dtype, device=dev))
    mask = ~np.isnan(obs[..., 0])  # (C, F)
    pts = triangulate_dlt(
        und.transpose(0, 1),
        torch.as_tensor(rig.pmat(), dtype=dtype, device=dev),
        torch.as_tensor(mask.T, device=dev)).to("cpu", torch.float64).numpy()
    pts[mask.sum(0) < 2] = np.nan
    return pts  # (F, 3)


def optimize_extrinsics_driver(
    config_path: str, fix_cam0: bool = True, verbose: bool = True,
    device=None, dtype=torch.float32,
) -> str:
    """6-parameter-per-camera bundle adjustment of the marker trace
    (reference ``optimize_extrinsic``, mct:488-636) -> writes
    cam_extrinsic_optim.h5. Residuals are full omnidir pixel
    reprojections solved by LM-CGLS on ``device``."""
    import h5py

    from macaque_tpu_torch.calib.bundle import bundle_adjust_extrinsics

    cfg, base = load_calib_config(config_path)
    ids = [str(c) for c in cfg["camera_id"]]
    obs, K, xi, D, rvec, tvec = _load_marker_problem(base, ids)

    pts = _triangulate_trace(obs, K, xi, D, rvec, tvec, device, dtype)
    seen = ~np.isnan(pts[:, 0])
    obs_g = obs[:, seen]
    pts_g = np.nan_to_num(pts[seen])

    rv, tv, _, rms = bundle_adjust_extrinsics(
        K, xi, D, rvec, tvec, obs_g, pts_g, fix_cam0=fix_cam0,
        device=device, dtype=dtype)
    if verbose:
        print(f"extrinsic BA: {pts_g.shape[0]} points, rms {rms:.3f} px")

    out = os.path.join(base, "cam_extrinsic_optim.h5")
    with h5py.File(out, "w") as f:
        for i, cid in enumerate(ids):
            f.create_dataset(f"/{cid}/rvec", data=rv[i])
            f.create_dataset(f"/{cid}/tvec", data=tv[i].reshape(3, 1))
            if verbose:
                print(f"{cid}:", camera_position(rv[i], tv[i]))
    return out


def optimize_all_camera_params_driver(
    config_path: str, fix_cam0: bool = True,
    n_random_sample: int = -1, verbose: bool = True,
    device=None, dtype=torch.float32,
) -> str:
    """Full 16-parameter-per-camera BA — extrinsics AND omnidir
    intrinsics (reference ``optimize_all_camera_params``, mct:638-824)
    -> cam_extrinsic_optim.h5 + cam_intrinsic_optim.h5."""
    import h5py

    from macaque_tpu_torch.calib.bundle import bundle_adjust_full

    cfg, base = load_calib_config(config_path)
    ids = [str(c) for c in cfg["camera_id"]]
    obs, K, xi, D, rvec, tvec = _load_marker_problem(base, ids)

    if n_random_sample > 0 and n_random_sample < obs.shape[1]:
        rng = np.random.default_rng(0)
        sel = rng.choice(obs.shape[1], n_random_sample, replace=False)
        obs = obs[:, np.sort(sel)]

    pts = _triangulate_trace(obs, K, xi, D, rvec, tvec, device, dtype)
    seen = ~np.isnan(pts[:, 0])
    obs_g = obs[:, seen]
    pts_g = np.nan_to_num(pts[seen])

    K2, xi2, D2, rv, tv, _, rms = bundle_adjust_full(
        K, xi, D, rvec, tvec, obs_g, pts_g, fix_cam0=fix_cam0,
        device=device, dtype=dtype)
    if verbose:
        print(f"full BA: {pts_g.shape[0]} points, rms {rms:.3f} px")

    out = os.path.join(base, "cam_extrinsic_optim.h5")
    with h5py.File(out, "w") as f:
        for i, cid in enumerate(ids):
            f.create_dataset(f"/{cid}/rvec", data=rv[i])
            f.create_dataset(f"/{cid}/tvec", data=tv[i].reshape(3, 1))

    with h5py.File(os.path.join(base, "cam_intrinsic.h5"), "r") as f_in, \
         h5py.File(os.path.join(base, "cam_intrinsic_optim.h5"),
                   "w") as f_out:
        for i, cid in enumerate(ids):
            f_out.create_dataset(f"/{cid}/K", data=K2[i])
            f_out.create_dataset(f"/{cid}/xi",
                                 data=np.array([[xi2[i]]]))
            f_out.create_dataset(f"/{cid}/D", data=D2[i].reshape(1, 4))
            f_out.create_dataset(f"/{cid}/mtx",
                                 data=np.asarray(f_in[f"/{cid}/mtx"]))
            f_out.create_dataset(f"/{cid}/dist",
                                 data=np.asarray(f_in[f"/{cid}/dist"]))
    return out


# --------------------------------------------------------------------------
# step 6: post-BA frame re-anchoring
# --------------------------------------------------------------------------


def fix_extrinsic_optim(config_path: str, ref: int = 0,
                        verbose: bool = True) -> str:
    """Re-anchor the optimized extrinsics so the reference camera's pose
    matches its pre-BA pose (BA lets the world frame drift; reference
    mct:942-975 ``fix_extrinsic_optim``, shipped commented-out).

    A world re-expression composes extrinsics on the RIGHT
    (x_cam = M @ G @ x_world'), so the correction is
    ``M_cam <- M_cam @ inv(M_ref_post) @ M_ref_pre`` — this restores
    every camera exactly and preserves relative poses. (The reference's
    sketch left-multiplies, which re-anchors only the reference camera
    and warps the others — kept the correct form.)"""
    import h5py

    from macaque_tpu_torch.calib.graph_init import get_rtvec, make_M

    cfg, base = load_calib_config(config_path)
    ids = [str(c) for c in cfg["camera_id"]]
    path_pre = os.path.join(base, "cam_extrinsic.h5")
    path_opt = os.path.join(base, "cam_extrinsic_optim.h5")

    with h5py.File(path_pre, "r") as f:
        M_pre = make_M(np.asarray(f[f"/{ids[ref]}/rvec"]).ravel(),
                       np.asarray(f[f"/{ids[ref]}/tvec"]).ravel())
    with h5py.File(path_opt, "r") as f:
        M_post = make_M(np.asarray(f[f"/{ids[ref]}/rvec"]).ravel(),
                        np.asarray(f[f"/{ids[ref]}/tvec"]).ravel())
        cams = {cid: make_M(np.asarray(f[f"/{cid}/rvec"]).ravel(),
                            np.asarray(f[f"/{cid}/tvec"]).ravel())
                for cid in ids}

    fix = np.linalg.inv(M_post) @ M_pre
    with h5py.File(path_opt, "a") as f:
        for cid in ids:
            if verbose:
                rv0, tv0 = get_rtvec(cams[cid])
                print(f"{cid} (before):", camera_position(rv0, tv0))
            rv, tv = get_rtvec(cams[cid] @ fix)
            f[f"/{cid}/rvec"][...] = \
                rv.reshape(f[f"/{cid}/rvec"].shape)
            f[f"/{cid}/tvec"][...] = \
                tv.reshape(f[f"/{cid}/tvec"].shape)
            if verbose:
                print(f"{cid} (after): ", camera_position(rv, tv))
    return path_opt


# --------------------------------------------------------------------------
# annotation frame extraction
# --------------------------------------------------------------------------


def extract_frames_for_3dannotation(
    config_path: str, video_path: str, out_dir: str,
    n_frame_extract: int = 10, n_animal: int = 1, n_kp: int = 20,
    fps: float = 24.0, mdl=None, frame_ts=None, sync_warn_s: float = 0.001,
) -> str:
    """Dump synchronized multi-camera frames + empty annotation JSONs +
    a copy of the calibration for a 3D labeling session (reference
    mct:826-918), warning when cameras drift out of PTP sync."""
    from macaque_tpu_torch.video.imgstore import ImgStoreReader

    cfg, base = load_calib_config(config_path)
    ids = [str(c) for c in cfg["camera_id"]]
    stores = []
    for cid in ids:
        pat = os.path.join(f"{video_path}.{cid}*", "metadata.yaml")
        hits = sorted(glob.glob(pat))
        if not hits:
            raise FileNotFoundError(f"no store matching {pat}")
        stores.append(ImgStoreReader(hits[0]))
    t0 = stores[0].get_frame_metadata()["frame_time"][0]

    os.makedirs(out_dir, exist_ok=True)
    if frame_ts is not None:
        keys_ts = [(int((t - t0) * 1000), t) for t in frame_ts]
    else:
        n_frame = min(len(s) for s in stores)
        # the reference skips the first 100 frames (mct:869); only
        # meaningful when the recording is long enough
        start = 100 if n_frame > 100 + n_frame_extract else 0
        step = max((n_frame - start) / n_frame_extract, 1)
        frames = np.arange(start, n_frame, step).astype(int)
        keys_ts = [(int(i), t0 + i / fps) for i in frames]

    import cv2

    for key, t in keys_ts:
        ts = []
        for cid, store in zip(ids, stores):
            img, (_, ft) = store.get_nearest_image(t)
            ts.append(ft)
            cv2.imwrite(os.path.join(out_dir, f"{key:08d}.{cid}.jpg"),
                        np.asarray(img))
        if max(ts) - min(ts) > sync_warn_s:
            print(f"warning: sync is not good at key {key}: "
                  f"spread {max(ts) - min(ts):.4f}s")
        d = {
            "keypoints_2d": np.full(
                (n_animal, len(ids), n_kp, 2), np.nan).tolist(),
            "keypoints_3d": np.full(
                (n_animal, n_kp, 3), np.nan).tolist(),
        }
        with open(os.path.join(out_dir, f"{key:08d}.json"), "w") as fp:
            json.dump(d, fp)

    for s in stores:
        s.close()

    meta = {
        "n_animal": n_animal, "n_cam": len(ids), "n_kp": n_kp,
        "animal_names": [f"individual{i + 1}" for i in range(n_animal)],
        "model": [mdl] * n_animal,
    }
    import yaml

    with open(os.path.join(out_dir, "metadata.yaml"), "w") as fp:
        yaml.safe_dump(meta, fp)

    calib_out = os.path.join(out_dir, "calib")
    os.makedirs(calib_out, exist_ok=True)
    intrin_opt = os.path.join(base, "cam_intrinsic_optim.h5")
    intrin = intrin_opt if os.path.exists(intrin_opt) \
        else os.path.join(base, "cam_intrinsic.h5")
    shutil.copyfile(intrin, os.path.join(calib_out, "cam_intrinsic.h5"))
    for name in ("cam_extrinsic_optim.h5", "cam_extrinsic.h5",
                 "config.yaml"):
        src = os.path.join(base, name)
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(calib_out, name))
    return out_dir


# --------------------------------------------------------------------------
# umbrella driver
# --------------------------------------------------------------------------


def calibrate_from_videos(
    config_path: str, marker_mode: str = "cube",
    full_ba: bool = True, frame_intv: int = 5, fps: float = 24.0,
    verbose: bool = True, device=None, dtype=torch.float32,
) -> None:
    """End-to-end calibration: board videos -> intrinsics; labeled cage
    keypoints -> initial extrinsics; marker videos -> bundle-adjusted
    rig. Each stage skips if its output already exists (idempotent,
    like the pipeline stages). The solvers run on ``device``."""
    _, base = load_calib_config(config_path)

    def missing(name):
        return not os.path.exists(os.path.join(base, name))

    if missing("chessboard_points.h5"):
        analyze_chessboard_videos(config_path, frame_intv=frame_intv,
                                  verbose=verbose)
    if missing("cam_intrinsic.h5"):
        calibrate_intrinsics_driver(config_path, verbose=verbose,
                                    device=device, dtype=dtype)
    if missing("cam_extrinsic.h5"):
        if missing("cagepoints_annotation.h5"):
            raise FileNotFoundError(
                "cagepoints_annotation.h5 not found — label cage "
                "keypoints first (save_cage_annotations) or provide "
                "cam_extrinsic.h5")
        get_extrinsics_from_cage_keypoints(config_path, verbose=verbose)
    if missing("marker_trace.h5"):
        if marker_mode == "cube":
            analyze_aruco_cube_videos(config_path, frame_intv=frame_intv,
                                      fps=fps, verbose=verbose)
        else:
            analyze_aruco_marker_videos(config_path, verbose=verbose)
    if missing("cam_extrinsic_optim.h5"):
        if full_ba:
            optimize_all_camera_params_driver(config_path,
                                              verbose=verbose,
                                              device=device, dtype=dtype)
        else:
            optimize_extrinsics_driver(config_path, verbose=verbose,
                                       device=device, dtype=dtype)
