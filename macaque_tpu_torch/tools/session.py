"""Anipose-style session workflows: batch triangulation over project
folders, 2D reprojection, summaries, and tracking-error evaluation.

Port of ``macaque_tpu/tools/session.py``. Covers the reference's vendored
anipose CLI surface (src/third_party/anipose/): ``triangulate.py``
(:170-295 session triangulation with coordinate-frame correction and
per-bodypart CSV), ``project_2d.py`` (:24-163), ``summarize.py``
(:44-136), ``tracking_errors.py`` (:28-184), ``label_videos.py``
rendering, and the ``common.py`` session-folder helpers (nesting,
cam_regex naming, calibration-folder search).

All geometry (triangulation, refinement, reprojection) runs through the
port's ``CameraGroup`` facade, and the Viterbi and autoencoder filters on
tensors: every function whose work reaches a tensor takes ``device`` (the
card when None; it raises when there is none) and ``dtype``. The array
work of a triangulation and of a 2D filter chain is in
:func:`triangulate_arrays` and :func:`filter_pose_2d_arrays`, which take
and return arrays; the session drivers read and write the files around
them. pandas, h5py, cv2 and matplotlib are imported by the functions that
use them (the card's machine has none of them).

Pose-2d files: the reference uses DeepLabCut pandas-HDF5 tables. This
environment has no pytables, so the native format here is a plain h5py
layout (``points`` (F, J, 2), ``scores`` (F, J), attrs ``bodyparts``/
``scorer``); DLC pandas files are read transparently when pytables is
installed.
"""

from __future__ import annotations

import os
import re
from collections import defaultdict
from glob import glob
from typing import Optional, Sequence

import numpy as np
import torch


DEFAULT_SESSION_CONFIG = {
    "video_extension": "avi",
    "nesting": 1,
    "triangulation": {
        "ransac": False,
        "optim": False,
        "scale_smooth": 2,
        "scale_length": 2,
        "scale_length_weak": 1,
        "reproj_error_threshold": 5,
        "score_threshold": 0.8,
        "n_deriv_smooth": 3,
        "constraints": [],
        "constraints_weak": [],
        "cam_regex": r"cam([A-Za-z0-9]+)",
    },
    "pipeline": {
        "videos_raw": "videos-raw",
        "pose_2d": "pose-2d",
        "pose_2d_filter": "pose-2d-filtered",
        "pose_2d_projected": "pose-2d-proj",
        "pose_3d": "pose-3d",
        "pose_3d_filter": "pose-3d-filtered",
        "calibration_videos": "calibration",
        "calibration_results": "calibration",
        "videos_labeled_2d": "videos-labeled",
        "angles": "angles",
        "summaries": "summaries",
        "videos_compare": "videos-compare",
    },
    "calibration": {
        "animal_calibration": False,
        "calibration_init": None,
        "fisheye": False,
        "board_type": "charuco",
        "board_size": [10, 7],
        "board_square_side_length": 25.0,
        "board_marker_length": 18.75,
        "board_marker_bits": 4,
        "board_marker_dict_number": 50,
    },
    # full anipose filter defaults (reference anipose.py:53-62) so a
    # config.toml naming only [filter] type gets the same thresholds
    "filter": {
        "enabled": False,
        "type": "medfilt",
        "medfilt": 13,
        "offset_threshold": 25,
        "score_threshold": 0.05,
        "spline": True,
        "n_back": 5,
        "multiprocessing": False,
    },
    "filter3d": {"enabled": False},
}


def load_session_config(fname: Optional[str] = None) -> dict:
    """Project config.toml with defaults merged in (reference
    anipose.py:73-103 ``load_config``)."""
    import tomllib

    if fname is None:
        fname = "config.toml"
    if os.path.exists(fname):
        with open(fname, "rb") as f:
            config = tomllib.load(f)
    else:
        config = {}

    if "path" not in config:
        d = os.path.dirname(fname)
        config["path"] = d if (os.path.exists(fname) and d) else os.getcwd()
    config["path"] = os.path.normpath(os.path.abspath(
        os.path.expanduser(config["path"])))
    if "project" not in config:
        config["project"] = os.path.basename(config["path"])

    import copy

    # deep-copy the defaults: handing out the shared dicts by reference
    # lets one caller's config["triangulation"].update(...) silently
    # poison every later load_session_config() result
    for k, v in DEFAULT_SESSION_CONFIG.items():
        if k not in config:
            config[k] = copy.deepcopy(v)
        elif isinstance(v, dict):
            for k2, v2 in v.items():
                config[k].setdefault(k2, copy.deepcopy(v2))
    return config


# --------------------------------------------------------------------------
# naming / folder helpers (reference common.py)
# --------------------------------------------------------------------------


def natural_keys(text: str):
    return [int(c) if c.isdigit() else c for c in re.split(r"(\d+)", text)]


def true_basename(fname: str) -> str:
    return os.path.splitext(os.path.basename(fname))[0]


def get_cam_name(config: dict, fname: str) -> Optional[str]:
    m = re.search(config["triangulation"]["cam_regex"],
                  true_basename(fname))
    return m.groups()[0].strip() if m else None


def get_video_name(config: dict, fname: str) -> str:
    # whitespace-strip only, keeping separator chars — matches the
    # reference byte-for-byte (common.py:75-80; "vid-camA" -> "vid-"),
    # pinned by tests/test_golden_session.py::test_golden_process_session
    return re.sub(config["triangulation"]["cam_regex"], "",
                  true_basename(fname)).strip()


def get_folders(path: str) -> list[str]:
    return sorted(next(os.walk(path))[1])


def process_all(config: dict, process_session, **args) -> dict:
    """Apply ``process_session`` over the project's nested session
    folders; returns {folder-tuple: result} (reference common.py:117-163,
    nesting levels 0..n)."""
    prefix = config["path"]
    nesting = config.get("nesting", 1)
    output = {}

    def walk(dirpath, key, level):
        if level == nesting:
            output[key] = process_session(config, dirpath, **args)
            return
        for f in get_folders(dirpath):
            walk(os.path.join(dirpath, f), key + (f,), level + 1)

    walk(prefix, (), 0)
    return output


def find_calibration_folder(config: dict,
                            session_path: str) -> Optional[str]:
    """Walk up from the session folder until a folder containing the
    calibration subfolder is found (reference common.py:171-186 keys on
    calibration_videos; calibration_results is also accepted so trees
    that only carry results — e.g. a shipped calibration.toml — still
    resolve)."""
    names = {config["pipeline"].get("calibration_videos", "calibration"),
             config["pipeline"]["calibration_results"]}
    path = os.path.abspath(session_path)
    root = os.path.abspath(config["path"])
    while True:
        if any(os.path.isdir(os.path.join(path, n)) for n in names):
            return path
        if path == root or os.path.dirname(path) == path:
            return None
        path = os.path.dirname(path)


# --------------------------------------------------------------------------
# pose-2d file IO
# --------------------------------------------------------------------------


def write_pose2d(points: np.ndarray, scores: np.ndarray,
                 bodyparts: Sequence[str], outname: str,
                 scorer: str = "macaque_tpu",
                 extra: Optional[dict] = None) -> str:
    """(F, J, 2) + (F, J) -> pose-2d h5 (plain h5py layout; see module
    docstring)."""
    import h5py

    with h5py.File(outname, "w") as f:
        f.create_dataset("points", data=np.asarray(points, float))
        f.create_dataset("scores", data=np.asarray(scores, float))
        if extra:
            for k, v in extra.items():
                f.create_dataset(k, data=np.asarray(v))
        f.attrs["bodyparts"] = list(bodyparts)
        f.attrs["scorer"] = scorer
    return outname


def read_pose2d(fname: str) -> dict:
    """Read a pose-2d file: native h5py layout, or DLC pandas-HDF5 when
    pytables is available. Returns {points (F, J, 2), scores (F, J),
    bodyparts}."""
    import h5py

    try:
        with h5py.File(fname, "r") as f:
            if "points" in f:
                out = {
                    "points": np.asarray(f["points"]),
                    "scores": np.asarray(f["scores"]),
                    "bodyparts": [
                        b.decode() if isinstance(b, bytes) else str(b)
                        for b in f.attrs["bodyparts"]
                    ],
                }
                if "interpolated" in f:
                    out["interpolated"] = np.asarray(f["interpolated"])
                return out
    except OSError:
        pass

    # DLC pandas table fallback (requires pytables)
    import pandas as pd

    d = pd.read_hdf(fname)
    if len(d.columns.levels) > 2:
        d = d.loc[:, d.columns.levels[0][0]]
    bp_index = d.columns.names.index("bodyparts")
    bodyparts = list(d.columns.get_level_values(bp_index).unique())
    F, J = len(d), len(bodyparts)
    points = np.full((F, J, 2), np.nan)
    scores = np.zeros((F, J))
    for j, bp in enumerate(bodyparts):
        points[:, j, 0] = np.asarray(d[bp]["x"])
        points[:, j, 1] = np.asarray(d[bp]["y"])
        scores[:, j] = np.asarray(d[bp]["likelihood"])
    return {"points": points, "scores": scores, "bodyparts": bodyparts}


def load_pose2d_fnames(fname_dict: dict, offsets_dict: Optional[dict] = None,
                       cam_names: Optional[Sequence[str]] = None) -> dict:
    """Stack per-camera pose-2d files into (C, F, J, 2)/(C, F, J) arrays
    (reference triangulate.py:81-129)."""
    if cam_names is None:
        cam_names = sorted(fname_dict.keys())
    if offsets_dict is None:
        offsets_dict = {c: (0, 0) for c in cam_names}

    datas = [read_pose2d(fname_dict[c]) for c in cam_names]
    bodyparts = datas[0]["bodyparts"]
    F = min(d["points"].shape[0] for d in datas)
    J = len(bodyparts)
    points = np.full((len(cam_names), F, J, 2), np.nan)
    scores = np.zeros((len(cam_names), F, J))
    for i, (c, d) in enumerate(zip(cam_names, datas)):
        dx, dy = offsets_dict.get(c, (0, 0))
        points[i] = d["points"][:F] + np.array([dx, dy])
        scores[i] = d["scores"][:F]
    return {"cam_names": list(cam_names), "points": points,
            "scores": scores, "bodyparts": bodyparts}


def load_offsets_dict(config: dict, cam_names: Sequence[str]) -> dict:
    out = {}
    for c in cam_names:
        if "cameras" in config and c in config["cameras"]:
            out[c] = tuple(config["cameras"][c]["offset"])
        else:
            out[c] = (0, 0)
    return out


def load_constraints(config: dict, bodyparts: Sequence[str],
                     key: str = "constraints") -> list:
    bp_index = {b: i for i, b in enumerate(bodyparts)}
    out = []
    for a, b in config["triangulation"].get(key, []):
        out.append([bp_index[a], bp_index[b]])
    return out


# --------------------------------------------------------------------------
# coordinate-frame correction (reference triangulate.py:20-78)
# --------------------------------------------------------------------------


def correct_coordinate_frame(config: dict, all_points_3d: np.ndarray,
                             bodyparts: Sequence[str]):
    """Rotate/center points to the axes spec in
    config['triangulation']['axes'] + ['reference_point']. Returns
    (points, M (3, 3), center (3,))."""
    bp_index = {b: i for i, b in enumerate(bodyparts)}
    axes_map = {"x": 0, "y": 1, "z": 2}
    ref_point = config["triangulation"]["reference_point"]
    axes_spec = config["triangulation"]["axes"]
    a_dirx, a_l, a_r = axes_spec[0]
    b_dirx, b_l, b_r = axes_spec[1]
    a_dir, b_dir = axes_map[a_dirx], axes_map[b_dirx]
    c_dir = 3 - a_dir - b_dir

    def med(ix):
        pts = all_points_3d[:, ix]
        pts = pts[~np.isnan(pts[:, 0])]
        return np.median(pts, axis=0)

    a_diff = med(bp_index[a_r]) - med(bp_index[a_l])
    b_raw = med(bp_index[b_r]) - med(bp_index[b_l])
    b_diff = b_raw - a_diff * (b_raw @ a_diff) / (a_diff @ a_diff)

    M = np.zeros((3, 3))
    M[a_dir] = a_diff
    M[b_dir] = b_diff
    if (a_dir, b_dir) in [(0, 1), (2, 0), (1, 2)]:
        M[c_dir] = np.cross(a_diff, b_diff)
    else:
        M[c_dir] = np.cross(b_diff, a_diff)
    M /= np.linalg.norm(M, axis=1)[:, None]

    adj = all_points_3d @ M.T
    pts = adj[:, bp_index[ref_point]]
    center = np.median(pts[~np.isnan(pts[:, 0])], axis=0)
    return adj - center, M, center


# --------------------------------------------------------------------------
# session triangulation (reference triangulate.py:170-293)
# --------------------------------------------------------------------------


def triangulate_arrays(cgroup, points: np.ndarray, scores: np.ndarray,
                       tri_cfg: dict, constraints=(), constraints_weak=(),
                       verbose: bool = False):
    """The array work of :func:`triangulate_session`: (C, F, J, 2) raw
    pixels (camera offsets applied) and (C, F, J) scores of ``cgroup``'s
    cameras -> (points (F, J, 3), errors (F, J), ncams (F, J), scores
    (F, J)), NaN where too few cameras saw a point. Detections under
    ``tri_cfg['score_threshold']`` are dropped; ``ransac`` and ``optim``
    choose the solver as in the reference (triangulate.py:170-293). The
    geometry runs on the group's device in its dtype."""
    points = np.array(points, float)
    scores = np.asarray(scores, float)
    n_cams, n_frames, n_joints, _ = points.shape
    points[scores < tri_cfg["score_threshold"]] = np.nan

    points_shaped = points.reshape(n_cams, -1, 2)
    if tri_cfg["ransac"]:
        points_3d_init, picked, p2ds, errors = cgroup.triangulate_ransac(
            points_shaped, min_cams=3 if not tri_cfg["optim"] else 2)
    else:
        points_3d_init = cgroup.triangulate(points_shaped)

    if tri_cfg["optim"]:
        p3d_init = points_3d_init.reshape(n_frames, n_joints, 3)
        if np.isfinite(p3d_init[..., 0]).sum() < 20:
            print("warning: not enough 3D points to run optimization")
            points_3d = p3d_init
        else:
            points_3d, _ = cgroup.optim_points(
                points, p3d_init,
                constraints=constraints,
                constraints_weak=constraints_weak,
                scale_smooth=tri_cfg["scale_smooth"],
                scale_length=tri_cfg["scale_length"],
                scale_length_weak=tri_cfg["scale_length_weak"],
                n_deriv_smooth=tri_cfg["n_deriv_smooth"],
                reproj_error_threshold=tri_cfg["reproj_error_threshold"],
                verbose=verbose)
        errors = cgroup.reprojection_error(
            points_3d.reshape(-1, 3), points.reshape(n_cams, -1, 2),
            mean=True)
        good = ~np.isnan(points[..., 0])
        num_cams = good.sum(axis=0).astype(float)
        min_cams_out = 1
    else:
        points_3d = points_3d_init.reshape(n_frames, n_joints, 3)
        if tri_cfg["ransac"]:
            good = ~np.isnan(p2ds.reshape(n_cams, n_frames, n_joints,
                                          2)[..., 0])
            num_cams = picked.reshape(n_cams, n_frames, n_joints)\
                .sum(axis=0).astype(float) \
                if picked.ndim >= 3 else good.sum(axis=0).astype(float)
        else:
            errors = cgroup.reprojection_error(
                points_3d.reshape(-1, 3), points_shaped, mean=True)
            good = ~np.isnan(points[..., 0])
            num_cams = good.sum(axis=0).astype(float)
        min_cams_out = 2

    all_errors = np.array(errors, float).reshape(n_frames, n_joints)
    scores_masked = scores.copy()
    scores_masked[~good] = 2
    scores_3d = scores_masked.min(axis=0)

    low = num_cams < min_cams_out
    scores_3d[low] = np.nan
    all_errors[low] = np.nan
    if min_cams_out == 2:
        num_cams = num_cams.copy()
        num_cams[low] = np.nan
    return points_3d, all_errors, num_cams, scores_3d


def triangulate_session(config: dict, calib_folder: str,
                        fname_dict: dict, output_fname: str,
                        verbose: bool = False, device=None,
                        dtype: torch.dtype = torch.float32) -> str:
    """Triangulate one multi-camera recording of pose-2d files into the
    anipose per-bodypart CSV (x/y/z/error/ncams/score columns + the
    M/center frame correction + fnum), through :func:`triangulate_arrays`
    on ``device``."""
    import pandas as pd

    from macaque_tpu_torch.compat.aniposelib import CameraGroup

    cam_names = sorted(fname_dict.keys())
    cgroup = CameraGroup.load(
        os.path.join(calib_folder, "calibration.toml"), device, dtype)

    offsets_dict = load_offsets_dict(config, cam_names)
    out = load_pose2d_fnames(fname_dict, offsets_dict, cam_names)
    bodyparts = out["bodyparts"]
    n_frames = out["points"].shape[1]

    tri_cfg = config["triangulation"]
    constraints, constraints_weak = (), ()
    if tri_cfg["optim"]:
        constraints = load_constraints(config, bodyparts)
        constraints_weak = load_constraints(config, bodyparts,
                                            "constraints_weak")
    points_3d, all_errors, num_cams, scores_3d = triangulate_arrays(
        cgroup.subset_cameras_names(cam_names), out["points"],
        out["scores"], tri_cfg, constraints, constraints_weak, verbose)

    if ("reference_point" in tri_cfg) and ("axes" in tri_cfg):
        points_adj, M, center = correct_coordinate_frame(
            config, points_3d, bodyparts)
    else:
        points_adj, M, center = points_3d, np.eye(3), np.zeros(3)

    dout = pd.DataFrame()
    for j, bp in enumerate(bodyparts):
        for a, axis in enumerate(("x", "y", "z")):
            dout[f"{bp}_{axis}"] = points_adj[:, j, a]
        dout[f"{bp}_error"] = all_errors[:, j]
        dout[f"{bp}_ncams"] = num_cams[:, j]
        dout[f"{bp}_score"] = scores_3d[:, j]
    for i in range(3):
        for j in range(3):
            dout[f"M_{i}{j}"] = M[i, j]
    for i in range(3):
        dout[f"center_{i}"] = center[i]
    dout["fnum"] = np.arange(n_frames)
    dout.to_csv(output_fname, index=False)
    return output_fname


def process_session_triangulate(config: dict, session_path: str,
                                device=None,
                                dtype: torch.dtype = torch.float32):
    """Triangulate every recording in a session folder (reference
    triangulate.py:296-349): groups pose-2d files by recording name via
    cam_regex, skips existing outputs."""
    pipe = config["pipeline"]
    calibration_path = find_calibration_folder(config, session_path)
    if calibration_path is None:
        return []

    pose_dirname = pipe["pose_2d_filter"] if config["filter"]["enabled"] \
        else pipe["pose_2d"]
    pose_folder = os.path.join(session_path, pose_dirname)
    calib_folder = os.path.join(calibration_path,
                                pipe["calibration_results"])
    output_folder = os.path.join(session_path, pipe["pose_3d"])

    pose_files = glob(os.path.join(pose_folder, "*.h5"))
    cam_videos = defaultdict(list)
    for pf in pose_files:
        cam_videos[get_video_name(config, pf)].append(pf)

    written = []
    for name in sorted(cam_videos, key=natural_keys):
        fnames = cam_videos[name]
        fname_dict = {get_cam_name(config, f): f for f in fnames}
        os.makedirs(output_folder, exist_ok=True)
        output_fname = os.path.join(output_folder, name + ".csv")
        if os.path.exists(output_fname):
            continue
        triangulate_session(config, calib_folder, fname_dict,
                            output_fname, device=device, dtype=dtype)
        written.append(output_fname)
    return written


def triangulate_all(config: dict, device=None,
                    dtype: torch.dtype = torch.float32) -> dict:
    return process_all(config, process_session_triangulate, device=device,
                       dtype=dtype)


# --------------------------------------------------------------------------
# project calibration (reference calibrate.py + common.py:189-218)
# --------------------------------------------------------------------------


def get_calibration_board(config: dict):
    """Board object from config['calibration'] (reference
    common.py:189-218; aruco plain boards are unimplemented there too)."""
    from macaque_tpu_torch.calib.videos import CharucoBoard, Checkerboard

    calib = config["calibration"]
    bs = calib["board_size"]
    bt = str(calib["board_type"]).lower()
    if bt == "charuco":
        import cv2

        bits = int(calib.get("board_marker_bits", 4))
        num = int(calib.get("board_marker_dict_number", 50))
        dict_id = getattr(cv2.aruco, f"DICT_{bits}X{bits}_{num}", None)
        return CharucoBoard(
            squares_x=int(bs[0]), squares_y=int(bs[1]),
            square_length=float(calib["board_square_side_length"]),
            marker_length=float(calib["board_marker_length"]),
            dict_id=dict_id)
    if bt == "checkerboard":
        return Checkerboard(
            cols=int(bs[0]), rows=int(bs[1]),
            square_size=float(calib["board_square_side_length"]))
    raise ValueError(
        f"board_type should be 'charuco' or 'checkerboard', not {bt!r}"
        " ('aruco' is unimplemented, as in the reference)")


def process_session_calibrate(config: dict, session_path: str,
                              device=None,
                              dtype: torch.dtype = torch.float32):
    """Calibrate a session's rig from recorded board videos into
    calibration.toml (reference calibrate.py:120-227 ``process_session``:
    detections cached in detections.pickle, skip-if-done,
    calibration_init reuse, optional animal_calibration refinement on
    the project's own pose-2d detections). The solves run on ``device``
    in ``dtype``; cv2 reads the videos."""
    import pickle

    from macaque_tpu_torch.compat.aniposelib import CameraGroup

    on = {"device": device, "dtype": dtype}

    pipe = config["pipeline"]
    calibration_path = find_calibration_folder(config, session_path)
    if calibration_path is None:
        return None

    videos = sorted(glob(os.path.join(
        calibration_path, pipe["calibration_videos"],
        "*." + config["video_extension"])))
    cam_videos = defaultdict(list)
    for vid in videos:
        cam_videos[get_cam_name(config, vid)].append(vid)
    cam_names = sorted(cam_videos)
    video_list = [sorted(cam_videos[c]) for c in cam_names]

    outdir = os.path.join(calibration_path, pipe["calibration_results"])
    outname = os.path.join(outdir, "calibration.toml")

    skip_calib = False
    init_stuff = True
    error = None
    if os.path.exists(outname):
        cgroup = CameraGroup.load(outname, **on)
        meta = cgroup.rig.metadata
        if (not config["calibration"]["animal_calibration"]) or \
                meta.get("adjusted"):
            return None
        skip_calib = True
        error = meta.get("error")
        init_stuff = False
    elif config["calibration"]["calibration_init"] is not None:
        cgroup = CameraGroup.load(os.path.join(
            config["path"], config["calibration"]["calibration_init"]),
            **on)
        init_stuff = False
        skip_calib = len(videos) == 0
    else:
        if len(videos) == 0:
            return None
        import cv2

        sizes = []
        for vids in video_list:
            cap = cv2.VideoCapture(vids[0])
            sizes.append((int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                          int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))))
            cap.release()
        # fisheye=true selects equidistant FisheyeCamera rigs, exactly
        # like the reference (anipose calibrate.py:181)
        cgroup = CameraGroup.from_names(
            cam_names, fisheye=bool(config["calibration"]["fisheye"]),
            img_size=sizes[0], **on)

    board = get_calibration_board(config)
    if not skip_calib:
        from macaque_tpu_torch.calib.videos import detect_board_video

        os.makedirs(outdir, exist_ok=True)
        rows_fname = os.path.join(outdir, "detections.pickle")
        if os.path.exists(rows_fname):
            with open(rows_fname, "rb") as f:
                all_rows = pickle.load(f)
        else:
            all_rows = []
            for vids in video_list:
                rows_cam = []
                for vnum, vidname in enumerate(vids):
                    rows_cam.extend(detect_board_video(vidname, board,
                                                       prefix=vnum))
                all_rows.append(rows_cam)
            with open(rows_fname, "wb") as f:
                pickle.dump(all_rows, f)
        error = cgroup.calibrate_rows(all_rows, board,
                                      init_intrinsics=init_stuff,
                                      init_extrinsics=init_stuff,
                                      verbose=False)

    cgroup.rig.metadata["adjusted"] = False
    if error is not None:
        cgroup.rig.metadata["error"] = float(error)
    os.makedirs(outdir, exist_ok=True)
    cgroup.dump(outname)

    if config["calibration"]["animal_calibration"]:
        pts, cams = _project_animal_points(config, calibration_path)
        cgroup = cgroup.subset_cameras_names(cams)
        error = cgroup.bundle_adjust_iter(pts, n_iters=4, verbose=False)
        cgroup.rig.metadata["adjusted"] = True
        cgroup.rig.metadata["error"] = float(error)
        cgroup.dump(outname)
    return outname


def _project_animal_points(config: dict, calibration_path: str):
    """Gather the project's own pose-2d detections under the calibration
    folder and prune them for calibration refinement (reference
    calibrate.py:28-118 ``load_2d_data`` + score-percentile /
    min-2-camera pruning of ``process_points_for_calibration``)."""
    sub = dict(config)
    sub["path"] = calibration_path
    pose_key = "pose_2d_filter" if config["filter"]["enabled"] \
        else "pose_2d"

    cam_videos = defaultdict(list)
    all_cam_names = set()

    def collect(cfg, session_path):
        for f in glob(os.path.join(session_path,
                                   config["pipeline"][pose_key], "*.h5")):
            cam_videos[(session_path,
                        get_video_name(config, f))].append(f)
            all_cam_names.add(get_cam_name(config, f))
        return []

    # the calibration folder may be the session itself (nesting offset,
    # reference calibrate.py:31-38) — walk both depths
    for nesting in range(config.get("nesting", 1) + 1):
        sub["nesting"] = nesting
        process_all(sub, collect)
        if cam_videos:
            break

    all_cam_names = sorted(all_cam_names)
    blocks, scores_blocks = [], []
    for key in sorted(cam_videos):
        fnames = sorted(cam_videos[key])
        cams = [get_cam_name(config, f) for f in fnames]
        out = load_pose2d_fnames(dict(zip(cams, fnames)),
                                 load_offsets_dict(config, cams), cams)
        C, F, J, _ = out["points"].shape
        pts = np.full((len(all_cam_names), F, J, 2), np.nan)
        scs = np.full((len(all_cam_names), F, J), np.nan)
        for i, c in enumerate(all_cam_names):
            if c in cams:
                pts[i] = out["points"][cams.index(c)]
                scs[i] = out["scores"][cams.index(c)]
        blocks.append(pts)
        scores_blocks.append(scs)
    points = np.hstack(blocks).reshape(len(all_cam_names), -1, 2)
    scores = np.hstack(scores_blocks).reshape(len(all_cam_names), -1)

    scores[np.isnan(points[..., 0])] = 0
    thres = max(min(np.percentile(scores, 90), 0.95), 0.8)
    points[scores < thres] = np.nan
    good = (~np.isnan(points[..., 0])).sum(axis=0) >= 2
    points = points[:, good]
    if points.shape[1] > 100_000:
        rng = np.random.default_rng(0)
        points = points[:, rng.choice(points.shape[1], 100_000,
                                      replace=False)]
    return points, all_cam_names


def calibrate_all(config: dict, device=None,
                  dtype: torch.dtype = torch.float32) -> dict:
    return process_all(config, process_session_calibrate, device=device,
                       dtype=dtype)


# --------------------------------------------------------------------------
# 2D pose filtering (reference filter_pose.py:355-395 session driver;
# the filters live in macaque_tpu_torch/filters/)
# --------------------------------------------------------------------------

FILTER_TYPES_2D = ("medfilt", "viterbi", "autoencoder")


def filter_pose_2d_arrays(fcfg: dict, points: np.ndarray,
                          scores: np.ndarray, device=None,
                          dtype: torch.dtype = torch.float32):
    """The array work of :func:`filter_pose_2d_file`: (F, J, 2) points and
    (F, J) scores through the chain of filter types in ``fcfg['type']``
    exactly as the reference chains them (each stage's output becomes the
    next stage's single candidate; filter_pose.py:386-390). Returns
    (points (F, J, 2), scores (F, J)) as float64 numpy. The median filter
    is host numpy; the Viterbi pass and the autoencoder (weights from
    ``fcfg['autoencoder_path']``) run on ``device`` in ``dtype``."""
    types = fcfg.get("type", "medfilt")
    if not isinstance(types, list):
        types = [types]
    for t in types:
        assert t in FILTER_TYPES_2D, \
            f"invalid filter type {t!r}, should be one of {FILTER_TYPES_2D}"
    points = np.asarray(points, float)
    scores = np.asarray(scores, float)
    for t in types:
        if t == "medfilt":
            from macaque_tpu_torch.filters.smoothing import (
                filter_pose_medfilt_2d,
            )

            cand = np.concatenate(
                [points, scores[..., None]], axis=-1)[:, :, None, :]
            points, scores = filter_pose_medfilt_2d(
                cand,
                kernel_size=fcfg.get("medfilt", 13),
                offset_threshold=fcfg.get("offset_threshold", 25.0),
                score_threshold=fcfg.get("score_threshold", 0.05),
                spline=fcfg.get("spline", True))
        elif t == "viterbi":
            from macaque_tpu_torch.core.device import resolve_device
            from macaque_tpu_torch.filters.viterbi import (
                viterbi_filter_joints,
            )

            dev = resolve_device(device)
            # fallbacks mirror the anipose defaults (anipose.py:53-62)
            pts, scs = viterbi_filter_joints(
                torch.as_tensor(points, dtype=dtype, device=dev)[:, :, None],
                torch.as_tensor(scores, dtype=dtype, device=dev)[..., None],
                n_back=fcfg.get("n_back", 5),
                thres_dist=fcfg.get("offset_threshold", 25.0),
                score_threshold=fcfg.get("score_threshold", 0.05))
            points = pts.to("cpu", torch.float64).numpy()
            scores = scs.to("cpu", torch.float64).numpy()
        else:  # autoencoder score rescoring
            from macaque_tpu_torch.filters.autoencoder import (
                AEParams, filter_scores_autoencoder, load_autoencoder,
            )

            params = AEParams(*(p.to(dtype) for p in load_autoencoder(
                fcfg["autoencoder_path"], device)))
            scores = np.asarray(filter_scores_autoencoder(
                params, scores,
                score_threshold=fcfg.get("score_threshold", 0.05)), float)
    return points, scores


def filter_pose_2d_file(config: dict, fname: str, outname: str,
                        device=None,
                        dtype: torch.dtype = torch.float32) -> str:
    """pose-2d h5 -> filtered pose-2d h5 through
    :func:`filter_pose_2d_arrays` on ``device``."""
    d = read_pose2d(fname)
    points, scores = filter_pose_2d_arrays(
        config["filter"], d["points"], d["scores"], device, dtype)
    return write_pose2d(points, scores, d["bodyparts"], outname)


def process_session_filter_pose(config: dict, session_path: str,
                                device=None,
                                dtype: torch.dtype = torch.float32):
    """Filter every pose-2d file in a session into pose-2d-filtered
    (reference filter_pose.py ``process_session``; skips existing)."""
    pipe = config["pipeline"]
    pose_folder = os.path.join(session_path, pipe["pose_2d"])
    output_folder = os.path.join(session_path, pipe["pose_2d_filter"])

    pose_files = sorted(glob(os.path.join(pose_folder, "*.h5")),
                        key=natural_keys)
    written = []
    for fname in pose_files:
        outpath = os.path.join(output_folder, os.path.basename(fname))
        if os.path.exists(outpath):
            continue
        os.makedirs(output_folder, exist_ok=True)
        filter_pose_2d_file(config, fname, outpath, device, dtype)
        written.append(outpath)
    return written


def filter_pose_2d_all(config: dict, device=None,
                       dtype: torch.dtype = torch.float32) -> dict:
    return process_all(config, process_session_filter_pose, device=device,
                       dtype=dtype)


def train_autoencoder_project(config: dict, epochs: int = 300,
                              device=None,
                              dtype: torch.dtype = torch.float32) -> str:
    """Train the visibility-pattern autoencoder on every pose-2d file in
    the project and save it to config['filter']['autoencoder_path']
    (role of reference train_autoencoder.py, which trains an sklearn MLP
    on DLC labeled data; here the confident-frame visibility patterns of
    the project's own detections are the training set — same objective,
    sklearn-free). Trains on ``device`` in ``dtype``."""
    from macaque_tpu_torch.filters.autoencoder import (
        save_autoencoder, train_autoencoder,
    )

    def session_fnames(config, session_path):
        return sorted(glob(os.path.join(
            session_path, config["pipeline"]["pose_2d"], "*.h5")),
            key=natural_keys)

    all_scores = []
    for fnames in process_all(config, session_fnames).values():
        for fname in fnames:
            all_scores.append(read_pose2d(fname)["scores"])
    if not all_scores:
        raise FileNotFoundError("no pose-2d files to train on")
    scores = np.concatenate(all_scores, axis=0)
    params = train_autoencoder(
        scores,
        score_threshold=config["filter"].get("score_threshold", 0.5),
        epochs=epochs, device=device, dtype=dtype)
    out = config["filter"].get(
        "autoencoder_path",
        os.path.join(config["path"], "autoencoder.npz"))
    config["filter"]["autoencoder_path"] = out
    return save_autoencoder(params, out)


# --------------------------------------------------------------------------
# 3D pose filtering (reference filter_3d.py)
# --------------------------------------------------------------------------


def filter_pose_3d_csv(config: dict, fname: str, outname: str) -> str:
    """pose-3d CSV -> filtered CSV (reference filter_3d.py:33-54
    ``filter_pose``): NaN out frames whose reprojection error exceeds
    the threshold, interpolate gaps, median-filter each coordinate
    (median-padded kernel 17), and set the error columns to the
    reference's plotting constant 10."""
    import pandas as pd

    from scipy import signal

    f3cfg = config.get("filter3d", {})
    error_threshold = f3cfg.get("error_threshold", 15.0)
    size = f3cfg.get("medfilt", 17)
    data = pd.read_csv(fname)

    bodyparts = [c[:-len("_error")] for c in data.columns
                 if c.endswith("_error")]
    padsize = size + 5
    for bp in bodyparts:
        error = np.array(data[f"{bp}_error"], float)
        error[np.isnan(error)] = 100000
        bad = error > error_threshold
        for v in "xyz":
            vals = np.array(data[f"{bp}_{v}"], float)
            vals[bad] = np.nan
            nans = np.isnan(vals)
            # interpolation is skipped for mostly-NaN series, but the
            # median filter is ALWAYS applied — exactly the reference
            # (interpolate_data:25-31 early-returns, medfilt_data runs
            # unconditionally at filter_3d.py:48-49), so NaNs then
            # propagate through the median windows
            if nans.mean() <= 0.85 and nans.any():
                ix = np.flatnonzero(~nans)
                vals[nans] = np.interp(np.flatnonzero(nans), ix,
                                       vals[ix])
            vp = np.pad(vals, (padsize, padsize), mode="median",
                        stat_length=5)
            data[f"{bp}_{v}"] = signal.medfilt(vp, kernel_size=size)[
                padsize:-padsize]
        data[f"{bp}_error"] = 10  # reference's plotting hack, kept
    data.to_csv(outname, index=False)
    return outname


def process_session_filter_3d(config: dict, session_path: str):
    """Filter every pose-3d CSV in a session into pose-3d-filtered
    (reference filter_3d.py ``process_session``; skips existing)."""
    pipe = config["pipeline"]
    pose_folder = os.path.join(session_path, pipe["pose_3d"])
    output_folder = os.path.join(session_path, pipe["pose_3d_filter"])

    pose_files = sorted(glob(os.path.join(pose_folder, "*.csv")),
                        key=natural_keys)
    written = []
    for fname in pose_files:
        outpath = os.path.join(output_folder, os.path.basename(fname))
        if os.path.exists(outpath):
            continue
        os.makedirs(output_folder, exist_ok=True)
        filter_pose_3d_csv(config, fname, outpath)
        written.append(outpath)
    return written


def filter_pose_3d_all(config: dict) -> dict:
    return process_all(config, process_session_filter_3d)


# --------------------------------------------------------------------------
# 2D reprojection (reference project_2d.py)
# --------------------------------------------------------------------------


def get_projected_points(config: dict, pose_fname: str, cgroup,
                         offsets_dict: dict):
    """3D CSV -> per-camera projected 2D points
    (reference project_2d.py:24-71)."""
    import pandas as pd

    pose_data = pd.read_csv(pose_fname)
    cols = [x for x in pose_data.columns if "_error" in x]
    bodyparts = [c.replace("_error", "") for c in cols]

    M = np.eye(3)
    center = np.zeros(3)
    for i in range(3):
        center[i] = np.mean(pose_data[f"center_{i}"])
        for j in range(3):
            M[i, j] = np.mean(pose_data[f"M_{i}{j}"])

    all_points = np.stack([
        np.asarray(pose_data.loc[:, (f"{bp}_x", f"{bp}_y", f"{bp}_z")])
        for bp in bodyparts])                      # (J, F, 3)
    all_errors = np.stack([
        np.asarray(pose_data[f"{bp}_error"]) for bp in bodyparts])
    all_scores = np.stack([
        np.asarray(pose_data[f"{bp}_score"]) for bp in bodyparts])

    all_errors[np.isnan(all_errors)] = \
        0 if config["triangulation"]["optim"] else 10000
    all_points[all_errors >= 50] = np.nan

    n_joints, n_frames, _ = all_points.shape
    flat = all_points.reshape(-1, 3)
    flat_t = (flat + center) @ np.linalg.inv(M.T)

    proj = cgroup.project(np.nan_to_num(flat_t))
    proj = np.where(np.isnan(flat_t[None, :, 0, None]), np.nan, proj)
    proj = proj.reshape(len(cgroup.get_names()), n_joints, n_frames, 2)
    for cix, cname in enumerate(cgroup.get_names()):
        dx, dy = offsets_dict.get(cname, (0, 0))
        proj[cix, :, :, 0] -= dx
        proj[cix, :, :, 1] -= dy
    return bodyparts, proj, all_scores


def process_session_project_2d(config: dict, session_path: str,
                               device=None,
                               dtype: torch.dtype = torch.float32):
    """Project per-recording 3D CSVs back into each camera and write
    pose-2d-proj h5 files (reference project_2d.py:74-161), on
    ``device``."""
    pipe = config["pipeline"]
    video_ext = config["video_extension"]

    vid_fnames = sorted(glob(os.path.join(
        session_path, pipe["videos_raw"], "*." + video_ext)),
        key=natural_keys)
    pose_fnames = sorted(glob(os.path.join(
        session_path, pipe["pose_3d"], "*.csv")), key=natural_keys)
    if not pose_fnames:
        return []

    fnames_2d = defaultdict(list)
    for vid in vid_fnames:
        fnames_2d[get_video_name(config, vid)].append(vid)

    calib_folder = find_calibration_folder(config, session_path)
    if calib_folder is None:
        print(f"session {session_path}: no calibration found, skipping")
        return []
    calib_fname = os.path.join(calib_folder, pipe["calibration_results"],
                               "calibration.toml")

    from macaque_tpu_torch.compat.aniposelib import CameraGroup

    cgroup_full = CameraGroup.load(calib_fname, device, dtype)
    outdir = os.path.join(session_path, pipe["pose_2d_projected"])
    os.makedirs(outdir, exist_ok=True)

    written = []
    for pose_fname in pose_fnames:
        basename = true_basename(pose_fname)
        vids = sorted(fnames_2d[basename], key=natural_keys)
        if not vids:
            print(pose_fname, "missing raw videos")
            continue
        out_fnames = [os.path.join(outdir, true_basename(v) + ".h5")
                      for v in vids]
        if all(os.path.exists(f) for f in out_fnames):
            continue
        cam_names = [get_cam_name(config, v) for v in vids]
        offsets_dict = load_offsets_dict(config, cam_names)
        cgroup = cgroup_full.subset_cameras_names(cam_names)
        bodyparts, proj, scores = get_projected_points(
            config, pose_fname, cgroup, offsets_dict)
        for cix, outname in enumerate(out_fnames):
            write_pose2d(proj[cix].swapaxes(0, 1), scores.T, bodyparts,
                         outname)
            written.append(outname)
    return written


def project_2d_all(config: dict, device=None,
                   dtype: torch.dtype = torch.float32) -> dict:
    return process_all(config, process_session_project_2d, device=device,
                       dtype=dtype)


# --------------------------------------------------------------------------
# summaries (reference summarize.py)
# --------------------------------------------------------------------------


def _summarize(config: dict, subdir_key: str, pattern: str,
               output_fname: str, loader) -> str:
    import pandas as pd

    def session_fnames(config, session_path):
        return sorted(glob(os.path.join(
            session_path, config["pipeline"][subdir_key], pattern)),
            key=natural_keys)

    output = process_all(config, session_fnames)
    datas = []
    for key, fnames in sorted(output.items()):
        for fname in fnames:
            d = loader(fname)
            for num, folder in enumerate(key, start=1):
                d[f"folder_{num}"] = folder
            d["filename"] = true_basename(fname)
            datas.append(d)
    if not datas:
        raise FileNotFoundError(
            f"no {pattern} files under any session's "
            f"{config['pipeline'][subdir_key]}")
    dout = pd.concat(datas)
    dout["project"] = config["project"]

    outdir = os.path.join(config["path"], config["pipeline"]["summaries"])
    os.makedirs(outdir, exist_ok=True)
    outname = os.path.join(outdir, output_fname)
    dout.to_csv(outname, index=False)
    return outname


def _load_csv(fname):
    import pandas as pd

    return pd.read_csv(fname)


def _load_pose2d_as_frame(fname):
    import pandas as pd

    d = read_pose2d(fname)
    cols = {}
    for j, bp in enumerate(d["bodyparts"]):
        cols[f"{bp}_x"] = d["points"][:, j, 0]
        cols[f"{bp}_y"] = d["points"][:, j, 1]
        cols[f"{bp}_likelihood"] = d["scores"][:, j]
    return pd.DataFrame(cols)


def summarize_pose3d(config: dict) -> str:
    return _summarize(config, "pose_3d", "*.csv", "pose_3d.csv",
                      _load_csv)


def summarize_pose3d_filtered(config: dict) -> str:
    return _summarize(config, "pose_3d_filter", "*.csv",
                      "pose_3d_filtered.csv", _load_csv)


def summarize_angles(config: dict) -> str:
    return _summarize(config, "angles", "*.csv", "angles.csv", _load_csv)


def summarize_pose2d(config: dict) -> str:
    return _summarize(config, "pose_2d", "*.h5", "pose_2d.csv",
                      _load_pose2d_as_frame)


def summarize_pose2d_filtered(config: dict) -> str:
    return _summarize(config, "pose_2d_filter", "*.h5",
                      "pose_2d_filtered.csv", _load_pose2d_as_frame)


def summarize_errors(config: dict) -> str:
    """Per-file interpolation rates of the filtered 2D pose (reference
    summarize.py:97-136); requires filtered files carrying an
    ``interpolated`` flag array."""
    import pandas as pd

    def session_fnames(config, session_path):
        return sorted(glob(os.path.join(
            session_path, config["pipeline"]["pose_2d_filter"], "*.h5")),
            key=natural_keys)

    output = process_all(config, session_fnames)
    rows = []
    for key, fnames in sorted(output.items()):
        for fname in fnames:
            d = read_pose2d(fname)
            interp = d.get("interpolated")
            if interp is None:
                interp = np.isnan(d["points"][..., 0])
            row = {bp: float(np.mean(interp[:, j]))
                   for j, bp in enumerate(d["bodyparts"])}
            for num, folder in enumerate(key, start=1):
                row[f"folder_{num}"] = folder
            row["filename"] = true_basename(fname)
            row["cam_name"] = get_cam_name(config, fname)
            rows.append(row)
    dout = pd.DataFrame(rows)
    dout["project"] = config["project"]
    outdir = os.path.join(config["path"], config["pipeline"]["summaries"])
    os.makedirs(outdir, exist_ok=True)
    outname = os.path.join(outdir, "errors.csv")
    dout.to_csv(outname, index=False)
    return outname


# --------------------------------------------------------------------------
# tracking errors vs labeled ground truth (reference tracking_errors.py)
# --------------------------------------------------------------------------


def get_tracking_errors(config: dict, labeled_dir: str = "labeled-data",
                        output_fname: Optional[str] = None, device=None,
                        dtype: torch.dtype = torch.float32) -> str:
    """Compare predicted 3D poses against human-labeled 2D annotations:
    triangulate the labels, undo the prediction CSV's coordinate-frame
    correction, report per-bodypart L2 + reprojection errors
    (reference tracking_errors.py:28-184).

    Layout: ``<labeled_dir>/<video>--<cam>/`` with ``labels.h5``
    (pose-2d format) and ``anipose_metadata.csv`` columns
    [framenum, calib, video, img]. The labels are triangulated on
    ``device`` in ``dtype``.
    """
    import pandas as pd

    from macaque_tpu_torch.compat.aniposelib import CameraGroup

    group_folders = defaultdict(list)
    for folder in get_folders(labeled_dir):
        group, _, cname = folder.rpartition("--")
        group_folders[group].append((cname, folder))

    datas = []
    for group, ffs in sorted(group_folders.items()):
        fnames_dict, metadatas = {}, {}
        for cname, folder in ffs:
            fnames_dict[cname] = os.path.join(labeled_dir, folder,
                                              "labels.h5")
            metadatas[cname] = pd.read_csv(os.path.join(
                labeled_dir, folder, "anipose_metadata.csv"))
        cam_names = sorted(fnames_dict.keys())
        offsets_dict = load_offsets_dict(config, cam_names)
        out = load_pose2d_fnames(fnames_dict, offsets_dict, cam_names)
        points_labeled = out["points"]      # (C, F, J, 2)
        bodyparts = out["bodyparts"]
        metadata = metadatas[cam_names[0]]
        n_frames, n_joints = len(metadata), len(bodyparts)

        pose_3d_dirname = config["pipeline"][
            "pose_3d_filter" if config["filter3d"]["enabled"]
            else "pose_3d"]

        points_3d_pred = np.full((n_frames, n_joints, 3), np.nan)
        reproj_err_pred = np.full((n_frames, n_joints), np.nan)
        paths_3d = []
        cache = {}
        for i in range(n_frames):
            row = metadata.iloc[i]
            prefix = os.path.dirname(os.path.dirname(row["video"]))
            vidname = get_video_name(config, row["video"])
            pose_path = os.path.join(prefix, pose_3d_dirname,
                                     vidname + ".csv")
            paths_3d.append(pose_path)
            if pose_path not in cache:
                cache[pose_path] = pd.read_csv(pose_path)
            pose = cache[pose_path]
            hit = np.where(np.asarray(pose["fnum"]) ==
                           row["framenum"])[0]
            if len(hit) == 0:
                print(f"W: frame {row['framenum']} not found in 3D "
                      f"data for video {row['video']}")
                continue
            prow = pose.iloc[hit[0]]
            M = np.array([[prow[f"M_{i2}{j2}"] for j2 in range(3)]
                          for i2 in range(3)])
            center = np.array([prow[f"center_{i2}"] for i2 in range(3)])
            pts = np.array([(prow[f"{bp}_x"], prow[f"{bp}_y"],
                             prow[f"{bp}_z"]) for bp in bodyparts])
            points_3d_pred[i] = (pts + center) @ np.linalg.inv(M.T)
            reproj_err_pred[i] = [prow[f"{bp}_error"]
                                  for bp in bodyparts]

        points_3d_labeled = np.full((n_frames, n_joints, 3), np.nan)
        reproj_err_labeled = np.full((n_frames, n_joints), np.nan)
        cgroups = {}
        for i in range(n_frames):
            calib_fname = metadata.iloc[i]["calib"]
            if calib_fname not in cgroups:
                cg = CameraGroup.load(calib_fname, device, dtype)
                cgroups[calib_fname] = cg.subset_cameras_names(cam_names)
            cg = cgroups[calib_fname]
            pts = points_labeled[:, i]
            p3d = cg.triangulate(pts)
            points_3d_labeled[i] = p3d
            reproj_err_labeled[i] = cg.reprojection_error(p3d, pts,
                                                          mean=True)

        errors = np.linalg.norm(points_3d_labeled - points_3d_pred,
                                axis=2)

        dd = pd.DataFrame()
        dd["pose_path"] = paths_3d
        dd["framenum"] = metadata["framenum"]
        dd["calib"] = metadata["calib"]
        if "img" in metadata:
            dd["img"] = metadata["img"]
        dd["video"] = metadata["video"]
        # joint angles on both reconstructions (reference
        # tracking_errors.py:124-143; spec from config['angles'])
        from macaque_tpu_torch.tools.angles import get_angles

        angles_spec = config.get("angles", {})
        if angles_spec:
            a_pred = get_angles(
                {bp: points_3d_pred[:, j]
                 for j, bp in enumerate(bodyparts)}, angles_spec)
            a_lab = get_angles(
                {bp: points_3d_labeled[:, j]
                 for j, bp in enumerate(bodyparts)}, angles_spec)
            for name in sorted(a_pred):
                dd[f"{name}_lab"] = a_lab[name]
                dd[f"{name}_pred"] = a_pred[name]
                dd[f"{name}_error"] = a_pred[name] - a_lab[name]
        for j, bp in enumerate(bodyparts):
            dd[f"{bp}_x_lab"] = points_3d_labeled[:, j, 0]
            dd[f"{bp}_y_lab"] = points_3d_labeled[:, j, 1]
            dd[f"{bp}_z_lab"] = points_3d_labeled[:, j, 2]
            dd[f"{bp}_reprojerr_lab"] = reproj_err_labeled[:, j]
            dd[f"{bp}_x_pred"] = points_3d_pred[:, j, 0]
            dd[f"{bp}_y_pred"] = points_3d_pred[:, j, 1]
            dd[f"{bp}_z_pred"] = points_3d_pred[:, j, 2]
            dd[f"{bp}_reprojerr_pred"] = reproj_err_pred[:, j]
            dd[f"{bp}_error"] = errors[:, j]
        datas.append(dd)

    data = pd.concat(datas)
    if output_fname is None:
        outdir = os.path.join(config["path"],
                              config["pipeline"]["summaries"])
        os.makedirs(outdir, exist_ok=True)
        output_fname = os.path.join(outdir, "tracking_errors.csv")
    data.to_csv(output_fname, index=False)
    return output_fname


# --------------------------------------------------------------------------
# labeled-video rendering (reference label_videos.py semantics)
# --------------------------------------------------------------------------


def label_video(vid_fname: str, pose_fname: str, out_fname: str,
                scheme: Optional[list] = None,
                score_threshold: float = 0.1) -> str:
    """Draw 2D pose points + skeleton scheme onto a video."""
    import cv2

    d = read_pose2d(pose_fname)
    points, scores = d["points"], d["scores"]
    bp_index = {b: i for i, b in enumerate(d["bodyparts"])}
    scheme_ix = [[bp_index[b] for b in line if b in bp_index]
                 for line in (scheme or [])]

    cap = cv2.VideoCapture(vid_fname)
    if not cap.isOpened():
        raise FileNotFoundError(vid_fname)
    fps = cap.get(cv2.CAP_PROP_FPS) or 24.0
    W = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    H = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    vw = cv2.VideoWriter(out_fname, cv2.VideoWriter_fourcc(*"mp4v"),
                         fps, (W, H))
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok or i >= points.shape[0]:
            break
        pts = points[i]
        ok_pt = (~np.isnan(pts[:, 0])) & (scores[i] > score_threshold)
        for line in scheme_ix:
            for a, b in zip(line[:-1], line[1:]):
                if ok_pt[a] and ok_pt[b]:
                    cv2.line(frame, tuple(pts[a].astype(int)),
                             tuple(pts[b].astype(int)), (0, 255, 255), 2)
        for j in np.where(ok_pt)[0]:
            cv2.circle(frame, tuple(pts[j].astype(int)), 4,
                       (0, 0, 255), -1)
        vw.write(frame)
        i += 1
    vw.release()
    cap.release()
    return out_fname


def process_session_label_videos(config: dict, session_path: str):
    """Render videos-labeled for every recording with both a raw video
    and a pose-2d file."""
    pipe = config["pipeline"]
    video_ext = config["video_extension"]
    pose_dirname = pipe["pose_2d_filter"] if config["filter"]["enabled"] \
        else pipe["pose_2d"]

    outdir = os.path.join(session_path, pipe["videos_labeled_2d"])
    scheme = config.get("labeling", {}).get("scheme", [])
    written = []
    for vid in sorted(glob(os.path.join(
            session_path, pipe["videos_raw"], "*." + video_ext)),
            key=natural_keys):
        pose_fname = os.path.join(session_path, pose_dirname,
                                  true_basename(vid) + ".h5")
        if not os.path.exists(pose_fname):
            continue
        os.makedirs(outdir, exist_ok=True)
        out_fname = os.path.join(outdir, true_basename(vid) + ".mp4")
        if os.path.exists(out_fname):
            continue
        written.append(label_video(vid, pose_fname, out_fname, scheme))
    return written


def label_videos_all(config: dict) -> dict:
    return process_all(config, process_session_label_videos)


# --------------------------------------------------------------------------
# session angles (reference compute_angles.py session driver)
# --------------------------------------------------------------------------


def process_session_angles(config: dict, session_path: str):
    """Compute named joint angles from each pose-3d CSV into the angles
    folder (columns: fnum + one per configured angle)."""
    import pandas as pd

    pipe = config["pipeline"]
    angles_spec = config.get("angles", {})
    if not angles_spec:
        return []
    outdir = os.path.join(session_path, pipe["angles"])
    written = []
    for fname in sorted(glob(os.path.join(
            session_path, pipe["pose_3d"], "*.csv")), key=natural_keys):
        os.makedirs(outdir, exist_ok=True)
        out_fname = os.path.join(outdir,
                                 true_basename(fname) + ".csv")
        if os.path.exists(out_fname):
            continue
        pose = pd.read_csv(fname)
        cols = [x for x in pose.columns if "_error" in x]
        bodyparts = [c.replace("_error", "") for c in cols]
        pts = {bp: np.asarray(
            pose.loc[:, (f"{bp}_x", f"{bp}_y", f"{bp}_z")])
            for bp in bodyparts}
        dout = pd.DataFrame()
        dout["fnum"] = pose["fnum"]
        for name, (a, v, b) in angles_spec.items():
            u1 = pts[a] - pts[v]
            u2 = pts[b] - pts[v]
            cosang = np.sum(u1 * u2, axis=1) / (
                np.linalg.norm(u1, axis=1) * np.linalg.norm(u2, axis=1))
            dout[name] = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
        dout.to_csv(out_fname, index=False)
        written.append(out_fname)
    return written


def angles_all(config: dict) -> dict:
    return process_all(config, process_session_angles)
