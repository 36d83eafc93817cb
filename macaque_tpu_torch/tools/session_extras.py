"""Remaining anipose CLI surface: worst-frame mining for relabeling,
combined 2D+3D videos, 3D-scatter videos, reprojected-2D videos,
2D-pose backfill, video conversion, and calibration-error reports.

Reference files covered (src/third_party/anipose/):
  * ``extract_frames.py`` (:229-364 random, :364-546 picked/worst-frame)
  * ``label_combined.py`` (:137-416 combined layout + writer)
  * ``label_videos_3d.py`` (:46-151 3D scatter animation)
  * ``label_videos_proj.py`` (:27-122 label from reprojected 3D)
  * ``pose_videos.py`` (:22-72 run 2D pose where missing)
  * ``convert_videos.py`` (:28-80 re-encode session videos)
  * ``calibration_errors.py`` (:28-206 pairwise triangulation errors)

Port of ``macaque_tpu/tools/session_extras.py``. Data model follows
:mod:`macaque_tpu_torch.tools.session` (plain-h5 pose2d files,
per-bodypart 3D CSVs); rendering uses cv2 + matplotlib-Agg (no skvideo /
DLC dependency — this framework has its own pose stack). The
reprojections and the pairwise triangulations run through the port's
``CameraGroup`` on ``device`` (the card when None) in ``dtype``; pandas,
h5py, cv2 and matplotlib are imported by the functions that use them.
"""

from __future__ import annotations

import os
from collections import defaultdict
from glob import glob
from typing import Optional

import numpy as np
import torch

from macaque_tpu_torch.tools.session import (
    find_calibration_folder, get_cam_name, get_video_name,
    load_offsets_dict, load_pose2d_fnames, natural_keys, process_all,
    read_pose2d, true_basename, write_pose2d, get_projected_points,
    label_video,
)


# --------------------------------------------------------------------------
# shared loading
# --------------------------------------------------------------------------


def _session_recordings(config: dict, session_path: str):
    """Yield per-recording dicts: videos, pose2d files, pose3d csv,
    calibration folder (None entries where missing)."""
    pipe = config["pipeline"]
    video_ext = config["video_extension"]
    vids = sorted(glob(os.path.join(session_path, pipe["videos_raw"],
                                    "*." + video_ext)), key=natural_keys)
    by_name = defaultdict(list)
    for v in vids:
        by_name[get_video_name(config, v)].append(v)

    calib = find_calibration_folder(config, session_path)
    calib_fname = None
    if calib is not None:
        calib_fname = os.path.join(calib, pipe["calibration_results"],
                                   "calibration.toml")
    for name in sorted(by_name, key=natural_keys):
        vids_r = sorted(by_name[name], key=natural_keys)
        pose2d = {
            get_cam_name(config, v): os.path.join(
                session_path, pipe["pose_2d"], true_basename(v) + ".h5")
            for v in vids_r
        }
        pose2d = {c: f for c, f in pose2d.items() if os.path.exists(f)}
        p3d = os.path.join(session_path, pipe["pose_3d"], name + ".csv")
        yield dict(
            name=name, videos=vids_r,
            pose2d=pose2d,
            pose3d=p3d if os.path.exists(p3d) else None,
            calib_fname=calib_fname,
        )


def load_2d_data(config: dict, device=None,
                 dtype: torch.dtype = torch.float32):
    """All recordings of the project with both 2D and 3D results:
    detected points, projected (reprojected-from-3D) points, scores and
    source video filenames (reference extract_frames.py:102-176); the
    projections on ``device``."""
    from macaque_tpu_torch.compat.aniposelib import CameraGroup

    out = dict(points=[], proj=[], scores=[], fnames=[], cam_names=None,
               calib_fnames=[], bodyparts=None)

    def per_session(config, session_path):
        for rec in _session_recordings(config, session_path):
            if rec["pose3d"] is None or not rec["pose2d"] \
                    or rec["calib_fname"] is None:
                continue
            cam_names = sorted(rec["pose2d"].keys())
            offsets = load_offsets_dict(config, cam_names)
            d = load_pose2d_fnames(rec["pose2d"], offsets, cam_names)
            cgroup = CameraGroup.load(rec["calib_fname"], device, dtype) \
                .subset_cameras_names(cam_names)
            bodyparts, proj, _ = get_projected_points(
                config, rec["pose3d"], cgroup, offsets)
            # proj: (C, J, F, 2) -> (C, F, J, 2) to match points
            out["points"].append(d["points"])
            out["proj"].append(proj.swapaxes(1, 2))
            out["scores"].append(d["scores"])
            out["fnames"].append([v for v in rec["videos"]
                                  if get_cam_name(config, v) in cam_names])
            out["calib_fnames"].append(rec["calib_fname"])
            out["cam_names"] = cam_names
            out["bodyparts"] = bodyparts
        return []

    process_all(config, per_session)
    return out


# --------------------------------------------------------------------------
# worst-frame mining (reference extract_frames.py)
# --------------------------------------------------------------------------


def pick_frames(errors: np.ndarray, vidnums: np.ndarray,
                framenums: np.ndarray, mode: str = "bad",
                num_frames_pick: int = 250, spacing: int = 10,
                rng: Optional[np.random.Generator] = None):
    """Rank frames by reprojection error with the reference's jittered
    log-error ordering, enforcing >= ``spacing`` frames between picks of
    the same video (extract_frames.py:415-446)."""
    if rng is None:
        rng = np.random.default_rng(0)
    errors = np.asarray(errors, float).copy()
    good = np.isfinite(errors)
    if not good.any():
        return []
    errors[~good] = np.max(errors[good]) * 0.5

    if mode == "bad":
        log_errors = np.log(errors + 0.1)
        log_errors = np.clip(log_errors, -np.inf,
                             np.percentile(log_errors, 85))
        spread = np.max(log_errors) - np.percentile(log_errors, 60)
        noise = rng.uniform(0, max(spread, 1e-9), size=errors.shape)
        order = np.argsort(-log_errors + noise)
    elif mode == "good":
        spread = np.percentile(errors, 20)
        noise = rng.uniform(-spread, spread, size=errors.shape)
        order = np.argsort(errors + noise)
    elif mode == "random":
        order = rng.permutation(len(errors))
    else:
        raise ValueError(f"mode must be bad/good/random, got {mode!r}")

    check = np.ones(errors.shape[0], bool)
    picked = []
    for ix in order:
        if not check[ix]:
            continue
        similar = (vidnums == vidnums[ix]) & \
            (np.abs(framenums - framenums[ix]) <= spacing)
        check[similar] = False
        picked.append((int(vidnums[ix]), int(framenums[ix])))
        if len(picked) >= num_frames_pick:
            break
    return sorted(picked)


def extract_frames(config: dict, mode: str = "bad",
                   num_frames_pick: int = 250, seed: int = 0,
                   spacing: int = 10, device=None,
                   dtype: torch.dtype = torch.float32) -> list[str]:
    """Mine frames for relabeling: rank every tracked frame by mean
    2D-vs-reprojected error, pick a spaced subset, and write per-camera
    ``labeled-data/<project>_<mode>--<cam>/imgNNN.png`` plus an
    ``annotations.csv`` (bodypart x/y from the current 2D detections,
    to correct) and a ``frames.csv`` provenance table
    (reference extract_frames.py:364-546; the reference writes
    DLC-format pandas HDF — this framework writes plain CSVs). The
    reprojections run on ``device``."""
    import cv2
    import pandas as pd

    d = load_2d_data(config, device, dtype)
    if not d["points"]:
        print("extract_frames: no tracked recordings found")
        return []

    nums = [p.shape[1] for p in d["points"]]
    vidnums = np.concatenate([np.full(n, i) for i, n in enumerate(nums)])
    framenums = np.concatenate([np.arange(n) for n in nums])
    errors = np.concatenate([
        # mean over cameras and joints of the 2D<->reprojection distance
        np.nanmean(np.linalg.norm(p - q, axis=3), axis=(0, 2))
        for p, q in zip(d["points"], d["proj"])
    ])

    rng = np.random.default_rng(seed)
    picked = pick_frames(errors, vidnums, framenums, mode,
                         num_frames_pick, spacing=spacing, rng=rng)
    if not picked:
        return []

    nd = int(np.log10(max(len(picked), 1)) + 1)
    img_fmt = "img{:0" + str(nd) + "d}.png"
    folder_base = "{}_{}".format(config["project"], mode)
    root = config["path"]
    cam_names = d["cam_names"]
    bodyparts = d["bodyparts"]

    written = []
    for cnum, cam in enumerate(cam_names):
        folder = os.path.join(root, "labeled-data",
                              f"{folder_base}--{cam}")
        os.makedirs(folder, exist_ok=True)
        rows, meta = [], []
        cap_cache: dict[int, object] = {}
        for i, (vnum, fnum) in enumerate(picked):
            if vnum not in cap_cache:
                cap_cache[vnum] = cv2.VideoCapture(
                    d["fnames"][vnum][cnum])
            cap = cap_cache[vnum]
            cap.set(cv2.CAP_PROP_POS_FRAMES, fnum)
            ok, frame = cap.read()
            img_name = img_fmt.format(i)
            if ok:
                cv2.imwrite(os.path.join(folder, img_name), frame)
            row = {"img": img_name}
            for j, bp in enumerate(bodyparts):
                pt = d["points"][vnum][cnum, fnum, j]
                row[f"{bp}_x"] = float(pt[0])
                row[f"{bp}_y"] = float(pt[1])
            rows.append(row)
            meta.append({"img": img_name,
                         "calib": d["calib_fnames"][vnum],
                         "video": d["fnames"][vnum][cnum],
                         "framenum": fnum})
        for cap in cap_cache.values():
            cap.release()
        pd.DataFrame(rows).to_csv(
            os.path.join(folder, "annotations.csv"), index=False)
        pd.DataFrame(meta).to_csv(
            os.path.join(folder, "frames.csv"), index=False)
        written.append(folder)
    return written


# --------------------------------------------------------------------------
# 3D scatter video (reference label_videos_3d.py)
# --------------------------------------------------------------------------


def _pose3d_arrays(pose_fname: str):
    import pandas as pd

    data = pd.read_csv(pose_fname)
    cols = [c for c in data.columns if c.endswith("_error")]
    bodyparts = [c[: -len("_error")] for c in cols]
    pts = np.stack([
        np.asarray(data.loc[:, (f"{b}_x", f"{b}_y", f"{b}_z")])
        for b in bodyparts
    ], axis=1)                                    # (F, J, 3)
    return bodyparts, pts


def render_video_3d(pose_fname: str, out_fname: str,
                    scheme: Optional[list] = None, fps: float = 24.0,
                    size: tuple[int, int] = (640, 480),
                    max_frames: Optional[int] = None) -> str:
    """3D skeleton animation from a pose-3d CSV -> mp4 (reference
    label_videos_3d.py:46-151, matplotlib 3D axes)."""
    import cv2
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    bodyparts, pts = _pose3d_arrays(pose_fname)
    bp_ix = {b: i for i, b in enumerate(bodyparts)}
    scheme_ix = [[bp_ix[b] for b in line if b in bp_ix]
                 for line in (scheme or [])]
    F = pts.shape[0] if max_frames is None else min(max_frames,
                                                    pts.shape[0])
    lo = np.nanpercentile(pts.reshape(-1, 3), 5, axis=0)
    hi = np.nanpercentile(pts.reshape(-1, 3), 95, axis=0)
    pad = 0.1 * (hi - lo + 1e-6)
    lo, hi = lo - pad, hi + pad

    fig = plt.figure(figsize=(size[0] / 100, size[1] / 100), dpi=100)
    ax = fig.add_subplot(111, projection="3d")
    vw = cv2.VideoWriter(out_fname, cv2.VideoWriter_fourcc(*"mp4v"),
                         fps, size)
    cmap = plt.get_cmap("tab10")
    for f in range(F):
        ax.cla()
        ax.set_xlim(lo[0], hi[0])
        ax.set_ylim(lo[1], hi[1])
        ax.set_zlim(lo[2], hi[2])
        p = pts[f]
        ok = ~np.isnan(p[:, 0])
        ax.scatter(p[ok, 0], p[ok, 1], p[ok, 2], s=12, c="crimson")
        for li, line in enumerate(scheme_ix):
            for a, b in zip(line[:-1], line[1:]):
                if ok[a] and ok[b]:
                    ax.plot(*np.stack([p[a], p[b]]).T,
                            color=cmap(li % 10))
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        frame = cv2.resize(buf, size)
        vw.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    vw.release()
    plt.close(fig)
    return out_fname


def process_session_label_3d(config: dict, session_path: str,
                             filtered: bool = False):
    pipe = config["pipeline"]
    key = "pose_3d_filter" if filtered else "pose_3d"
    outdir = os.path.join(session_path,
                          pipe.get("videos_labeled_3d", "videos-3d"))
    scheme = config.get("labeling", {}).get("scheme", [])
    written = []
    for pose_fname in sorted(glob(os.path.join(
            session_path, pipe[key], "*.csv")), key=natural_keys):
        os.makedirs(outdir, exist_ok=True)
        out = os.path.join(outdir, true_basename(pose_fname) + ".mp4")
        if os.path.exists(out):
            continue
        written.append(render_video_3d(pose_fname, out, scheme))
    return written


def label_videos_3d_all(config: dict) -> dict:
    return process_all(config, process_session_label_3d)


# --------------------------------------------------------------------------
# reprojected-2D videos (reference label_videos_proj.py)
# --------------------------------------------------------------------------


def process_session_label_proj(config: dict, session_path: str):
    """Label raw videos with the REPROJECTED 3D pose (pose-2d-proj h5,
    produced by project-2d) instead of the raw detections."""
    pipe = config["pipeline"]
    video_ext = config["video_extension"]
    outdir = os.path.join(
        session_path, pipe.get("videos_labeled_2d_proj",
                               "videos-labeled-proj"))
    scheme = config.get("labeling", {}).get("scheme", [])
    written = []
    for vid in sorted(glob(os.path.join(
            session_path, pipe["videos_raw"], "*." + video_ext)),
            key=natural_keys):
        pose_fname = os.path.join(session_path, pipe["pose_2d_projected"],
                                  true_basename(vid) + ".h5")
        if not os.path.exists(pose_fname):
            continue
        os.makedirs(outdir, exist_ok=True)
        out = os.path.join(outdir, true_basename(vid) + ".mp4")
        if os.path.exists(out):
            continue
        written.append(label_video(vid, pose_fname, out, scheme,
                                   score_threshold=-np.inf))
    return written


def label_videos_proj_all(config: dict) -> dict:
    return process_all(config, process_session_label_proj)


# --------------------------------------------------------------------------
# raw vs labeled vs filtered comparison video (reference
# label_filter_compare.py:42-203: three stacked rows — raw frames,
# frames with raw-detection labels, frames with filtered labels — all
# cameras side by side)
# --------------------------------------------------------------------------


def _draw_pose(frame, pts, scores, scheme_ix, score_threshold=0.1):
    import cv2

    out = frame.copy()
    ok_pt = (~np.isnan(pts[:, 0])) & (scores > score_threshold)
    for line in scheme_ix:
        for a, b in zip(line[:-1], line[1:]):
            if ok_pt[a] and ok_pt[b]:
                cv2.line(out, tuple(pts[a].astype(int)),
                         tuple(pts[b].astype(int)), (0, 255, 255), 2)
    for j in np.where(ok_pt)[0]:
        cv2.circle(out, tuple(pts[j].astype(int)), 4, (0, 0, 255), -1)
    return out


def render_filter_compare(vid_fnames: list, pose_fnames: list,
                          pose_filt_fnames: list, out_fname: str,
                          scheme=None, row_height: int = 320) -> str:
    """One recording -> comparison video: row 1 raw, row 2 labeled with
    raw detections, row 3 labeled with filtered detections; cameras
    hstacked per row (reference label_filter_compare.py draw_data)."""
    import cv2

    caps = [cv2.VideoCapture(v) for v in vid_fnames]
    poses = [read_pose2d(f) for f in pose_fnames]
    poses_f = [read_pose2d(f) for f in pose_filt_fnames]
    bodyparts = poses[0]["bodyparts"]
    bp_index = {b: i for i, b in enumerate(bodyparts)}
    scheme_ix = [[bp_index[b] for b in line if b in bp_index]
                 for line in (scheme or [])]

    widths = []
    for cap in caps:
        w = cap.get(cv2.CAP_PROP_FRAME_WIDTH) or 1
        h = cap.get(cv2.CAP_PROP_FRAME_HEIGHT) or 1
        widths.append(int(round(w * row_height / h)))
    W, H = sum(widths), row_height * 3
    fps = caps[0].get(cv2.CAP_PROP_FPS) or 24.0
    nframes = min(min(int(c.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
                      for c in caps),
                  min(p["points"].shape[0] for p in poses),
                  min(p["points"].shape[0] for p in poses_f))
    vw = cv2.VideoWriter(out_fname, cv2.VideoWriter_fourcc(*"mp4v"),
                         fps, (W, H))
    for i in range(nframes):
        rows = [[], [], []]
        for c, cap in enumerate(caps):
            ok, frame = cap.read()
            if not ok:
                break
            sz = (widths[c], row_height)
            rows[0].append(cv2.resize(frame, sz))
            rows[1].append(cv2.resize(_draw_pose(
                frame, poses[c]["points"][i], poses[c]["scores"][i],
                scheme_ix), sz))
            rows[2].append(cv2.resize(_draw_pose(
                frame, poses_f[c]["points"][i],
                poses_f[c]["scores"][i], scheme_ix), sz))
        else:
            vw.write(np.vstack([np.hstack(r) for r in rows]))
            continue
        break
    vw.release()
    for cap in caps:
        cap.release()
    return out_fname


def process_session_label_filter_compare(config: dict,
                                         session_path: str):
    """Comparison video for every recording that has both pose-2d and
    pose-2d-filtered results (reference label_filter_compare.py
    ``process_session``; skips existing)."""
    pipe = config["pipeline"]
    scheme = config.get("labeling", {}).get("scheme", [])
    outdir = os.path.join(session_path,
                          pipe.get("videos_compare", "videos-compare"))
    written = []
    for rec in _session_recordings(config, session_path):
        filt = {c: os.path.join(session_path, pipe["pose_2d_filter"],
                                os.path.basename(rec["pose2d"][c]))
                for c in rec["pose2d"]}
        filt = {c: f for c, f in filt.items() if os.path.exists(f)}
        # one camera-keyed pairing for videos/poses/filtered — indexing
        # three independently-sorted lists can cross camera streams
        # (lexicographic '10' < '2' vs natural file order)
        vid_by_cam = {get_cam_name(config, v): v for v in rec["videos"]}
        cams = [c for c in sorted(filt, key=natural_keys)
                if c in rec["pose2d"] and c in vid_by_cam]
        if not cams:
            continue
        os.makedirs(outdir, exist_ok=True)
        out = os.path.join(outdir, rec["name"] + ".mp4")
        if os.path.exists(out):
            continue
        written.append(render_filter_compare(
            [vid_by_cam[c] for c in cams],
            [rec["pose2d"][c] for c in cams],
            [filt[c] for c in cams], out, scheme))
    return written


def label_filter_compare_all(config: dict) -> dict:
    return process_all(config, process_session_label_filter_compare)


# --------------------------------------------------------------------------
# combined 2D + 3D video (reference label_combined.py)
# --------------------------------------------------------------------------


def render_combined(vid_fnames_2d: list[str], vid_fname_3d: str,
                    out_fname: str, fps: float = 24.0,
                    tile_width: int = 480) -> str:
    """Tile the per-camera labeled videos with the 3D animation into one
    video: 2D views in a grid on the left, 3D view on the right
    (reference label_combined.py:137-268 layout, without angle strips)."""
    import cv2

    caps = [cv2.VideoCapture(f) for f in vid_fnames_2d]
    cap3 = cv2.VideoCapture(vid_fname_3d)
    n2 = len(caps)
    cols = int(np.ceil(np.sqrt(n2)))
    rows = int(np.ceil(n2 / cols))

    w2 = tile_width
    r0 = caps[0].get(cv2.CAP_PROP_FRAME_HEIGHT) / \
        max(caps[0].get(cv2.CAP_PROP_FRAME_WIDTH), 1)
    h2 = int(w2 * (r0 or 0.75))
    H = rows * h2
    w3 = int(H * (cap3.get(cv2.CAP_PROP_FRAME_WIDTH) /
                  max(cap3.get(cv2.CAP_PROP_FRAME_HEIGHT), 1) or 4 / 3))
    W = cols * w2 + w3
    vw = cv2.VideoWriter(out_fname, cv2.VideoWriter_fourcc(*"mp4v"),
                         fps, (W, H))
    while True:
        frames = []
        ok_all = True
        for cap in caps:
            ok, fr = cap.read()
            ok_all &= ok
            frames.append(fr if ok else None)
        ok3, fr3 = cap3.read()
        if not ok_all or not ok3:
            break
        canvas = np.zeros((H, W, 3), np.uint8)
        for i, fr in enumerate(frames):
            r, c = divmod(i, cols)
            canvas[r * h2:(r + 1) * h2, c * w2:(c + 1) * w2] = \
                cv2.resize(fr, (w2, h2))
        canvas[0:H, cols * w2:] = cv2.resize(fr3, (w3, H))
        vw.write(canvas)
    vw.release()
    for cap in caps:
        cap.release()
    cap3.release()
    return out_fname


def process_session_label_combined(config: dict, session_path: str):
    pipe = config["pipeline"]
    labeled_dir = os.path.join(session_path, pipe["videos_labeled_2d"])
    dir3d = os.path.join(session_path,
                         pipe.get("videos_labeled_3d", "videos-3d"))
    outdir = os.path.join(
        session_path, pipe.get("videos_combined", "videos-combined"))
    by_name = defaultdict(list)
    for v in sorted(glob(os.path.join(labeled_dir, "*.mp4")),
                    key=natural_keys):
        by_name[get_video_name(config, v)].append(v)
    written = []
    for name in sorted(by_name, key=natural_keys):
        v3 = os.path.join(dir3d, name + ".mp4")
        if not os.path.exists(v3):
            continue
        os.makedirs(outdir, exist_ok=True)
        out = os.path.join(outdir, name + ".mp4")
        if os.path.exists(out):
            continue
        written.append(render_combined(by_name[name], v3, out))
    return written


def label_combined_all(config: dict) -> dict:
    return process_all(config, process_session_label_combined)


# --------------------------------------------------------------------------
# 2D pose backfill (reference pose_videos.py)
# --------------------------------------------------------------------------


def process_session_pose_videos(config: dict, session_path: str,
                                perception=None):
    """Run the 2D pose stack over raw videos that have no pose-2d file
    yet (reference pose_videos.py:22-72 runs DLC here; this framework
    runs its own detector+pose chunk programs via the supplied
    perception backend)."""
    import cv2

    if perception is None:
        raise ValueError("pose_videos needs a perception backend "
                         "(build_torch_perception(weights))")
    pipe = config["pipeline"]
    video_ext = config["video_extension"]
    outdir = os.path.join(session_path, pipe["pose_2d"])
    written = []
    for vid in sorted(glob(os.path.join(
            session_path, pipe["videos_raw"], "*." + video_ext)),
            key=natural_keys):
        out = os.path.join(outdir, true_basename(vid) + ".h5")
        if os.path.exists(out):
            continue
        os.makedirs(outdir, exist_ok=True)
        cap = cv2.VideoCapture(vid)
        pts_all, sc_all = [], []
        chunk = []

        def flush():
            if not chunk:
                return
            frames = np.stack(chunk)
            boxes, scores = perception.detect(frames)
            best = np.argmax(scores, axis=1)
            D = boxes.shape[1]
            tbl = np.zeros((len(chunk), D, 4), np.float32)
            valid = np.zeros((len(chunk), D), bool)
            for i, b in enumerate(best):
                if scores[i, b] > 0.5:
                    tbl[i, 0] = boxes[i, b]
                    valid[i, 0] = True
            kps = perception.pose(frames, tbl, valid)
            pts_all.extend(kps[:, 0, :, :2])
            sc_all.extend(np.where(valid[:, 0, None],
                                   kps[:, 0, :, 2], 0.0))
            chunk.clear()

        while True:
            ok, fr = cap.read()
            if not ok:
                break
            chunk.append(fr)
            if len(chunk) == 16:
                flush()
        flush()
        cap.release()
        if not pts_all:
            continue
        from macaque_tpu_torch.core.config import MACAQUE_BODYPARTS

        write_pose2d(np.asarray(pts_all), np.asarray(sc_all),
                     MACAQUE_BODYPARTS, out)
        written.append(out)
    return written


def pose_videos_all(config: dict, perception) -> dict:
    return process_all(
        config,
        lambda c, s: process_session_pose_videos(c, s, perception))


# --------------------------------------------------------------------------
# video conversion (reference convert_videos.py)
# --------------------------------------------------------------------------


def convert_video(fname: str, outname: str,
                  video_speed: float = 1.0) -> str:
    """Re-encode to mp4, optionally retiming playback speed
    (reference convert_videos.py:28-49, avconv/ffmpeg replaced with a
    cv2 transcode)."""
    import cv2

    cap = cv2.VideoCapture(fname)
    if not cap.isOpened():
        raise FileNotFoundError(fname)
    fps = (cap.get(cv2.CAP_PROP_FPS) or 24.0) * video_speed
    W = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    H = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    vw = cv2.VideoWriter(outname, cv2.VideoWriter_fourcc(*"mp4v"),
                         fps, (W, H))
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        vw.write(fr)
    vw.release()
    cap.release()
    return outname


def process_session_convert(config: dict, session_path: str):
    pipe = config["pipeline"]
    speed = config.get("converted_video_speed", 1.0)
    src_dir = os.path.join(session_path,
                           pipe.get("videos_raw_mp4", "videos-raw-mp4"))
    raw_dir = os.path.join(session_path, pipe["videos_raw"])
    written = []
    for vid in sorted(glob(os.path.join(
            raw_dir, "*." + config["video_extension"])),
            key=natural_keys):
        os.makedirs(src_dir, exist_ok=True)
        out = os.path.join(src_dir, true_basename(vid) + ".mp4")
        if os.path.exists(out):
            continue
        written.append(convert_video(vid, out, speed))
    return written


def convert_videos_all(config: dict) -> dict:
    return process_all(config, process_session_convert)


# --------------------------------------------------------------------------
# calibration errors (reference calibration_errors.py)
# --------------------------------------------------------------------------


def calibration_errors_session(config: dict, session_path: str,
                               skip: int = 20, device=None,
                               dtype: torch.dtype = torch.float32):
    """Pairwise calibration check: detect the board in every calibration
    video, triangulate each common detection from every CAMERA PAIR, and
    report per-pair reprojection error rows (reference
    calibration_errors.py:28-154), the triangulations on ``device``.
    Returns the CSV path (or [])."""
    import itertools

    import pandas as pd

    from macaque_tpu_torch.calib.videos import (
        Checkerboard, CharucoBoard, detect_board_video, merge_rows,
        extract_points,
    )
    from macaque_tpu_torch.compat.aniposelib import CameraGroup

    pipe = config["pipeline"]
    calib_cfg = config.get("calibration", {})
    calib_dir = os.path.join(session_path, pipe["calibration_results"])
    calib_toml = os.path.join(calib_dir, "calibration.toml")
    vids = sorted(glob(os.path.join(
        session_path, pipe.get("calibration_videos", "calibration"),
        "*." + config["video_extension"])), key=natural_keys)
    if not os.path.exists(calib_toml) or not vids:
        return []

    if calib_cfg.get("board_type", "checkerboard") == "charuco":
        board = CharucoBoard(
            calib_cfg.get("board_size", [10, 7])[0],
            calib_cfg.get("board_size", [10, 7])[1],
            square_length=calib_cfg.get("board_square_side_length", 25),
        )
    else:
        bs = calib_cfg.get("board_size", [9, 6])
        board = Checkerboard(bs[0], bs[1],
                             calib_cfg.get("board_square_side_length", 25))

    cgroup = CameraGroup.load(calib_toml, device, dtype)
    cam_names = cgroup.get_names()
    by_cam = {get_cam_name(config, v): v for v in vids}
    use = [c for c in cam_names if c in by_cam]
    if len(use) < 2:
        return []
    cgroup = cgroup.subset_cameras_names(use)

    all_rows = [detect_board_video(by_cam[c], board, skip=skip)
                for c in use]
    merged = merge_rows(all_rows, cam_names=use)
    # pairwise triangulation needs only the 2D corners, not board poses
    imgp, extra = extract_points(merged, board, cam_names=use,
                                 min_cameras=2, check_rtvecs=False)
    if imgp.shape[1] == 0:
        return []

    rows = []
    n_cam = len(use)
    for i, j in itertools.combinations(range(n_cam), 2):
        sub = cgroup.subset_cameras([i, j])
        pts = imgp[[i, j]]
        ok = (~np.isnan(pts[..., 0])).all(axis=0)
        if ok.sum() == 0:
            continue
        p3d = sub.triangulate(pts[:, ok])
        err = sub.reprojection_error(p3d, pts[:, ok], mean=True)
        rows.append({
            "cam_A": use[i], "cam_B": use[j],
            "n_points": int(ok.sum()),
            "error_mean": float(np.nanmean(err)),
            "error_median": float(np.nanmedian(err)),
            "error_p95": float(np.nanpercentile(err, 95)),
        })
    out = os.path.join(calib_dir, "calibration_errors.csv")
    pd.DataFrame(rows).to_csv(out, index=False)
    return [out]


def calibration_errors_all(config: dict, device=None,
                           dtype: torch.dtype = torch.float32) -> dict:
    return process_all(config, calibration_errors_session, device=device,
                       dtype=dtype)
