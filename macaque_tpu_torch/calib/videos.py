"""Calibration-object detection over videos + multi-camera row merging.

This is the host-side front end of calibration-from-video: it turns
recorded board videos into per-view detected point arrays that feed the
JAX solvers in ``calib/bundle.py``. Covers the reference's

  * per-video detection loop with burst re-scanning after a hit
    (src/third_party/aniposelib/boards.py:306-347 ``detect_video``),
  * cross-camera frame grouping (boards.py:57-88 ``merge_rows``),
  * padded point extraction (boards.py:91-177 ``extract_points``) and
    board-pose extraction (boards.py:180-235 ``extract_rtvecs``),
  * the ``Checkerboard`` / ``CharucoBoard`` calibration objects
    (boards.py:389+, 525+).

Detection itself is OpenCV (host C++); everything downstream of the
(C, N, 2) arrays runs on device.

Port of ``macaque_tpu/calib/videos.py``: the same host code; imgstores are
read by the port's ``video/imgstore.py`` (RGBA chunks without cv2), and
``estimate_pose_rows`` normalizes corners through the port's camera models.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from macaque_tpu_torch.calib.boards import chessboard_object_points


# --------------------------------------------------------------------------
# calibration objects
# --------------------------------------------------------------------------


@dataclass
class Checkerboard:
    """Plain chessboard with (cols x rows) inner corners (reference uses
    9x6 at 23 mm squares; multicam_toolbox.py:34-35, calib/config.yaml)."""

    cols: int = 9
    rows: int = 6
    square_size: float = 1.0

    @property
    def n_points(self) -> int:
        return self.cols * self.rows

    def object_points(self) -> np.ndarray:
        return chessboard_object_points(self.cols, self.rows,
                                        self.square_size)

    def empty_detection(self) -> np.ndarray:
        return np.full((self.n_points, 2), np.nan)

    def detect_image(self, img: np.ndarray):
        """Returns (corners (N,2), ids=None) or (None, None)."""
        from macaque_tpu_torch.calib.boards import find_chessboard_corners

        corners = find_chessboard_corners(img, self.cols, self.rows)
        if corners is None:
            return None, None
        return corners, None

    def fill_points(self, corners, ids=None) -> np.ndarray:
        if corners is None:
            return self.empty_detection()
        return np.asarray(corners, float).reshape(-1, 2)

    def estimate_pose(self, corners, ids, mtx, dist):
        """Board pose in the camera frame via PnP, or None."""
        import cv2

        if corners is None or len(corners) < 4:
            return None
        obj = self.object_points()
        ok, rvec, tvec = cv2.solvePnP(
            obj.reshape(-1, 1, 3), np.asarray(corners, np.float64)
            .reshape(-1, 1, 2), np.asarray(mtx, np.float64),
            np.asarray(dist, np.float64).ravel())
        if not ok:
            return None
        return rvec.ravel(), tvec.ravel()


@dataclass
class CharucoBoard:
    """ChArUco board (corners carry ids, so partial detections are
    usable; reference boards.py:525+)."""

    squares_x: int = 10
    squares_y: int = 7
    square_length: float = 25.0
    marker_length: float = 18.75
    dict_id: Optional[int] = None

    @property
    def n_points(self) -> int:
        return (self.squares_x - 1) * (self.squares_y - 1)

    def object_points(self) -> np.ndarray:
        return chessboard_object_points(self.squares_x - 1,
                                        self.squares_y - 1,
                                        self.square_length)

    def empty_detection(self) -> np.ndarray:
        return np.full((self.n_points, 2), np.nan)

    def detect_image(self, img: np.ndarray):
        from macaque_tpu_torch.calib.boards import detect_charuco

        return detect_charuco(img, self.squares_x, self.squares_y,
                              self.square_length, self.marker_length,
                              self.dict_id)

    def fill_points(self, corners, ids) -> np.ndarray:
        out = self.empty_detection()
        if corners is not None and ids is not None:
            out[np.asarray(ids, int).ravel()] = \
                np.asarray(corners, float).reshape(-1, 2)
        return out

    def estimate_pose(self, corners, ids, mtx, dist):
        import cv2

        if corners is None or ids is None or len(corners) < 4:
            return None
        obj = self.object_points()[np.asarray(ids, int).ravel()]
        ok, rvec, tvec = cv2.solvePnP(
            obj.reshape(-1, 1, 3), np.asarray(corners, np.float64)
            .reshape(-1, 1, 2), np.asarray(mtx, np.float64),
            np.asarray(dist, np.float64).ravel())
        if not ok:
            return None
        return rvec.ravel(), tvec.ravel()


# --------------------------------------------------------------------------
# video iteration + detection loop
# --------------------------------------------------------------------------


def iter_video_frames(path: str) -> Iterator[tuple[int, np.ndarray]]:
    """Yield (frame_index, image) from an mp4/avi file or an imgstore
    directory (path to metadata.yaml or its folder)."""
    base = os.path.basename(path)
    if base == "metadata.yaml" or os.path.isdir(path):
        from macaque_tpu_torch.video.imgstore import ImgStoreReader

        store = ImgStoreReader(path if base == "metadata.yaml"
                               else os.path.join(path, "metadata.yaml"))
        try:
            for i in range(len(store)):
                img, _ = store.get_image(frame_index=i)
                yield i, img
        finally:
            store.close()
    else:
        import cv2

        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {path}")
        i = 0
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield i, frame
                i += 1
        finally:
            cap.release()


def detect_board_video(path: str, board, skip: int = 20,
                       prefix=None) -> list[dict]:
    """Scan a video for board detections.

    Samples every ``skip``-th frame, but after any hit scans the next
    ``skip//2`` frames densely (the reference's ``go`` counter,
    boards.py:316-341) — boards tend to be visible in runs, so bursts
    capture many nearby views cheaply.

    Returns rows: ``{framenum, corners, ids, filled}`` where ``filled``
    is the (N, 2) NaN-padded full-board array.
    """
    rows = []
    go = skip // 2
    for framenum, frame in iter_video_frames(path):
        if framenum % skip != 0 and go <= 0:
            continue
        corners, ids = board.detect_image(frame)
        if corners is not None and len(corners) > 0:
            key = framenum if prefix is None else (prefix, framenum)
            rows.append({
                "framenum": key,
                "corners": corners,
                "ids": ids,
                "filled": board.fill_points(corners, ids),
            })
            go = skip // 2
        go -= 1
    return rows


def detect_board_images(images: Sequence[np.ndarray], board,
                        prefix=None) -> list[dict]:
    """Same row format from an in-memory image sequence."""
    rows = []
    for framenum, frame in enumerate(images):
        corners, ids = board.detect_image(frame)
        if corners is not None and len(corners) > 0:
            key = framenum if prefix is None else (prefix, framenum)
            rows.append({
                "framenum": key,
                "corners": corners,
                "ids": ids,
                "filled": board.fill_points(corners, ids),
            })
    return rows


def estimate_pose_rows(rows: list[dict], board, mtx, dist,
                       camera=None) -> list[dict]:
    """Attach board pose (rvec/tvec) to each row via PnP
    (boards.py:349-356).

    With ``camera`` (a tensor camera of the port's models, one camera),
    corners are first normalized through the camera model, on the
    camera's device and in its dtype, and PnP runs with an identity
    matrix —
    the reference's estimate_pose_points path (boards.py:357-368 calls
    camera.undistort_points then solvePnP with eye(3)), which is what
    makes fisheye pose init unbiased."""
    if camera is None:
        for row in rows:
            pose = board.estimate_pose(row["corners"], row["ids"],
                                       mtx, dist)
            row["rvec"], row["tvec"] = (pose if pose is not None
                                        else (None, None))
        return rows

    import torch

    from macaque_tpu_torch.cameras.dispatch import undistort_points

    ref = camera.K
    eye = np.eye(3)
    zero = np.zeros(5)
    for row in rows:
        corners = row["corners"]
        if corners is None or len(corners) < 4:
            row["rvec"], row["tvec"] = None, None
            continue
        px = torch.as_tensor(np.asarray(corners, float).reshape(1, -1, 2),
                             dtype=ref.dtype, device=ref.device)
        norm = undistort_points(camera, px)[0].to(
            "cpu", torch.float64).numpy()
        pose = board.estimate_pose(norm, row["ids"], eye, zero)
        row["rvec"], row["tvec"] = pose if pose is not None else (None, None)
    return rows


# --------------------------------------------------------------------------
# row merging / point extraction
# --------------------------------------------------------------------------


def merge_rows(all_rows: Sequence[list[dict]],
               cam_names: Optional[Sequence] = None) -> list[dict]:
    """Group per-camera detection rows by frame number: returns a list of
    ``{cam_name: row}`` dicts, one per distinct framenum, sorted
    (boards.py:57-88 semantics)."""
    if cam_names is None:
        cam_names = list(range(len(all_rows)))
    assert len(cam_names) == len(all_rows)

    by_cam = {name: {r["framenum"]: r for r in rows}
              for name, rows in zip(cam_names, all_rows)}
    framenums = sorted({num for rows in by_cam.values() for num in rows})
    return [
        {name: by_cam[name][num] for name in cam_names
         if num in by_cam[name]}
        for num in framenums
    ]


def extract_points(merged: list[dict], board,
                   cam_names: Optional[Sequence] = None,
                   min_cameras: int = 1, min_points: int = 4,
                   check_rtvecs: bool = True):
    """Merged rows -> padded observation arrays.

    Returns ``(imgp (C, M, 2), extra)`` with
    ``extra = {objp (M, 3), ids (M,), rvecs (C, M, 3), tvecs (C, M, 3)}``
    where M = n_views * points_per_board filtered to points seen by at
    least ``min_cameras`` (boards.py:91-177 semantics). NaN = missing.
    """
    if cam_names is None:
        cam_names = sorted({k for row in merged for k in row})
    C = len(cam_names)
    P = board.n_points
    V = len(merged)

    objp_template = board.object_points().reshape(-1, 3)

    imgp = np.full((C, V, P, 2), np.nan)
    rvecs = np.full((C, V, P, 3), np.nan)
    tvecs = np.full((C, V, P, 3), np.nan)
    objp = np.tile(objp_template, (V, 1, 1))
    view_ids = np.repeat(np.arange(V, dtype=np.int32), P)

    for vix, row in enumerate(merged):
        for cix, cname in enumerate(cam_names):
            if cname not in row:
                continue
            r = row[cname]
            filled = np.asarray(r["filled"], float).reshape(-1, 2)
            good = ~np.isnan(filled[:, 0])
            if good.sum() < min_points:
                continue
            if r.get("rvec") is None or r.get("tvec") is None:
                if check_rtvecs:
                    continue
                rv = tv = np.full(3, np.nan)
            else:
                rv = np.asarray(r["rvec"], float).ravel()
                tv = np.asarray(r["tvec"], float).ravel()
            imgp[cix, vix] = filled
            rvecs[cix, vix, good] = rv
            tvecs[cix, vix, good] = tv

    imgp = imgp.reshape(C, -1, 2)
    rvecs = rvecs.reshape(C, -1, 3)
    tvecs = tvecs.reshape(C, -1, 3)
    objp = objp.reshape(-1, 3)

    n_seen = (~np.isnan(imgp[..., 0])).sum(axis=0)
    keep = n_seen >= min_cameras
    extra = {
        "objp": objp[keep],
        "ids": view_ids[keep],
        "rvecs": rvecs[:, keep],
        "tvecs": tvecs[:, keep],
    }
    return imgp[:, keep], extra


def extract_rtvecs(merged: list[dict],
                   cam_names: Optional[Sequence] = None,
                   min_cameras: int = 1) -> np.ndarray:
    """Merged rows -> per-camera board poses (C, M, 6) [rvec|tvec], NaN
    where undetected; M filtered to views with >= min_cameras poses
    (boards.py:180-235). ``estimate_pose_rows`` must have run first."""
    if cam_names is None:
        cam_names = sorted({k for row in merged for k in row})
    C = len(cam_names)
    V = len(merged)
    rtvecs = np.full((C, V, 6), np.nan)
    for vix, row in enumerate(merged):
        for cix, cname in enumerate(cam_names):
            r = row.get(cname)
            if r is None or r.get("rvec") is None or r.get("tvec") is None:
                continue
            rtvecs[cix, vix, :3] = np.asarray(r["rvec"], float).ravel()
            rtvecs[cix, vix, 3:] = np.asarray(r["tvec"], float).ravel()
    n_good = (~np.isnan(rtvecs[..., 0])).sum(axis=0)
    return rtvecs[:, n_good >= min_cameras]
