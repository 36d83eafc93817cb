"""Calibration-object detection and PnP initialization (host OpenCV).

Covers the reference's board tooling (multicam_toolbox.py: chessboard
detection :22-72, aruco/charuco :244-391, PnP extrinsics from labeled
cage points :213-242; aniposelib/boards.py Checkerboard/CharucoBoard).
Detection stays host-side (cv2 C++); all optimization happens in
calib/bundle.py on device.

Port of ``macaque_tpu/calib/boards.py``, the same code: ``cv2`` is
imported by the functions that detect or solve.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def chessboard_object_points(cols: int, rows: int, square: float) -> np.ndarray:
    """(cols*rows, 3) board-frame corner coordinates."""
    gx, gy = np.meshgrid(np.arange(cols), np.arange(rows))
    pts = np.stack([gx.ravel() * square, gy.ravel() * square,
                    np.zeros(cols * rows)], axis=1)
    return pts.astype(np.float64)


def find_chessboard_corners(img: np.ndarray, cols: int, rows: int,
                            refine: bool = True) -> Optional[np.ndarray]:
    """Detect + subpixel-refine chessboard corners; None if not found
    (reference mct:36-56 semantics)."""
    import cv2

    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if img.ndim == 3 else img
    ok, corners = cv2.findChessboardCorners(
        gray, (cols, rows),
        flags=cv2.CALIB_CB_ADAPTIVE_THRESH + cv2.CALIB_CB_NORMALIZE_IMAGE,
    )
    if not ok:
        return None
    if refine:
        criteria = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER,
                    30, 0.001)
        corners = cv2.cornerSubPix(gray, corners, (11, 11), (-1, -1),
                                   criteria)
    return corners.reshape(-1, 2)


def detect_charuco(img: np.ndarray, squares_x: int = 10, squares_y: int = 7,
                   square_len: float = 25.0, marker_len: float = 18.75,
                   dict_id: Optional[int] = None):
    """Detect ChArUco corners (reference board spec:
    configs/config_tmpl.toml:9-29). Returns (corners (N,2), ids (N,)) or
    (None, None)."""
    import cv2

    aruco = cv2.aruco
    dictionary = aruco.getPredefinedDictionary(
        dict_id if dict_id is not None else aruco.DICT_4X4_50
    )
    board = aruco.CharucoBoard(
        (squares_x, squares_y), square_len, marker_len, dictionary
    )
    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if img.ndim == 3 else img
    detector = aruco.CharucoDetector(board)
    corners, ids, _, _ = detector.detectBoard(gray)
    if corners is None or len(corners) == 0:
        return None, None
    return corners.reshape(-1, 2), ids.ravel()


def solve_pnp_extrinsics(obj_pts: np.ndarray, und_pts: np.ndarray):
    """Initial camera pose from known 3D points and *undistorted
    normalized* 2D observations (reference mct:213-242 runs solvePnP on
    omnidir-undistorted points with identity intrinsics)."""
    import cv2

    ok, rvec, tvec = cv2.solvePnP(
        obj_pts.reshape(-1, 1, 3).astype(np.float64),
        und_pts.reshape(-1, 1, 2).astype(np.float64),
        np.eye(3), np.zeros(5),
    )
    if not ok:
        raise RuntimeError("solvePnP failed")
    return rvec.ravel(), tvec.ravel()
