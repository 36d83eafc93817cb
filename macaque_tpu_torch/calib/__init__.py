"""Camera calibration suite: board detection (host OpenCV), omnidir
intrinsic calibration and multi-camera bundle adjustment on tensors (port
of ``macaque_tpu/calib``).

Replaces the reference's calibration toolchain
(src/utils/multicam_toolbox.py): chessboard/aruco analyzers (:22-72,
244-391), ``calibrate_intrinsic`` via cv2.omnidir (:74-116),
``optimize_extrinsic`` (:488-636) and ``optimize_all_camera_params``
(:638-824) via scipy sparse least-squares. Here the Mei projection model
is differentiable, so every optimization is the shared LM-CGLS engine on
the device — no hand-built jacobian sparsity patterns.
"""

from macaque_tpu_torch.calib.bundle import (
    calibrate_intrinsics_omnidir,
    bundle_adjust_extrinsics,
    bundle_adjust_full,
)
from macaque_tpu_torch.calib.boards import (
    find_chessboard_corners,
    detect_charuco,
    solve_pnp_extrinsics,
)
from macaque_tpu_torch.calib.videos import (
    Checkerboard,
    CharucoBoard,
    detect_board_video,
    detect_board_images,
    estimate_pose_rows,
    merge_rows,
    extract_points,
    extract_rtvecs,
)
from macaque_tpu_torch.calib.workflow import (
    analyze_chessboard_videos,
    calibrate_intrinsics_driver,
    get_extrinsics_from_cage_keypoints,
    save_cage_annotations,
    analyze_aruco_marker_videos,
    analyze_aruco_cube_videos,
    optimize_extrinsics_driver,
    optimize_all_camera_params_driver,
    fix_extrinsic_optim,
    extract_frames_for_3dannotation,
    calibrate_from_videos,
)

__all__ = [
    "calibrate_intrinsics_omnidir",
    "bundle_adjust_extrinsics",
    "bundle_adjust_full",
    "find_chessboard_corners",
    "detect_charuco",
    "solve_pnp_extrinsics",
    "Checkerboard",
    "CharucoBoard",
    "detect_board_video",
    "detect_board_images",
    "estimate_pose_rows",
    "merge_rows",
    "extract_points",
    "extract_rtvecs",
    "analyze_chessboard_videos",
    "calibrate_intrinsics_driver",
    "get_extrinsics_from_cage_keypoints",
    "save_cage_annotations",
    "analyze_aruco_marker_videos",
    "analyze_aruco_cube_videos",
    "optimize_extrinsics_driver",
    "optimize_all_camera_params_driver",
    "fix_extrinsic_optim",
    "extract_frames_for_3dannotation",
    "calibrate_from_videos",
]
