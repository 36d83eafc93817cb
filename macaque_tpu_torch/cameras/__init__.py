"""Camera models on tensors: omnidirectional (Mei), pinhole, fisheye.

Port of ``macaque_tpu/cameras``: every model is a NamedTuple of tensors
and a pair of batched functions, so projection, undistortion and
triangulation run on the card.
"""

from macaque_tpu_torch.cameras.rotation import (
    rodrigues, rodrigues_inv, rotate_points)
from macaque_tpu_torch.cameras.dispatch import (
    project_points,
    undistort_points,
)
from macaque_tpu_torch.cameras.fisheye import (
    FisheyeCamera,
    fisheye_project,
    fisheye_undistort,
)
from macaque_tpu_torch.cameras.omnidir import (
    OmnidirCamera,
    omnidir_project,
    omnidir_undistort,
    omnidir_unproject_ray,
)
from macaque_tpu_torch.cameras.pinhole import (
    PinholeCamera,
    pinhole_project,
    pinhole_undistort,
)
from macaque_tpu_torch.cameras.rig import CameraRig

__all__ = [
    "rodrigues",
    "rodrigues_inv",
    "rotate_points",
    "OmnidirCamera",
    "omnidir_project",
    "omnidir_undistort",
    "omnidir_unproject_ray",
    "PinholeCamera",
    "pinhole_project",
    "pinhole_undistort",
    "FisheyeCamera",
    "fisheye_project",
    "fisheye_undistort",
    "project_points",
    "undistort_points",
    "CameraRig",
]
