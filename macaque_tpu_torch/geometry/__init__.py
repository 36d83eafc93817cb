"""Batched multi-view geometry on tensors: masked DLT triangulation,
camera-subset RANSAC, reprojection error and the constrained 3D refinement
(port of ``macaque_tpu/geometry``)."""

from macaque_tpu_torch.geometry.triangulate import (
    triangulate_dlt,
    triangulate_dlt_pinv,
    reprojection_error,
    reprojection_error_mean,
)
from macaque_tpu_torch.geometry.ransac import triangulate_ransac
from macaque_tpu_torch.geometry.refine3d import (
    refine_points_3d, refine_points_3d_possible, RefineConfig)

__all__ = [
    "triangulate_dlt",
    "triangulate_dlt_pinv",
    "reprojection_error",
    "reprojection_error_mean",
    "triangulate_ransac",
    "refine_points_3d",
    "refine_points_3d_possible",
    "RefineConfig",
]
