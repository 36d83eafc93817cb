"""Batched multi-view geometry on tensors: masked DLT triangulation and
reprojection error (port of ``macaque_tpu/geometry/triangulate.py``;
RANSAC and the 3D refinement come with step 4)."""

from macaque_tpu_torch.geometry.triangulate import (
    triangulate_dlt,
    triangulate_dlt_pinv,
    reprojection_error,
    reprojection_error_mean,
)

__all__ = [
    "triangulate_dlt",
    "triangulate_dlt_pinv",
    "reprojection_error",
    "reprojection_error_mean",
]
