"""Model-generic camera operations.

Every camera model of the port (omnidir/Mei, pinhole, equidistant
fisheye) is a NamedTuple of tensors with ``pmat`` and a pair of functions
``<model>_project`` / ``<model>_undistort``; these dispatchers pick the
pair, so the geometry solvers stay model-agnostic. Port of
``macaque_tpu/cameras/dispatch.py``.
"""

from __future__ import annotations

import torch

from macaque_tpu_torch.cameras.fisheye import (
    FisheyeCamera,
    fisheye_project,
    fisheye_undistort,
)
from macaque_tpu_torch.cameras.omnidir import (
    OmnidirCamera,
    omnidir_project,
    omnidir_undistort,
)
from macaque_tpu_torch.cameras.pinhole import (
    PinholeCamera,
    pinhole_project,
    pinhole_undistort,
)

_PROJECT = {
    OmnidirCamera: omnidir_project,
    PinholeCamera: pinhole_project,
    FisheyeCamera: fisheye_project,
}
_UNDISTORT = {
    OmnidirCamera: omnidir_undistort,
    PinholeCamera: pinhole_undistort,
    FisheyeCamera: fisheye_undistort,
}


def project_fn(cam):
    """The ``project(cam, world_points)`` function for this camera type."""
    try:
        return _PROJECT[type(cam)]
    except KeyError:
        raise TypeError(f"unknown camera model: {type(cam)}") from None


def undistort_fn(cam):
    """The ``undistort(cam, pixels)`` function for this camera type."""
    try:
        return _UNDISTORT[type(cam)]
    except KeyError:
        raise TypeError(f"unknown camera model: {type(cam)}") from None


def project_points(cam, points: torch.Tensor) -> torch.Tensor:
    """World points ``(..., N, 3)`` -> pixels ``(..., N, 2)``."""
    return project_fn(cam)(cam, points)


def undistort_points(cam, pixels: torch.Tensor) -> torch.Tensor:
    """Pixels ``(..., N, 2)`` -> ideal z=1-plane coords ``(..., N, 2)``."""
    return undistort_fn(cam)(cam, pixels)
