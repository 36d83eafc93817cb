"""Camera-subset RANSAC triangulation on tensors.

Port of ``macaque_tpu/geometry/ransac.py``. The reference's
``triangulate_possible`` / ``triangulate_ransac``
(src/third_party/aniposelib/cameras.py:639-743) enumerates, per point,
every subset of the observing cameras (via ``itertools.product``),
triangulates each, and keeps the first subset whose mean reprojection
error beats a threshold (else the global best). Here the ``2^C`` camera
masks (in the same product order, so first-hit semantics match) are
solved one subset at a time for all points at once (the JAX package's
``lax.map``), and the selection is an argmin/argmax.
"""

from __future__ import annotations

import numpy as np
import torch

from macaque_tpu_torch.cameras.dispatch import project_fn, undistort_fn
from macaque_tpu_torch.geometry.triangulate import triangulate_dlt


def _subset_masks(n_cams: int, max_drop: int | None = None) -> np.ndarray:
    """All camera subsets in the reference's product order.

    ``itertools.product([include, exclude], ...)`` counts lexicographically
    with "include" first, i.e. subset k has camera c included iff bit
    ``(n_cams-1-c)`` of k is 0. Subset 0 = all cameras.
    """
    n = 1 << n_cams
    ks = np.arange(n)[:, None]
    bits = (ks >> (n_cams - 1 - np.arange(n_cams))[None, :]) & 1
    masks = bits == 0
    if max_drop is not None:
        keep = masks.sum(axis=1) >= n_cams - max_drop
        keep[0] = True
        masks = masks[keep]
    return masks


def triangulate_ransac(
    cam,
    points: torch.Tensor,
    min_cams: int = 2,
    threshold: float = 0.5,
    max_drop: int | None = None,
):
    """RANSAC-triangulate raw-pixel observations.

    cam: camera tuple stacked over C cameras (used for both DLT
      extrinsics and reprojection scoring).
    points: (C, N, 2) raw pixel observations, NaN = missing.
    Returns (p3d (N,3), picked (C,N) bool, points_2d (C,N,2), errors (N,)).

    Reference parity: src/third_party/aniposelib/cameras.py:639-743 with
    n_possible = 1.
    """
    project, undistort = project_fn(cam), undistort_fn(cam)
    masks = torch.as_tensor(_subset_masks(points.shape[0], max_drop),
                            device=points.device)           # (S, C)

    und = undistort(cam, points)              # (C, N, 2)
    valid = ~torch.isnan(points[..., 0])      # (C, N)
    undT = und.transpose(0, 1)                # (N, C, 2)
    validT = valid.transpose(0, 1)            # (N, C)
    n_valid = validT.sum(1)

    p3d_all, err_all, eff_all = [], [], []
    for mask in masks:
        eff = validT & mask[None, :]                        # (N, C)
        p3d = triangulate_dlt(undT, cam.pmat, eff)          # (N, 3)
        proj = project(cam, p3d)                            # (C, N, 2)
        resid = torch.where(eff.T[..., None], points - proj, torch.nan)
        norm = torch.linalg.vector_norm(resid, dim=-1)      # (C, N)
        good = ~torch.isnan(norm)
        ssum = torch.where(good, norm, 0.0).sum(0)
        denom = good.sum(0).to(norm.dtype)
        err = torch.where(denom < 1.5, torch.inf, ssum / denom)
        n_eff = eff.sum(1)
        accept = (n_eff >= min_cams) | (n_eff == n_valid)
        # the reference's initial best_error=200 acts as an outlier ceiling
        accept = accept & (err < 200.0)
        p3d_all.append(p3d)
        err_all.append(torch.where(accept & (n_eff >= 2), err, torch.inf))
        eff_all.append(eff)
    p3d_all = torch.stack(p3d_all)   # (S, N, 3)
    err_all = torch.stack(err_all)   # (S, N)
    eff_all = torch.stack(eff_all)   # (S, N, C)

    err_clean = torch.where(torch.isnan(err_all), torch.inf, err_all)
    hit = err_clean < threshold
    any_hit = hit.any(0)
    first_hit = torch.argmax(hit.to(torch.uint8), dim=0)  # first True
    best = torch.argmin(err_clean, dim=0)                # first min on ties
    sel = torch.where(any_hit, first_hit, best)

    n_idx = torch.arange(points.shape[1], device=points.device)
    p3d = p3d_all[sel, n_idx]
    err = err_clean[sel, n_idx]
    picked = eff_all[sel, n_idx].T                       # (C, N)

    no_solution = torch.isinf(err)
    p3d = torch.where(no_solution[:, None], torch.nan, p3d)
    err = torch.where(no_solution, 0.0, err)
    picked = picked & ~no_solution[None, :]
    points_2d = torch.where(picked[..., None], points, torch.nan)
    return p3d, picked, points_2d, err
