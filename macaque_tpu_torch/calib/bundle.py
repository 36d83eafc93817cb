"""Omnidir intrinsic calibration + multi-camera bundle adjustment on tensors.

Port of ``macaque_tpu/calib/bundle.py``. All solvers minimize masked
reprojection residuals with the shared matrix-free LM-CGLS engine
(``geometry/lm.py``); the projections (``cameras/omnidir.py``,
``cameras/fisheye.py``) are differentiable, so no finite differences or
hand-coded jacobian sparsity (contrast: reference multicam_toolbox.py:
591-612, 753-777 builds scipy lil_matrix sparsity by hand).

Parameterizations:
  * intrinsics per camera: fx, fy, cx, cy, skew, xi, D[4]  (10)
  * extrinsics per camera: rvec[3], tvec[3]                 (6)
  * full BA: both (16/camera, reference mct:638-824 optimizes the same
    set), plus the shared 3D structure.

Each solve is one lane of ``lm_solve`` (``x0[None]``); every residual maps
(B, n) to (B, m) lane by lane. Where the JAX package writes pinned entries
with ``.at[...].set`` (camera 0's pose, the fisheye K and D), the port
builds the tensor with ``torch.cat`` / ``torch.where``: an in-place write
into a view of ``x`` would break ``torch.func.vjp``. The solvers take
``device`` (the card when None) and ``dtype`` (float32, the JAX package's
precision on its TPU), fill ``info`` with the solve's counts when given a
dict, and return numpy float64 as the JAX package returns under x64. On
the card each CGLS sweep is replayed from a CUDA graph (``lm_solve``
on a CUDA tensor): a sweep is two reverse passes of several
hundred small kernels, and the intrinsic fit runs ~45,000 of them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from macaque_tpu_torch.cameras.fisheye import FisheyeCamera, fisheye_project
from macaque_tpu_torch.cameras.omnidir import OmnidirCamera, omnidir_project
from macaque_tpu_torch.core.device import resolve_device
from macaque_tpu_torch.geometry.lm import LMConfig, lm_solve


def _unpack_K(p: torch.Tensor) -> torch.Tensor:
    """(..., 5) [fx, fy, cx, cy, skew] -> (..., 3, 3)."""
    fx, fy, cx, cy, s = p.unbind(-1)
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack([
        torch.stack([fx, s, cx], -1),
        torch.stack([z, fy, cy], -1),
        torch.stack([z, z, o], -1),
    ], -2)


class _Problem:
    """The observations of one solve as tensors on its device: ``obs``
    (NaN scrubbed) and its ``valid`` mask."""

    def __init__(self, obs, device, dtype):
        self.dev = resolve_device(device)
        self.dtype = dtype
        o = self.tensor(obs)
        self.valid = ~torch.isnan(o[..., 0])
        self.obs = torch.nan_to_num(o)
        self.n_obs = int(self.valid.sum()) * 2

    def tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self.dtype,
                               device=self.dev)

    def err(self, proj: torch.Tensor) -> torch.Tensor:
        """Masked ``obs - proj`` flattened lane by lane: (B, m)."""
        e = torch.where(self.valid[..., None], self.obs - proj, 0.0)
        return e.reshape(proj.shape[0], -1)

    def solve(self, resid, x0, cfg: LMConfig, info: Optional[dict]):
        """One lane of ``lm_solve`` from numpy ``x0``; returns (x float64
        numpy, rms)."""
        x, inf = lm_solve(resid, self.tensor(x0)[None], cfg, return_info=True)
        r = resid(x)
        rms = float(torch.sqrt((r * r).sum() / max(self.n_obs, 1)))
        if info is not None:
            info.update({k: (v[0].item() if torch.is_tensor(v) else v)
                         for k, v in inf.items()})
        return x[0].to("cpu", torch.float64).numpy(), rms


def _pin_cam0(v: torch.Tensor, fixed: torch.Tensor) -> torch.Tensor:
    """(B, C, 3) with camera 0's row replaced by ``fixed`` (3,)."""
    return torch.cat([fixed.expand(v.shape[0], 1, 3), v[:, 1:]], dim=1)


def calibrate_intrinsics_omnidir(
    obj_points: np.ndarray,
    img_points: np.ndarray,
    init_f: float = 800.0,
    init_c: Optional[tuple] = None,
    img_size: tuple = (2048, 1536),
    init_rvecs: Optional[np.ndarray] = None,
    init_tvecs: Optional[np.ndarray] = None,
    cfg: LMConfig = LMConfig(lm_iters=300, cg_iters=150, ftol=1e-12),
    device=None,
    dtype=torch.float32,
    info: Optional[dict] = None,
):
    """Single-camera omnidir (Mei) intrinsic calibration.

    obj_points: (V, N, 3) board points in board frame per view
    img_points: (V, N, 2) detected pixels (NaN = missing)
    Returns (K (3,3), xi, D (4,), rvecs (V,3), tvecs (V,3), rms).

    Replaces ``cv2.omnidir.calibrate`` (reference mct:102) with a direct LM
    fit of fx, fy, cx, cy, skew, xi, D and per-view poses. On
    limited-FOV board data the Mei model has a nearly flat focal<->xi gauge
    valley: the fit converges to the noise floor, but the raw fx/xi values
    are only identifiable with wide-angle coverage (as with
    cv2.omnidir.calibrate).
    """
    V, N, _ = obj_points.shape
    if init_c is None:
        init_c = (img_size[0] / 2, img_size[1] / 2)

    # initial per-view poses: place the board in front of the camera
    rv0 = init_rvecs if init_rvecs is not None else np.zeros((V, 3))
    tv0 = init_tvecs if init_tvecs is not None \
        else np.tile(np.array([0.0, 0.0, 1000.0]), (V, 1))

    x0 = np.concatenate([
        np.array([init_f, init_f, init_c[0], init_c[1], 0.0, 1.0]),
        np.zeros(4),
        rv0.ravel(), tv0.ravel(),
    ])

    prob = _Problem(img_points, device, dtype)
    obj = prob.tensor(obj_points)

    def resid(x):
        # the V views share the intrinsics: a (B, V) camera with K, xi and
        # D expanded over the views (JAX vmaps over them)
        B = x.shape[0]
        cam = OmnidirCamera(
            K=_unpack_K(x[:, :5])[:, None].expand(B, V, 3, 3),
            xi=x[:, 5:6].expand(B, V),
            D=x[:, None, 6:10].expand(B, V, 4),
            rvec=x[:, 10:10 + 3 * V].reshape(B, V, 3),
            tvec=x[:, 10 + 3 * V:].reshape(B, V, 3))
        return prob.err(omnidir_project(cam, obj))

    x, rms = prob.solve(resid, x0, cfg, info)
    K = _unpack_K(torch.from_numpy(x[:5])).numpy()
    return (K, float(x[5]), x[6:10],
            x[10: 10 + 3 * V].reshape(V, 3),
            x[10 + 3 * V:].reshape(V, 3), rms)


def calibrate_intrinsics_fisheye(
    obj_points: np.ndarray,
    img_points: np.ndarray,
    init_f: float = 800.0,
    init_c: Optional[tuple] = None,
    img_size: tuple = (2048, 1536),
    init_rvecs: Optional[np.ndarray] = None,
    init_tvecs: Optional[np.ndarray] = None,
    nd: int = 2,
    # the f<->depth valley of planar views is long and narrow: from a
    # pinhole-seeded (biased) init the solve needs ~400+ accepted steps
    # to walk it (the JAX package's budget)
    cfg: LMConfig = LMConfig(lm_iters=600, cg_iters=400, ftol=1e-15),
    device=None,
    dtype=torch.float32,
    info: Optional[dict] = None,
):
    """Single-camera equidistant-fisheye intrinsic calibration.

    obj_points: (V, N, 3) board points in board frame per view
    img_points: (V, N, 2) detected pixels (NaN = missing)
    Returns (K (3,3), D (4,), rvecs (V,3), tvecs (V,3), rms).

    The stand-in for ``cv2.fisheye.calibrate``: a direct LM fit of f
    (fx=fy), cx, cy, the first ``nd`` Kannala-Brandt coefficients, and
    per-view board poses. Multiple tilted views make the focal
    identifiable, which the group bundle alone cannot do from a pinhole
    ``initCameraMatrix2D`` seed (aniposelib cameras.py:1891-1926)."""
    V, N, _ = obj_points.shape
    if init_c is None:
        init_c = (img_size[0] / 2, img_size[1] / 2)

    rv0 = init_rvecs if init_rvecs is not None else np.zeros((V, 3))
    tv0 = init_tvecs if init_tvecs is not None \
        else np.tile(np.array([0.0, 0.0, 1000.0]), (V, 1))

    x0 = np.concatenate([
        np.array([init_f, init_c[0], init_c[1]]),
        np.zeros(nd),
        rv0.ravel(), tv0.ravel(),
    ])

    prob = _Problem(img_points, device, dtype)
    obj = prob.tensor(obj_points)

    def resid(x):
        B = x.shape[0]
        f, cx, cy = x[:, 0], x[:, 1], x[:, 2]
        z = torch.zeros_like(f)
        o = torch.ones_like(f)
        K = torch.stack([torch.stack([f, z, cx], -1),
                         torch.stack([z, f, cy], -1),
                         torch.stack([z, z, o], -1)], -2)
        D = torch.cat([x[:, 3:3 + nd], x.new_zeros(B, 4 - nd)], -1)
        cam = FisheyeCamera(
            K=K[:, None].expand(B, V, 3, 3), D=D[:, None].expand(B, V, 4),
            rvec=x[:, 3 + nd:3 + nd + 3 * V].reshape(B, V, 3),
            tvec=x[:, 3 + nd + 3 * V:].reshape(B, V, 3))
        return prob.err(fisheye_project(cam, obj))

    x, rms = prob.solve(resid, x0, cfg, info)
    K = np.array([[x[0], 0.0, x[1]], [0.0, x[0], x[2]], [0.0, 0.0, 1.0]])
    D = np.zeros(4)
    D[:nd] = x[3: 3 + nd]
    return (K, D,
            x[3 + nd: 3 + nd + 3 * V].reshape(V, 3),
            x[3 + nd + 3 * V:].reshape(V, 3), rms)


def bundle_adjust_extrinsics(
    rig_K: np.ndarray, rig_xi: np.ndarray, rig_D: np.ndarray,
    rvec0: np.ndarray, tvec0: np.ndarray,
    obs: np.ndarray, points0: np.ndarray,
    fix_cam0: bool = True,
    cfg: LMConfig = LMConfig(lm_iters=50, cg_iters=80, ftol=1e-8),
    device=None,
    dtype=torch.float32,
    info: Optional[dict] = None,
):
    """Multi-camera extrinsic BA with fixed intrinsics
    (reference ``optimize_extrinsic``, mct:488-636).

    obs: (C, P, 2) observed pixels of P shared 3D points (NaN = unseen)
    points0: (P, 3) initial triangulated points (also optimized)
    Returns (rvecs (C,3), tvecs (C,3), points (P,3), rms).
    """
    C, P, _ = obs.shape
    prob = _Problem(obs, device, dtype)
    K, xi, D = (prob.tensor(a) for a in (rig_K, rig_xi, rig_D))
    rv_fixed, tv_fixed = prob.tensor(rvec0[0]), prob.tensor(tvec0[0])

    x0 = np.concatenate([
        rvec0.ravel(), tvec0.ravel(), points0.ravel()
    ])

    def resid(x):
        B = x.shape[0]
        rv = x[:, :3 * C].reshape(B, C, 3)
        tv = x[:, 3 * C:6 * C].reshape(B, C, 3)
        if fix_cam0:
            rv = _pin_cam0(rv, rv_fixed)
            tv = _pin_cam0(tv, tv_fixed)
        pts = x[:, 6 * C:].reshape(B, 1, P, 3)
        cam = OmnidirCamera(K=K, xi=xi, D=D, rvec=rv, tvec=tv)
        return prob.err(omnidir_project(cam, pts))   # (B, C, P, 2)

    x, rms = prob.solve(resid, x0, cfg, info)
    return (x[: 3 * C].reshape(C, 3), x[3 * C: 6 * C].reshape(C, 3),
            x[6 * C:].reshape(P, 3), rms)


def bundle_adjust_fisheye(
    rig_K: np.ndarray, rig_D: np.ndarray,
    rvec0: np.ndarray, tvec0: np.ndarray,
    obs: np.ndarray, points0: np.ndarray,
    fix_cam0: bool = True,
    extra_dist: bool = False,
    cfg: LMConfig = LMConfig(lm_iters=60, cg_iters=100, ftol=1e-9),
    device=None,
    dtype=torch.float32,
    info: Optional[dict] = None,
):
    """Fisheye-rig BA over the reference's FisheyeCamera parameter set:
    rvec, tvec, single focal f (fx=fy), k1 (+ k2 when ``extra_dist``),
    with cx/cy held fixed (reference cameras.py:392-418
    FisheyeCamera.set_params/get_params) + the shared 3D structure.
    Returns (K, D, rvecs, tvecs, points, rms)."""
    C, P, _ = obs.shape
    prob = _Problem(obs, device, dtype)
    rv_fixed, tv_fixed = prob.tensor(rvec0[0]), prob.tensor(tvec0[0])
    K_base = prob.tensor(rig_K)
    D_base = prob.tensor(rig_D)
    on_diag = torch.zeros(3, 3, dtype=torch.bool, device=prob.dev)
    on_diag[0, 0] = on_diag[1, 1] = True

    nd = 2 if extra_dist else 1
    intr0 = np.zeros((C, 1 + nd))
    intr0[:, 0] = (rig_K[:, 0, 0] + rig_K[:, 1, 1]) / 2
    intr0[:, 1:] = rig_D[:, :nd]

    x0 = np.concatenate([
        rvec0.ravel(), tvec0.ravel(), intr0.ravel(), points0.ravel()
    ])
    ni = C * (1 + nd)

    def resid(x):
        B = x.shape[0]
        rv = x[:, :3 * C].reshape(B, C, 3)
        tv = x[:, 3 * C:6 * C].reshape(B, C, 3)
        if fix_cam0:
            rv = _pin_cam0(rv, rv_fixed)
            tv = _pin_cam0(tv, tv_fixed)
        intr = x[:, 6 * C:6 * C + ni].reshape(B, C, 1 + nd)
        K = torch.where(on_diag, intr[..., 0, None, None], K_base)
        D = torch.cat([intr[..., 1:], D_base[:, nd:].expand(B, C, 4 - nd)],
                      -1)
        pts = x[:, 6 * C + ni:].reshape(B, 1, P, 3)
        cam = FisheyeCamera(K=K, D=D, rvec=rv, tvec=tv)
        return prob.err(fisheye_project(cam, pts))

    x, rms = prob.solve(resid, x0, cfg, info)
    intr = x[6 * C: 6 * C + ni].reshape(C, 1 + nd)
    K = np.asarray(rig_K, float).copy()
    K[:, 0, 0] = intr[:, 0]
    K[:, 1, 1] = intr[:, 0]
    D = np.asarray(rig_D, float).copy()
    D[:, :nd] = intr[:, 1:]
    return (K, D, x[: 3 * C].reshape(C, 3), x[3 * C: 6 * C].reshape(C, 3),
            x[6 * C + ni:].reshape(P, 3), rms)


def bundle_adjust_full(
    rig_K: np.ndarray, rig_xi: np.ndarray, rig_D: np.ndarray,
    rvec0: np.ndarray, tvec0: np.ndarray,
    obs: np.ndarray, points0: np.ndarray,
    fix_cam0: bool = True,
    cfg: LMConfig = LMConfig(lm_iters=60, cg_iters=100, ftol=1e-9),
    device=None,
    dtype=torch.float32,
    info: Optional[dict] = None,
):
    """Full 16-parameter-per-camera BA: rvec, tvec, fx, fy, cx, cy, xi,
    D[4] + structure (reference ``optimize_all_camera_params``,
    mct:638-824). Returns (K, xi, D, rvecs, tvecs, points, rms)."""
    C, P, _ = obs.shape
    prob = _Problem(obs, device, dtype)
    rv_fixed, tv_fixed = prob.tensor(rvec0[0]), prob.tensor(tvec0[0])

    intr0 = np.zeros((C, 10))
    intr0[:, 0] = rig_K[:, 0, 0]
    intr0[:, 1] = rig_K[:, 1, 1]
    intr0[:, 2] = rig_K[:, 0, 2]
    intr0[:, 3] = rig_K[:, 1, 2]
    intr0[:, 4] = rig_K[:, 0, 1]
    intr0[:, 5] = rig_xi
    intr0[:, 6:10] = rig_D

    x0 = np.concatenate([
        rvec0.ravel(), tvec0.ravel(), intr0.ravel(), points0.ravel()
    ])

    def resid(x):
        B = x.shape[0]
        rv = x[:, :3 * C].reshape(B, C, 3)
        tv = x[:, 3 * C:6 * C].reshape(B, C, 3)
        if fix_cam0:
            rv = _pin_cam0(rv, rv_fixed)
            tv = _pin_cam0(tv, tv_fixed)
        intr = x[:, 6 * C:16 * C].reshape(B, C, 10)
        pts = x[:, 16 * C:].reshape(B, 1, P, 3)
        cam = OmnidirCamera(K=_unpack_K(intr[..., :5]), xi=intr[..., 5],
                            D=intr[..., 6:10], rvec=rv, tvec=tv)
        return prob.err(omnidir_project(cam, pts))

    x, rms = prob.solve(resid, x0, cfg, info)
    intr = x[6 * C: 16 * C].reshape(C, 10)
    K = np.zeros((C, 3, 3))
    K[:, 0, 0] = intr[:, 0]
    K[:, 1, 1] = intr[:, 1]
    K[:, 0, 2] = intr[:, 2]
    K[:, 1, 2] = intr[:, 3]
    K[:, 0, 1] = intr[:, 4]
    K[:, 2, 2] = 1.0
    return (K, intr[:, 5], intr[:, 6:10],
            x[: 3 * C].reshape(C, 3), x[3 * C: 6 * C].reshape(C, 3),
            x[16 * C:].reshape(P, 3), rms)
