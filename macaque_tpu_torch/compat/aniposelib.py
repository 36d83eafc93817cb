"""aniposelib-compatible ``CameraGroup`` facade over the port's geometry.

Port of ``macaque_tpu/compat/aniposelib.py``. Provides the API surface
anipose-style workflows use (reference: src/third_party/aniposelib/
cameras.py:558-2013 — ``CameraGroup.load / subset_cameras_names /
triangulate / triangulate_ransac / reprojection_error / optim_points /
optim_points_jointlenfix / project``) with the batched tensor geometry
underneath, so downstream code written against aniposelib runs unchanged.

A group holds a numpy ``CameraRig`` and the ``device`` and ``dtype`` its
work runs in: the card and float32 unless the caller asks otherwise
(``device="cpu"``); given no device and no card, it raises. Every method
takes and returns numpy, as the JAX package's facade does.
"""

from __future__ import annotations

import copy as _copy
from typing import Sequence

import numpy as np
import torch

from macaque_tpu_torch.cameras.rig import CameraRig
from macaque_tpu_torch.core.device import resolve_device


class _CameraView:
    """Per-camera accessor facade (reference ``Camera`` /
    ``OmnidirCamera`` objects, cameras.py:173-555): reads and writes go
    straight to the owning group's rig arrays."""

    def __init__(self, group: "CameraGroup", i: int):
        self._g = group
        self._i = i

    # identity / size
    def get_name(self):
        return self._g.rig.camera_ids[self._i]

    def set_name(self, name):
        ids = list(self._g.rig.camera_ids)
        ids[self._i] = str(name)
        self._g.rig.camera_ids = ids

    def get_size(self):
        return self._g.rig.size

    def set_size(self, size):
        self._g.rig.size = (int(size[0]), int(size[1]))

    # intrinsics
    def get_camera_matrix(self):
        return np.array(self._g.rig.K[self._i], float)

    def set_camera_matrix(self, K):
        self._g.rig.K = np.asarray(self._g.rig.K, float).copy()
        self._g.rig.K[self._i] = np.asarray(K, float)

    def get_focal_length(self):
        K = self._g.rig.K[self._i]
        return float((K[0, 0] + K[1, 1]) / 2)

    def set_focal_length(self, f):
        self._g.rig.K = np.asarray(self._g.rig.K, float).copy()
        self._g.rig.K[self._i][0, 0] = float(f)
        self._g.rig.K[self._i][1, 1] = float(f)

    def get_distortions(self):
        return np.array(self._g.rig.D[self._i], float)

    def set_distortions(self, D):
        self._g.rig.D = np.asarray(self._g.rig.D, float).copy()
        self._g.rig.D[self._i] = np.asarray(D, float).ravel()[:4]

    def get_xi(self):
        return float(np.asarray(self._g.rig.xi)[self._i])

    def set_xi(self, xi):
        self._g.rig.xi = np.asarray(self._g.rig.xi, float).copy()
        self._g.rig.xi[self._i] = float(xi)

    # extrinsics
    def get_rotation(self):
        return np.array(self._g.rig.rvec[self._i], float)

    def set_rotation(self, rvec):
        self._g.rig.rvec = np.asarray(self._g.rig.rvec, float).copy()
        self._g.rig.rvec[self._i] = np.asarray(rvec, float).ravel()

    def get_translation(self):
        return np.array(self._g.rig.tvec[self._i], float)

    def set_translation(self, tvec):
        self._g.rig.tvec = np.asarray(self._g.rig.tvec, float).copy()
        self._g.rig.tvec[self._i] = np.asarray(tvec, float).ravel()

    def get_extrinsics_mat(self):
        from macaque_tpu_torch.calib.graph_init import make_M

        return make_M(self.get_rotation(), self.get_translation())

    # geometry
    def project(self, points):
        return self._g.subset_cameras([self._i]).project(points)[0]

    def undistort_points(self, points):
        """Raw pixels (N, 2) -> normalized image-plane coords (N, 2)
        (reference OmnidirCamera.undistort_points, cameras.py:498;
        FisheyeCamera.undistort_points, cameras.py:376-382)."""
        from macaque_tpu_torch.cameras.dispatch import undistort_points

        g = self._g
        sub = g.rig.subset([self._i]).camera(g.device, g.dtype)
        p = g._t(np.asarray(points, float).reshape(1, -1, 2))
        return _np(undistort_points(sub, p))[0]

    def distort_points(self, points):
        """Normalized image-plane coords (N, 2) -> raw pixels (N, 2)
        (reference OmnidirCamera.distort_points, cameras.py:487;
        FisheyeCamera.distort_points, cameras.py:366-375): lift to a
        ray and project through the full model without the extrinsic
        transform."""
        from macaque_tpu_torch.cameras.dispatch import project_points

        g = self._g
        sub = g.rig.subset([self._i])
        p = np.asarray(points, float).reshape(-1, 2)
        rays = np.concatenate([p, np.ones((len(p), 1))], axis=1)
        ident_rig = CameraRig(
            camera_ids=list(sub.camera_ids),
            K=np.asarray(sub.K, float), xi=np.asarray(sub.xi, float),
            D=np.asarray(sub.D, float),
            rvec=np.zeros((1, 3)), tvec=np.zeros((1, 3)),
            model=sub.model,
        )
        return _np(project_points(ident_rig.camera(g.device, g.dtype),
                                  g._t(rays)))[0]

    def resize_camera(self, scale):
        """Scale intrinsics for resized images (cameras.py:
        resize_camera). The image size lives on the shared rig, so use
        :meth:`CameraGroup.resize_cameras` to scale a whole group —
        this method only rescales this camera's matrix."""
        K = self.get_camera_matrix()
        K[:2] *= scale
        self.set_camera_matrix(K)

    def copy(self):
        return _CameraView(self._g.copy(), self._i)


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor back on the host as float64 numpy (bool stays bool)."""
    if t.dtype == torch.bool:
        return t.cpu().numpy()
    return t.to("cpu", torch.float64).numpy()


class CameraGroup:
    def __init__(self, rig: CameraRig, device=None, dtype=torch.float32):
        self.rig = rig
        self.device = resolve_device(device)
        self.dtype = dtype

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self.dtype,
                               device=self.device)

    def _cam(self):
        return self.rig.camera(self.device, self.dtype)

    def _like(self, rig: CameraRig) -> "CameraGroup":
        return CameraGroup(rig, self.device, self.dtype)

    @property
    def cameras(self):
        """Per-camera accessor objects (reference CameraGroup.cameras)."""
        return [_CameraView(self, i) for i in range(self.rig.n_cam)]

    def copy(self) -> "CameraGroup":
        return self._like(_copy.deepcopy(self.rig))

    def dump(self, path: str):
        """Write an anipose-format calibration TOML (cameras.py:1998)."""
        self.rig.to_calibration_toml(path)

    def resize_cameras(self, scale):
        for cam in self.cameras:
            cam.resize_camera(scale)
        if self.rig.size is not None:
            self.rig.size = (int(self.rig.size[0] * scale),
                             int(self.rig.size[1] * scale))

    def get_rotations(self):
        return np.asarray(self.rig.rvec, float).copy()

    def set_rotations(self, rvecs):
        self.rig.rvec = np.asarray(rvecs, float).reshape(-1, 3)

    def get_translations(self):
        return np.asarray(self.rig.tvec, float).copy()

    def set_translations(self, tvecs):
        self.rig.tvec = np.asarray(tvecs, float).reshape(-1, 3)

    # ------------------------------------------------------------- loading

    @staticmethod
    def load(calibration_toml: str, device=None,
             dtype=torch.float32) -> "CameraGroup":
        return CameraGroup(CameraRig.from_calibration_toml(calibration_toml),
                           device, dtype)

    @staticmethod
    def from_names(names: Sequence[str], fisheye: bool = False,
                   img_size=(2048, 1536), device=None,
                   dtype=torch.float32) -> "CameraGroup":
        """Uncalibrated group (reference cameras.py:1984-1992
        CameraGroup.from_names; ``fisheye=True`` builds equidistant
        FisheyeCamera rigs) — a starting point for
        :meth:`calibrate_videos`."""
        C = len(names)
        K = np.tile(np.array([
            [float(img_size[0]), 0.0, img_size[0] / 2.0],
            [0.0, float(img_size[0]), img_size[1] / 2.0],
            [0.0, 0.0, 1.0]]), (C, 1, 1))
        rig = CameraRig(
            camera_ids=[str(n) for n in names], K=K,
            xi=np.zeros(C), D=np.zeros((C, 4)),
            rvec=np.zeros((C, 3)), tvec=np.zeros((C, 3)),
            size=(int(img_size[0]), int(img_size[1])),
            model="fisheye" if fisheye else "omnidir",
        )
        return CameraGroup(rig, device, dtype)

    def get_names(self):
        return list(self.rig.camera_ids)

    def subset_cameras_names(self, names: Sequence[str]) -> "CameraGroup":
        return self._like(self.rig.subset_by_names(list(names)))

    def subset_cameras(self, indices) -> "CameraGroup":
        return self._like(self.rig.subset(indices))

    # ------------------------------------------------------------ geometry

    def project(self, points: np.ndarray) -> np.ndarray:
        """(N, 3) -> (C, N, 2)."""
        from macaque_tpu_torch.cameras.dispatch import project_points

        return _np(project_points(
            self._cam(), self._t(np.asarray(points).reshape(-1, 3))))

    def triangulate(self, points: np.ndarray, undistort: bool = True,
                    progress: bool = False) -> np.ndarray:
        """(C, N, 2) raw pixels -> (N, 3); NaN where <2 cameras."""
        from macaque_tpu_torch.cameras.dispatch import undistort_points
        from macaque_tpu_torch.geometry.triangulate import triangulate_dlt

        points = np.asarray(points, float)
        one_point = points.ndim == 2
        if one_point:
            points = points.reshape(-1, 1, 2)
        cam = self._cam()
        p = self._t(points)
        und = undistort_points(cam, p) if undistort else p
        undT = und.transpose(0, 1)
        mask = ~torch.isnan(undT[..., 0])
        out = _np(triangulate_dlt(torch.nan_to_num(undT), cam.pmat, mask))
        return out[0] if one_point else out

    def triangulate_ransac(self, points: np.ndarray, undistort: bool = True,
                           min_cams: int = 2, progress: bool = False):
        from macaque_tpu_torch.geometry.ransac import triangulate_ransac

        p3d, picked, p2d, errs = triangulate_ransac(
            self._cam(), self._t(np.asarray(points, float)),
            min_cams=min_cams,
        )
        picked3 = _np(picked)[:, :, None]  # (C, N, 1) like reference
        return (_np(p3d), picked3, _np(p2d), _np(errs))

    def reprojection_error(self, p3ds: np.ndarray, p2ds: np.ndarray,
                           mean: bool = False):
        from macaque_tpu_torch.geometry.triangulate import (
            reprojection_error, reprojection_error_mean,
        )

        p3ds = np.asarray(p3ds, float)
        p2ds = np.asarray(p2ds, float)
        one_point = p3ds.ndim == 1
        if one_point:
            p3ds = p3ds.reshape(1, 3)
            p2ds = p2ds.reshape(-1, 1, 2)
        cam = self._cam()
        if mean:
            out = _np(reprojection_error_mean(cam, self._t(p3ds),
                                              self._t(p2ds)))
            return float(out[0]) if one_point else out
        out = _np(reprojection_error(cam, self._t(p3ds), self._t(p2ds)))
        return out.reshape(-1, 2) if one_point else out

    def average_error(self, p2ds, median: bool = False):
        """Mean/median per-point reprojection error after triangulating
        (reference cameras.py:1883-1890)."""
        p3ds = self.triangulate(p2ds)
        errors = self.reprojection_error(p3ds, p2ds, mean=True)
        errors = errors[np.isfinite(errors)]
        return float(np.median(errors) if median else np.mean(errors))

    def triangulate_possible(self, points, undistort: bool = True,
                             min_cams: int = 2, progress: bool = False,
                             threshold: float = 0.5):
        """(C, N, P, 2) candidate detections -> best-combination
        triangulation per point (reference cameras.py:639-724): every
        per-camera candidate choice (including skipping a camera) is
        triangulated and the lowest-mean-reprojection combination below
        the error ceiling wins. Candidate combinations for one point are
        evaluated as ONE batched DLT. Returns (p3ds (N, 3), picked
        (C, N, P) bool, points_2d (C, N, 2), errors (N,))."""
        import itertools

        points = np.asarray(points, float)
        C, N, P, _ = points.shape
        out = np.full((N, 3), np.nan)
        picked_vals = np.zeros((C, N, P), bool)
        errors = np.zeros(N)
        points_2d = np.full((C, N, 2), np.nan)

        for n in range(N):
            opts = []
            cams = []
            for c in range(C):
                cand = [p for p in range(P)
                        if np.isfinite(points[c, n, p, 0])]
                if cand:
                    cams.append(c)
                    opts.append(cand + [None])
            if len(cams) < min_cams:
                continue
            combos = [cb for cb in itertools.product(*opts)
                      if sum(x is not None for x in cb) >= min_cams]
            if not combos:
                continue
            obs = np.full((C, len(combos), 2), np.nan)
            for k, cb in enumerate(combos):
                for c, p in zip(cams, cb):
                    if p is not None:
                        obs[c, k] = points[c, n, p]
            p3 = self.triangulate(obs, undistort=undistort)
            errs = self.reprojection_error(p3, obs, mean=True)
            errs = np.where(np.isfinite(errs), errs, np.inf)
            # the reference walks combos in product order and STOPS at
            # the first one under `threshold` (cameras.py:703-713)
            under = np.flatnonzero(errs < threshold)
            best = int(under[0]) if under.size else int(np.argmin(errs))
            if errs[best] >= 200:       # reference's best_error ceiling
                continue
            out[n] = p3[best]
            errors[n] = errs[best]
            points_2d[:, n] = obs[:, best]
            for c, p in zip(cams, combos[best]):
                if p is not None:
                    picked_vals[c, n, p] = True
        return out, picked_vals, points_2d, errors

    # -------------------------------------------------------- optimization

    def bundle_adjust(self, p2ds, extra=None, loss="linear",
                      threshold: float = 50, ftol: float = 1e-4,
                      max_nfev: int = 1000, weights=None,
                      start_params=None, verbose: bool = True):
        """Fine-tune all camera parameters from (C, N, 2) observations
        (reference cameras.py:894-946): triangulate with the current
        calibration, then run the full 16-parameter-per-camera bundle
        (LM-CGLS, calib/bundle.py) and write the result back into the
        group. Fisheye rigs optimize the reference's FisheyeCamera
        parameter set instead (rvec/tvec/f/k1, cameras.py:392-418).
        Returns the post-optimization mean reprojection error."""
        from macaque_tpu_torch.calib.bundle import (
            bundle_adjust_fisheye, bundle_adjust_full,
        )
        from macaque_tpu_torch.geometry.lm import LMConfig

        p2ds = np.asarray(p2ds, float)
        p3d = self.triangulate(p2ds)
        good = np.isfinite(p3d[:, 0])
        if good.sum() < 8:
            return self.average_error(p2ds)
        rig = self.rig
        cfg = LMConfig(lm_iters=min(60, max(10, max_nfev // 10)),
                       cg_iters=100, ftol=ftol)
        on = {"device": self.device, "dtype": self.dtype}
        if rig.model == "fisheye":
            K2, D2, rv, tv, _, rms = bundle_adjust_fisheye(
                np.asarray(rig.K, float), np.asarray(rig.D, float),
                np.asarray(rig.rvec, float), np.asarray(rig.tvec, float),
                p2ds[:, good], np.nan_to_num(p3d[good]), cfg=cfg, **on,
            )
            rig.K, rig.D = K2, D2
        else:
            K2, xi2, D2, rv, tv, _, rms = bundle_adjust_full(
                np.asarray(rig.K, float), np.asarray(rig.xi, float),
                np.asarray(rig.D, float), np.asarray(rig.rvec, float),
                np.asarray(rig.tvec, float),
                p2ds[:, good], np.nan_to_num(p3d[good]), cfg=cfg, **on,
            )
            rig.K, rig.xi, rig.D = K2, xi2, D2
        rig.rvec, rig.tvec = rv, tv
        if verbose:
            print(f"bundle_adjust: rms {rms:.3f} px")
        return self.average_error(p2ds)

    def bundle_adjust_iter(self, p2ds, extra=None, n_iters: int = 10,
                           start_mu: float = 15, end_mu: float = 1,
                           max_nfev: int = 200, ftol: float = 1e-4,
                           n_samp_iter: int = 100, n_samp_full: int = 1000,
                           error_threshold: float = 0.3,
                           verbose: bool = False):
        """Iterative outlier-annealed bundle adjustment (reference
        cameras.py:786-892, the Fast-Global-Registration-style loop):
        each round resamples points, prunes those whose reprojection
        error exceeds an exponentially decaying ceiling ``mu``, and
        re-runs :meth:`bundle_adjust` on the survivors. Returns the
        final median reprojection error."""
        rng = np.random.default_rng(0)
        p2ds_full = np.asarray(p2ds, float)

        def resample(pts, n_samp):
            n = pts.shape[1]
            if n <= n_samp:
                return pts
            pick = rng.choice(n, size=n_samp, replace=False)
            return pts[:, pick]

        mus = np.exp(np.linspace(np.log(start_mu), np.log(end_mu),
                                 num=n_iters))
        error = None
        for i in range(n_iters):
            samp = resample(p2ds_full, n_samp_full)
            p3ds = self.triangulate(samp)
            errn = self.reprojection_error(p3ds, samp, mean=True)
            finite = np.isfinite(errn)
            if finite.sum() < 8:
                break
            # keep mu above the 10th error percentile so pruning never
            # starves the solver (stands in for the reference's
            # per-camera percentile clamp)
            mu = max(mus[i], float(np.percentile(errn[finite], 10)))
            good = finite & (errn < mu)
            error = float(np.median(errn[finite]))
            if verbose:
                print(f"iter {i}: error {error:.2f}, mu {mu:.1f}, "
                      f"kept {good.mean():.2f}")
            if error < error_threshold:
                break
            self.bundle_adjust(resample(samp[:, good], n_samp_iter),
                               loss="linear", ftol=ftol,
                               max_nfev=max_nfev, verbose=verbose)

        samp = resample(p2ds_full, n_samp_full)
        p3ds = self.triangulate(samp)
        errn = self.reprojection_error(p3ds, samp, mean=True)
        finite = np.isfinite(errn)
        good = finite & (errn < max(end_mu,
                                    float(np.percentile(errn[finite], 10))))
        if good.sum() >= 8:
            self.bundle_adjust(samp[:, good], loss="linear", ftol=ftol,
                               max_nfev=max(200, max_nfev),
                               verbose=verbose)
        return self.average_error(samp, median=True)

    def _refine_config(self, kwargs):
        """The refinement's config at the facade's parity budget: the
        aniposelib surface keeps the converge-to-reference budget (the
        JAX facade's), not the pipeline's production one."""
        from macaque_tpu_torch.geometry.refine3d import RefineConfig

        return RefineConfig(
            scale_smooth=kwargs.get("scale_smooth", 4),
            scale_length=kwargs.get("scale_length", 2),
            scale_length_weak=kwargs.get("scale_length_weak", 0.5),
            reproj_error_threshold=kwargs.get("reproj_error_threshold", 15),
            reproj_loss=kwargs.get("reproj_loss", "soft_l1"),
            n_deriv_smooth=kwargs.get("n_deriv_smooth", 1),
            lm_iters=100, cg_iters=300, cg_rtol=1e-4,
        )

    def optim_points(self, points: np.ndarray, p3ds: np.ndarray,
                     constraints=(), constraints_weak=(),
                     scale_smooth=4, scale_length=2, scale_length_weak=0.5,
                     reproj_error_threshold=15, reproj_loss="soft_l1",
                     n_deriv_smooth=1, scores=None, verbose=False):
        """(C, F, J, 2) + (F, J, 3) -> refined (F, J, 3), joint lengths."""
        from macaque_tpu_torch.geometry.refine3d import refine_points_3d

        cfg = self._refine_config(dict(
            scale_smooth=scale_smooth, scale_length=scale_length,
            scale_length_weak=scale_length_weak,
            reproj_error_threshold=reproj_error_threshold,
            reproj_loss=reproj_loss, n_deriv_smooth=n_deriv_smooth))
        p3, jl = refine_points_3d(
            self._cam(), self._t(points), self._t(p3ds),
            constraints=list(constraints),
            constraints_weak=list(constraints_weak), cfg=cfg,
            scores=None if scores is None else self._t(scores),
        )
        return _np(p3), _np(jl)

    def optim_points_jointlenfix(self, points, p3ds, joint_len, **kwargs):
        from macaque_tpu_torch.geometry.refine3d import refine_points_3d

        p3, jl = refine_points_3d(
            self._cam(), self._t(points), self._t(p3ds),
            constraints=list(kwargs.get("constraints", ())),
            constraints_weak=list(kwargs.get("constraints_weak", ())),
            cfg=self._refine_config(kwargs),
            joint_lengths=self._t(joint_len),
        )
        return _np(p3), _np(jl)

    # -------------------------------------------------------- calibration

    def calibrate_rows(self, all_rows, board, init_intrinsics=True,
                       init_extrinsics=True, verbose=True, **kwargs):
        """Calibrate the whole group from per-camera board-detection rows
        (reference cameras.py:1891-1926): per-camera intrinsic init from
        planar views, PnP board poses, spanning-tree extrinsic init, then
        a full bundle adjustment (LM-CGLS) over all shared views.
        Returns the final reprojection rms in px."""
        import cv2

        from macaque_tpu_torch.calib.bundle import (
            bundle_adjust_fisheye, bundle_adjust_full,
        )
        from macaque_tpu_torch.calib.graph_init import (
            initial_extrinsics_from_board_poses,
        )
        from macaque_tpu_torch.calib.videos import (
            estimate_pose_rows, extract_points, merge_rows,
        )

        rig = self.rig
        names = self.get_names()
        assert len(all_rows) == rig.n_cam
        size = rig.size or (2048, 1536)
        on = {"device": self.device, "dtype": self.dtype}

        K = np.array(rig.K, float)
        D = np.array(rig.D, float)
        if init_intrinsics:
            objp_full = board.object_points()
            for i, rows in enumerate(all_rows):
                obj_v, img_v = [], []
                for r in rows:
                    filled = np.asarray(r["filled"], float).reshape(-1, 2)
                    good = ~np.isnan(filled[:, 0])
                    if good.sum() >= 7:
                        obj_v.append(objp_full[good].reshape(-1, 1, 3)
                                     .astype(np.float32))
                        img_v.append(filled[good].reshape(-1, 1, 2)
                                     .astype(np.float32))
                if not obj_v:
                    raise ValueError(
                        f"camera {names[i]}: no usable board views")
                K[i] = cv2.initCameraMatrix2D(obj_v, img_v, tuple(size))

        def fisheye_pose_rows():
            # PnP on equidistant pixels with a pinhole model is biased
            # (r = f*theta, not f*tan(theta)); normalize through the
            # fisheye model and solve with eye(3) (reference
            # boards.py:494-516 has the same intent)
            from macaque_tpu_torch.cameras.fisheye import FisheyeCamera

            for i, rows in enumerate(all_rows):
                cam_i = FisheyeCamera(
                    K=self._t(K[i]), D=self._t(D[i]),
                    rvec=self._t(np.zeros(3)), tvec=self._t(np.zeros(3)))
                estimate_pose_rows(rows, board, K[i], np.zeros(5),
                                   camera=cam_i)

        if rig.model == "fisheye":
            fisheye_pose_rows()
        else:
            for i, rows in enumerate(all_rows):
                estimate_pose_rows(rows, board, K[i], np.zeros(5))

        if rig.model == "fisheye" and init_intrinsics:
            # Per-camera intrinsic fit (the cv2.fisheye.calibrate role):
            # the pinhole initCameraMatrix2D seed is systematically
            # biased on equidistant images and the group bundle cannot
            # recover the focal from it (focal<->depth gauge valley);
            # the multi-view planar fit makes f identifiable. Then redo
            # the board poses with the calibrated model.
            from macaque_tpu_torch.calib.bundle import (
                calibrate_intrinsics_fisheye,
            )

            objp_full = board.object_points()
            for i, rows in enumerate(all_rows):
                posed = [r for r in rows if r.get("rvec") is not None]
                if len(posed) < 3:
                    continue
                imgp_v = np.stack([
                    np.asarray(r["filled"], float).reshape(-1, 2)
                    for r in posed])
                objp_v = np.tile(objp_full[None], (len(posed), 1, 1))
                rv0 = np.stack([np.asarray(r["rvec"], float).ravel()
                                for r in posed])
                tv0 = np.stack([np.asarray(r["tvec"], float).ravel()
                                for r in posed])
                K_i, D_i, _, _, _ = calibrate_intrinsics_fisheye(
                    objp_v, imgp_v, init_f=K[i][0, 0],
                    init_c=(K[i][0, 2], K[i][1, 2]), img_size=size,
                    init_rvecs=rv0, init_tvecs=tv0, **on)
                K[i] = K_i
                D[i] = D_i
            fisheye_pose_rows()

        merged = merge_rows(all_rows, cam_names=names)
        imgp, extra = extract_points(merged, board, cam_names=names,
                                     min_cameras=2)
        if verbose:
            print(f"calibrate_rows: {imgp.shape[1]} shared points over "
                  f"{len(merged)} merged views")

        if init_extrinsics:
            board_poses = [
                [
                    (row[n]["rvec"], row[n]["tvec"])
                    if n in row and row[n].get("rvec") is not None
                    else None
                    for row in merged
                ]
                for n in names
            ]
            rvecs, tvecs = initial_extrinsics_from_board_poses(board_poses)
        else:
            rvecs = np.array(rig.rvec, float)
            tvecs = np.array(rig.tvec, float)

        xi = np.array(rig.xi, float)

        # structure init: DLT-triangulate the shared points with the
        # initial calibration
        init_rig = CameraRig(camera_ids=names, K=K, xi=xi, D=D,
                             rvec=rvecs, tvec=tvecs, size=size,
                             model=rig.model)
        p3d0 = self._like(init_rig).triangulate(imgp)
        seen = np.isfinite(p3d0[:, 0])
        obs = imgp[:, seen]
        if rig.model == "fisheye":
            K2, D2, rv, tv, _, rms = bundle_adjust_fisheye(
                K, D, rvecs, tvecs, obs, np.nan_to_num(p3d0[seen]),
                **kwargs, **on)
            xi2 = xi
        else:
            K2, xi2, D2, rv, tv, _, rms = bundle_adjust_full(
                K, xi, D, rvecs, tvecs, obs, np.nan_to_num(p3d0[seen]),
                **kwargs, **on)
        if verbose:
            print(f"calibrate_rows: bundle rms {rms:.3f} px")

        self.rig = CameraRig(camera_ids=names, K=K2, xi=xi2, D=D2,
                             rvec=rv, tvec=tv, mtx=rig.mtx,
                             dist=rig.dist, size=size,
                             metadata=dict(rig.metadata),
                             model=rig.model)
        return rms

    def calibrate_videos(self, videos, board, init_intrinsics=True,
                         init_extrinsics=True, verbose=True, **kwargs):
        """Calibrate from recorded board videos: ``videos`` is a list (one
        per camera) of lists of filenames (reference cameras.py:1950-1964).
        Returns (rms, all_rows)."""
        from macaque_tpu_torch.calib.videos import detect_board_video

        all_rows = []
        for cam_videos in videos:
            rows_cam = []
            for vnum, vidname in enumerate(cam_videos):
                if verbose:
                    print(vidname)
                rows = detect_board_video(vidname, board, prefix=vnum)
                if verbose:
                    print(f"{len(rows)} boards detected")
                rows_cam.extend(rows)
            all_rows.append(rows_cam)

        rms = self.calibrate_rows(all_rows, board,
                                  init_intrinsics=init_intrinsics,
                                  init_extrinsics=init_extrinsics,
                                  verbose=verbose, **kwargs)
        return rms, all_rows

    def optim_points_possible(self, points: np.ndarray, p3ds: np.ndarray,
                              constraints=(), constraints_weak=(),
                              scale_smooth=4, scale_length=2,
                              scale_length_weak=0.5,
                              reproj_error_threshold=15,
                              reproj_loss="soft_l1", n_deriv_smooth=1,
                              scores=None, verbose=False):
        """Multi-hypothesis refinement: (C, F, J, P, 2) candidate points
        + (F, J, 3) init -> (refined (F, J, 3), soft-argmax weights
        (C, F, J, P)) (reference cameras.py:1417-1513)."""
        from macaque_tpu_torch.geometry.refine3d import (
            refine_points_3d_possible,
        )

        cfg = self._refine_config(dict(
            scale_smooth=scale_smooth, scale_length=scale_length,
            scale_length_weak=scale_length_weak,
            reproj_error_threshold=reproj_error_threshold,
            reproj_loss=reproj_loss, n_deriv_smooth=n_deriv_smooth))
        p3, alphas = refine_points_3d_possible(
            self._cam(), self._t(points), self._t(p3ds),
            constraints=list(constraints),
            constraints_weak=list(constraints_weak), cfg=cfg,
            scores=None if scores is None else self._t(scores),
        )
        return _np(p3), _np(alphas)

    def triangulate_optim(self, points: np.ndarray, init_ransac=False,
                          init_progress=False, **kwargs):
        """(C, F, J, 2) -> refined (F, J, 3) (reference cameras.py:1516)."""
        C, F, J, _ = points.shape
        flat = points.reshape(C, F * J, 2)
        if init_ransac:
            p3d, _, _, _ = self.triangulate_ransac(flat)
        else:
            p3d = self.triangulate(flat)
        p3d = p3d.reshape(F, J, 3)
        if np.isfinite(p3d[..., 0]).sum() < 20:
            return p3d
        return self.optim_points(points, p3d, **kwargs)
