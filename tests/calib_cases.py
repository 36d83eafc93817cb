"""Calibration scenes shared by the CPU parity tests of the calibration
(test_torch_calib.py, test_torch_aniposelib.py) and the card tests
(test_torch_cuda.py): the scenes of tests/test_calib.py, drawn from the same
seeds in the same order, projected with the port's camera models in float64.
Imports neither JAX nor the JAX package."""

import numpy as np
import torch

from macaque_tpu_torch.calib.boards import chessboard_object_points
from macaque_tpu_torch.cameras.fisheye import FisheyeCamera, fisheye_project
from macaque_tpu_torch.cameras.omnidir import OmnidirCamera, omnidir_project
from macaque_tpu_torch.cameras.rotation import rodrigues_inv


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def omni_project(K, xi, D, rvec, tvec, pts):
    """Numpy in, numpy out: (C, P, 2) pixels of (P, 3) points, or
    (V, N, 2) of (V, N, 3) per-view points."""
    cam = OmnidirCamera(*(_t(a) for a in (K, xi, D, rvec, tvec)))
    return omnidir_project(cam, _t(pts)).numpy()


def fisheye_project_np(K, D, rvec, tvec, pts):
    cam = FisheyeCamera(*(_t(a) for a in (K, D, rvec, tvec)))
    return fisheye_project(cam, _t(pts)).numpy()


def make_omni_cam(seed=0, n=1):
    """tests/test_cameras.py::make_omni_cam as numpy (K, xi, D, rvec, tvec)."""
    rng = np.random.default_rng(seed)
    K = np.zeros((n, 3, 3))
    K[:, 0, 0] = 800 + rng.uniform(-50, 50, n)
    K[:, 1, 1] = 805 + rng.uniform(-50, 50, n)
    K[:, 0, 1] = rng.uniform(-2, 2, n)
    K[:, 0, 2] = 1024 + rng.uniform(-20, 20, n)
    K[:, 1, 2] = 768 + rng.uniform(-20, 20, n)
    K[:, 2, 2] = 1.0
    xi = 1.2 + rng.uniform(-0.2, 0.2, n)
    D = rng.uniform(-0.05, 0.05, (n, 4))
    rvec = rng.uniform(-0.5, 0.5, (n, 3))
    tvec = rng.uniform(-100, 100, (n, 3))
    tvec[:, 2] += 1500
    return K, xi, D, rvec, tvec


def make_rig(n_cam=4, seed=0):
    """tests/test_triangulate.py::make_rig as numpy (K, xi, D, rvec, tvec):
    cameras in a rough ring around the origin looking inward."""
    rng = np.random.default_rng(seed)
    K = np.tile(np.array([[800.0, 0.5, 1024], [0, 805, 768], [0, 0, 1]]),
                (n_cam, 1, 1))
    K[:, 0, 0] += rng.uniform(-30, 30, n_cam)
    xi = 1.1 + rng.uniform(-0.1, 0.1, n_cam)
    D = rng.uniform(-0.03, 0.03, (n_cam, 4))
    Rs, tvecs = [], []
    for i in range(n_cam):
        ang = 2 * np.pi * i / n_cam
        cam_pos = np.array([3000 * np.cos(ang), 3000 * np.sin(ang), 500.0])
        z = -cam_pos / np.linalg.norm(cam_pos)
        x = np.cross(np.array([0.0, 0.0, -1.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        Rs.append(R)
        tvecs.append(-R @ cam_pos)
    rvec = rodrigues_inv(_t(np.stack(Rs))).numpy()
    return K, xi, D, rvec, np.stack(tvecs)


def intrinsic_scene():
    """tests/test_calib.py::test_intrinsic_calibration_recovers_params:
    12 views of a 6x5 board (80 mm) through a Mei camera, 0.05 px noise.
    Returns (obj (V, N, 3), img (V, N, 2), keyword arguments of the fit)."""
    K, xi, D, _, _ = make_omni_cam(seed=11)
    rng = np.random.default_rng(0)
    board = chessboard_object_points(6, 5, 80.0)
    V = 12
    rvecs, tvecs, img = [], [], []
    for _ in range(V):
        rv = rng.uniform(-0.4, 0.4, 3)
        tv = np.array([rng.uniform(-200, 200), rng.uniform(-200, 200),
                       rng.uniform(900, 1600)])
        pix = omni_project(K, xi, D, rv[None], tv[None], board)[0]
        rvecs.append(rv)
        tvecs.append(tv)
        img.append(pix + rng.normal(0, 0.05, pix.shape))
    kw = dict(
        init_f=K[0, 0, 0] * 0.9,
        init_c=(K[0, 0, 2] + 15, K[0, 1, 2] - 10),
        init_rvecs=np.stack(rvecs) + rng.normal(0, 0.02, (V, 3)),
        init_tvecs=np.stack(tvecs) + rng.normal(0, 20, (V, 3)),
    )
    return np.tile(board[None], (V, 1, 1)), np.stack(img), kw


FISHEYE_K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]])
FISHEYE_D = np.array([-0.015, 0.006, 0.0, 0.0])


def fisheye_intrinsic_scene(V=10, seed=11):
    """A 9x6 board (23 mm) in ``V`` views of an equidistant camera at
    640x480 (the board poses of tests/test_calib_workflow.py's fisheye
    group), 0.05 px noise, poses seeded within 0.02 rad and 10 mm.
    Returns (obj, img, keyword arguments of the fit)."""
    obj = chessboard_object_points(9, 6, 23.0)
    rng = np.random.default_rng(seed)
    img, rvs, tvs = [], [], []
    for _ in range(V):
        rv = np.array([np.pi, 0, 0]) + rng.uniform(-0.4, 0.4, 3)
        tv = np.array([rng.uniform(-80, 80), rng.uniform(-60, 60),
                       rng.uniform(500, 900)])
        img.append(fisheye_project_np(FISHEYE_K, FISHEYE_D, rv, tv, obj)
                   + rng.normal(0, 0.05, (54, 2)))
        rvs.append(rv + rng.normal(0, 0.02, 3))
        tvs.append(tv + rng.normal(0, 10, 3))
    kw = dict(init_f=560.0, init_c=(320.0, 240.0), img_size=(640, 480),
              init_rvecs=np.stack(rvs), init_tvecs=np.stack(tvs))
    return np.tile(obj[None], (V, 1, 1)), np.stack(img), kw


def extrinsic_scene():
    """tests/test_calib.py::test_extrinsic_bundle_adjustment: 4 cameras,
    60 points, 0.1 px noise, 10 observations missing, cameras 1-3
    perturbed. Returns (solver arguments, truth (K, xi, D, rvec, tvec))."""
    K, xi, D, rvec, tvec = make_rig(4, seed=21)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-400, 400, (60, 3))
    obs = omni_project(K, xi, D, rvec, tvec, pts)
    obs += rng.normal(0, 0.1, obs.shape)
    obs[1, :10] = np.nan
    rv0 = rvec + np.concatenate([np.zeros((1, 3)), rng.normal(0, 0.01, (3, 3))])
    tv0 = tvec + np.concatenate([np.zeros((1, 3)), rng.normal(0, 20, (3, 3))])
    pts0 = pts + rng.normal(0, 30, pts.shape)
    return (K, xi, D, rv0, tv0, obs, pts0), (K, xi, D, rvec, tvec)


def full_scene():
    """tests/test_calib.py::test_full_bundle_adjustment_improves: 4
    cameras, 80 points, no noise, focal lengths 2 % off, rotations
    perturbed. Returns (solver arguments, truth)."""
    K, xi, D, rvec, tvec = make_rig(4, seed=31)
    rng = np.random.default_rng(2)
    pts = rng.uniform(-400, 400, (80, 3))
    obs = omni_project(K, xi, D, rvec, tvec, pts)
    K0 = K.copy()
    K0[:, 0, 0] *= 1.02
    rv0 = rvec + np.concatenate([np.zeros((1, 3)),
                                 rng.normal(0, 0.005, (3, 3))])
    pts0 = pts + rng.normal(0, 10, pts.shape)
    return (K0, xi, D, rv0, tvec, obs, pts0), (K, xi, D, rvec, tvec)


def fisheye_ba_scene():
    """make_rig(3, seed=41)'s ring as equidistant cameras (f 800, k1
    -0.015, k2 0.006), 80 points, 0.1 px noise, focal lengths 2 % off,
    cameras 1-2 perturbed. Returns (solver arguments, truth (K, D, rvec,
    tvec))."""
    _, _, _, rvec, tvec = make_rig(3, seed=41)
    K = np.tile(np.array([[800.0, 0, 1024], [0, 800.0, 768], [0, 0, 1]]),
                (3, 1, 1))
    D = np.tile(np.array([-0.015, 0.006, 0.0, 0.0]), (3, 1))
    rng = np.random.default_rng(5)
    pts = rng.uniform(-400, 400, (80, 3))
    obs = fisheye_project_np(K, D, rvec, tvec, pts)
    obs += rng.normal(0, 0.1, obs.shape)
    K0 = K.copy()
    K0[:, 0, 0] *= 1.02
    K0[:, 1, 1] *= 1.02
    rv0 = rvec + np.concatenate([np.zeros((1, 3)), rng.normal(0, 0.005, (2, 3))])
    tv0 = tvec + np.concatenate([np.zeros((1, 3)), rng.normal(0, 10, (2, 3))])
    pts0 = pts + rng.normal(0, 10, pts.shape)
    return (K0, D, rv0, tv0, obs, pts0), (K, D, rvec, tvec)


def centers(rvecs, tvecs):
    """World-frame camera centres -R^T t, (C, 3)."""
    from macaque_tpu_torch.cameras.rotation import rodrigues

    R = rodrigues(_t(rvecs)).numpy()
    return -np.einsum("cji,cj->ci", R, np.asarray(tvecs, float))


def scale_aligned_center_errors(rv, tv, rv_true, tv_true):
    """Camera-centre errors up to the global scale about camera 0 (the
    gauge of a BA with camera 0 fixed and the structure free; the
    alignment of tests/test_calib.py). Returns (errors (C,), scale)."""
    c_est, c_true = centers(rv, tv), centers(rv_true, tv_true)
    rel_est, rel_true = c_est - c_est[0], c_true - c_true[0]
    s = float(np.sum(rel_est * rel_true) / np.sum(rel_est * rel_est))
    return np.linalg.norm(s * rel_est - rel_true, axis=1), s
