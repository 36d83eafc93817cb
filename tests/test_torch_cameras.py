"""The port's camera and rig modules against the JAX package's: rotations,
the omnidir, pinhole and fisheye models and their dispatch, the rig's
``pmat``, its h5 and anipose-TOML readers and writers. JAX runs under x64
(tests/conftest.py), the port in float64, on the same seeded numpy inputs
(those of tests/test_cameras.py); tolerance 1e-10 absolute."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from macaque_tpu import cameras as jc
from macaque_tpu.cameras.dispatch import project_fn as j_project_fn
from macaque_tpu.cameras.omnidir import (
    unproject_ray_from_undistorted as j_unproject)
from macaque_tpu.cameras.rig import CameraRig as JRig
from macaque_tpu.tools.synthetic import make_test_rig as jax_test_rig
from macaque_tpu_torch import cameras as tc
from macaque_tpu_torch.cameras.dispatch import project_fn, undistort_fn
from macaque_tpu_torch.cameras.omnidir import (
    unproject_ray_from_undistorted as t_unproject)
from macaque_tpu_torch.cameras.rig import CameraRig as TRig
from tests.test_cameras import make_omni_cam, world_points

TOL = 1e-10


def _t(x):
    return torch.from_numpy(np.array(x, np.float64))


def _port(cam, cls):
    """A JAX camera NamedTuple -> the port's, field by field."""
    return cls(*[_t(f) for f in cam])


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _port_rig(rig: JRig) -> TRig:
    return TRig(**{f.name: getattr(rig, f.name)
                   for f in dataclasses.fields(JRig)})


# ------------------------------------------------------------- rotations

def test_rodrigues_matches_jax():
    rvec = np.random.default_rng(0).uniform(-2, 2, (20, 3))
    rvec[0] = 0.0
    _close(tc.rodrigues(_t(rvec)), jc.rodrigues(jnp.asarray(rvec)))


def test_rodrigues_inv_matches_jax():
    rvec = np.random.default_rng(1).uniform(-1.5, 1.5, (10, 3))
    R = np.asarray(jc.rodrigues(jnp.asarray(rvec)))
    got = tc.rodrigues_inv(_t(R))
    _close(got, jc.rodrigues_inv(jnp.asarray(R)))
    _close(got, rvec)


@pytest.mark.parametrize("dt", [0.0, 1e-9, 1e-6, 3e-5])
def test_rodrigues_inv_round_trip_near_pi(dt):
    """theta ~ pi: the symmetric-part branch. At pi the sign of the axis
    is a gauge freedom, so the rotations are compared."""
    axes = np.random.default_rng(2).normal(size=(12, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    R = tc.rodrigues(_t(axes * (np.pi - dt)))
    back = tc.rodrigues_inv(R)
    _close(tc.rodrigues(back), R, 1e-7)
    _close(torch.linalg.vector_norm(back, dim=1), np.full(12, np.pi - dt), 1e-6)
    _close(tc.rodrigues(back),
           jc.rodrigues(jc.rodrigues_inv(jnp.asarray(R.numpy()))), 1e-7)


def test_rotate_points_matches_jax():
    rng = np.random.default_rng(3)
    rvec, pts = rng.uniform(-2, 2, (4, 3)), rng.uniform(-500, 500, (4, 9, 3))
    _close(tc.rotate_points(_t(rvec), _t(pts)),
           jc.rotate_points(jnp.asarray(rvec), jnp.asarray(pts)))


# --------------------------------------------------------------- omnidir

@pytest.mark.parametrize("seed", [0, 2, 4])
def test_omnidir_project_undistort_unproject_match_jax(seed):
    jcam = make_omni_cam(seed, n=3)
    cam = _port(jcam, tc.OmnidirCamera)
    pts = world_points(seed + 1, 40)
    pix = jc.omnidir_project(jcam, jnp.asarray(pts))
    _close(tc.omnidir_project(cam, _t(pts)), pix)   # pixels ~ 1e3
    pix = np.asarray(pix)
    _close(tc.omnidir_undistort(cam, _t(pix)),
           jc.omnidir_undistort(jcam, jnp.asarray(pix)))
    for depth in (0.0, 1000.0):
        _close(tc.omnidir_unproject_ray(cam, _t(pix), depth),
               jc.omnidir_unproject_ray(jcam, jnp.asarray(pix), depth))
    und = pix / 1e3
    _close(t_unproject(cam, _t(und), 500.0),
           j_unproject(jcam, jnp.asarray(und), 500.0))
    _close(cam.pmat, jcam.pmat)


def test_omnidir_undistort_propagates_nan():
    jcam = make_omni_cam(6)
    pix = np.array([[[np.nan, np.nan], [1000.0, 700.0]]])
    got = tc.omnidir_undistort(_port(jcam, tc.OmnidirCamera), _t(pix))
    assert torch.isnan(got[0, 0]).all() and torch.isfinite(got[0, 1]).all()
    _close(got, jc.omnidir_undistort(jcam, jnp.asarray(pix)))


# ------------------------------------------------------- pinhole, fisheye

def _pinhole():
    rng = np.random.default_rng(7)
    K = np.array([[900.0, 0, 640], [0, 910, 360], [0, 0, 1]])
    dist = np.array([-0.2, 0.05, 0.001, -0.002, 0.01])
    return jc.PinholeCamera(
        K=jnp.asarray(K[None]), dist=jnp.asarray(dist[None]),
        rvec=jnp.asarray(rng.uniform(-0.4, 0.4, (1, 3))),
        tvec=jnp.asarray([[10.0, -5.0, 800.0]]))


def _fisheye():
    rng = np.random.default_rng(11)
    K = np.array([[[600.0, 0, 640], [0, 605, 480], [0, 0, 1]]] * 2)
    return jc.FisheyeCamera(
        K=jnp.asarray(K), D=jnp.asarray(rng.uniform(-0.05, 0.05, (2, 4))),
        rvec=jnp.asarray(rng.uniform(-0.4, 0.4, (2, 3))),
        tvec=jnp.asarray(np.array([[10.0, -5.0, 900.0], [0, 20.0, 1100.0]])))


def test_pinhole_project_undistort_match_jax():
    jcam = _pinhole()
    cam = _port(jcam, tc.PinholeCamera)
    pts = world_points(8, 30)
    _close(tc.pinhole_project(cam, _t(pts)),
           jc.pinhole_project(jcam, jnp.asarray(pts)))
    pix = np.random.default_rng(9).uniform([200, 100], [1000, 600], (1, 40, 2))
    _close(tc.pinhole_undistort(cam, _t(pix)),
           jc.pinhole_undistort(jcam, jnp.asarray(pix)))
    _close(cam.pmat, jcam.pmat)


def test_fisheye_project_undistort_match_jax():
    jcam = _fisheye()
    cam = _port(jcam, tc.FisheyeCamera)
    pts = world_points(12, 30)
    _close(tc.fisheye_project(cam, _t(pts)),
           jc.fisheye_project(jcam, jnp.asarray(pts)))
    pix = np.random.default_rng(13).uniform([0, 0], [1280, 960], (2, 40, 2))
    pix[0, 0] = [640.0, 480.0]                 # the centre: theta_d = 0
    pix[1, 1] = np.nan
    _close(tc.fisheye_undistort(cam, _t(pix)),
           jc.fisheye_undistort(jcam, jnp.asarray(pix)))
    _close(cam.pmat, jcam.pmat)


@pytest.mark.parametrize("make, cls", [
    (lambda: make_omni_cam(0, n=2), tc.OmnidirCamera),
    (_pinhole, tc.PinholeCamera),
    (_fisheye, tc.FisheyeCamera)], ids=["omnidir", "pinhole", "fisheye"])
def test_dispatch_matches_jax(make, cls):
    jcam = make()
    cam = _port(jcam, cls)
    pts = world_points(14, 10)
    pix = np.asarray(jc.project_points(jcam, jnp.asarray(pts)))
    _close(tc.project_points(cam, _t(pts)), pix)
    _close(tc.undistort_points(cam, _t(pix)),
           jc.undistort_points(jcam, jnp.asarray(pix)))
    assert project_fn(cam).__name__ == j_project_fn(jcam).__name__
    with pytest.raises(TypeError):
        undistort_fn(tuple(cam))


# ------------------------------------------------------------------- rig

def test_rig_pmat_and_cameras_match_jax():
    jrig = jax_test_rig(4, seed=7)
    rig = _port_rig(jrig)
    _close(rig.pmat(), jrig.pmat())
    _close(rig.omni("cpu", torch.float64).pmat, rig.pmat())
    for got, want in zip(rig.omni("cpu", torch.float64), jrig.omni()):
        _close(got, want, 0.0)
    for got, want in zip(rig.pinhole("cpu", torch.float64), jrig.pinhole()):
        _close(got, want, 0.0)
    assert rig.omni("cpu").K.dtype == torch.float32
    sub = rig.subset_by_names(["10003", "10001"])
    assert sub.camera_ids == ["10003", "10001"]
    _close(sub.pmat(), jrig.subset([3, 1]).pmat())


def test_rig_h5_round_trip_both_ways(tmp_path):
    pytest.importorskip("h5py")
    pytest.importorskip("yaml")
    jrig = jax_test_rig(4, seed=7)
    rig = _port_rig(jrig)
    # the port writes, both packages read back; and the other way round
    for writer, name in ((rig, "port"), (jrig, "jax")):
        cfg = writer.to_h5(str(tmp_path / name))
        for loaded in (TRig.from_h5(cfg), JRig.from_h5(cfg)):
            assert loaded.camera_ids == rig.camera_ids
            assert loaded.size == rig.size
            for f in ("K", "xi", "D", "rvec", "tvec", "mtx"):
                _close(getattr(loaded, f), getattr(rig, f), 0.0)


@pytest.mark.parametrize("model, halve", [("omnidir", False),
                                          ("omnidir", True),
                                          ("fisheye", False)])
def test_calibration_toml_bytes_equal_jax(tmp_path, model, halve):
    jrig = jax_test_rig(3, seed=2)
    jrig.model = model
    jrig.metadata = {"adjusted": True, "note": "x"}
    rig = _port_rig(jrig)
    rig.to_calibration_toml(str(tmp_path / "port.toml"), halve_mtx=halve)
    jrig.to_calibration_toml(str(tmp_path / "jax.toml"), halve_mtx=halve)
    got = (tmp_path / "port.toml").read_bytes()
    assert got == (tmp_path / "jax.toml").read_bytes()
    back, jback = (TRig.from_calibration_toml(str(tmp_path / "port.toml")),
                   JRig.from_calibration_toml(str(tmp_path / "jax.toml")))
    assert dataclasses.asdict(back).keys() == dataclasses.asdict(jback).keys()
    for f in dataclasses.fields(TRig):
        a, b = getattr(back, f.name), getattr(jback, f.name)
        if isinstance(a, np.ndarray):
            _close(a, b, 0.0)
        else:
            assert a == b, f.name
