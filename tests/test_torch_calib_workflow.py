"""The port's calibration drivers (``calib/workflow.py``) and the
``calibrate`` CLI against the JAX package's, on the files of
tests/test_calib_workflow.py's fixtures: written once, copied into one
directory for each package. JAX runs under x64 (tests/conftest.py), the
port in float64 on the CPU unless stated.

Held:
- ``optimize_extrinsics_driver``: equal h5 keys, shapes and dtypes; the
  JAX test's bound (camera positions within 3 mm of the truth after the
  scale alignment) on the port's file, and those positions within 0.01
  mm of the JAX package's (the raw values part by rounding amplified
  along the scale gauge; ROADMAP §3).
- ``optimize_all_camera_params_driver``: equal keys, shapes and dtypes of
  both files; the JAX test's bounds (positions within 60 mm, the
  self-consistency rms under 0.5 px) on the port's files, and that rms
  within 1e-4 relative of the JAX package's (measured 1.4e-5: both solves
  end on their iteration cap, not on ftol).
- ``fix_extrinsic_optim``: within 1e-9; ``_triangulate_trace``: within
  1e-9 of the largest coordinate.
- ``calibrate_intrinsics_driver`` on a ``chessboard_points.h5``: equal
  ``mtx``/``dist`` (cv2 on the same input, on one thread: its threaded
  reductions do not repeat bit for bit), ``K``/``xi``/``D`` within
  1e-9 of their largest value, the fit held at the short budget of
  tests/test_torch_calib.py (its default budget is held there and in
  tests/test_torch_calib_intrinsics.py).
- ``analyze_chessboard_videos``, ``get_extrinsics_from_cage_keypoints``,
  ``_trace_marker_video`` and ``extract_frames_for_3dannotation``: equal
  files and arrays.
- ``python -m macaque_tpu_torch calibrate --step optimize --device cpu``
  (float32): the JAX test's 3 mm bound.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
import h5py  # noqa: E402
import yaml  # noqa: E402

from macaque_tpu.calib import workflow as jwf  # noqa: E402
from macaque_tpu_torch.calib import workflow as twf  # noqa: E402
from tests import test_calib_workflow as tcw  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = {"device": "cpu", "dtype": torch.float64}
SHORT = (15, 2)      # tests/test_torch_calib.py's short budget


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _two_copies(tmp_path, src):
    """The fixture's directory copied for each package: (jax, port)."""
    out = []
    for name in ("jax", "port"):
        shutil.copytree(src, tmp_path / name)
        out.append(tmp_path / name)
    return out


@pytest.fixture
def marker_dirs(tmp_path):
    """tests/test_calib_workflow.py's ``marker_scene`` (3 omnidir cameras,
    a 120-frame marker trace with 0.2 px noise and dropped detections,
    cameras 1-2 perturbed), written once and copied for each package."""
    src = tmp_path / "scene"
    src.mkdir()
    K, xi, D, rvec, tvec = tcw._make_rig(3)
    cam_ids = ["201", "202", "203"]
    rng = np.random.default_rng(4)
    t = np.linspace(0, 4 * np.pi, 120)
    pts = np.stack([700 * np.cos(t), 700 * np.sin(t),
                    300 + 250 * np.sin(t * 0.7)], axis=1)
    trace = tcw._project_rig(K, xi, D, rvec, tvec, pts)
    trace = trace + rng.normal(0, 0.2, trace.shape)
    trace[0, 10:14] = -1
    trace[2, 50:53] = -1
    rvec_i, tvec_i = rvec.copy(), tvec.copy()
    rvec_i[1:] += rng.normal(0, 0.02, (2, 3))
    tvec_i[1:] += rng.normal(0, 30.0, (2, 3))
    with open(src / "config.yaml", "w") as f:
        yaml.safe_dump({"camera_id": [int(c) for c in cam_ids],
                        "img_size": [tcw.IMG_W, tcw.IMG_H]}, f)
    tcw._write_marker_problem(str(src), cam_ids, K, xi, D, rvec_i, tvec_i,
                              trace)
    truth = (K, xi, D, rvec, tvec)
    j, t = _two_copies(tmp_path, src)
    return (str(j / "config.yaml"), str(t / "config.yaml"), cam_ids, truth)


def _h5_tree(path):
    """{dataset name: (shape, dtype)} of an h5 file."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.__setitem__(k, (v.shape, v.dtype))
                     if isinstance(v, h5py.Dataset) else None)
    return out


def _h5_arrays(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.__setitem__(k, np.asarray(v))
                     if isinstance(v, h5py.Dataset) else None)
    return out


def test_optimize_extrinsics_driver_matches_jax(marker_dirs):
    cfg_j, cfg_t, cam_ids, (K, xi, D, rvec, tvec) = marker_dirs
    out_j = jwf.optimize_extrinsics_driver(cfg_j, verbose=False)
    out_t = twf.optimize_extrinsics_driver(cfg_t, verbose=False, **F64)
    assert _h5_tree(out_t) == _h5_tree(out_j)
    errs = tcw._campos_errors(out_t, cam_ids, K, xi, D, rvec, tvec,
                              scale_align=True)
    assert errs.max() < 3.0, errs
    errs_j = tcw._campos_errors(out_j, cam_ids, K, xi, D, rvec, tvec,
                                scale_align=True)
    np.testing.assert_allclose(errs, errs_j, rtol=0, atol=0.01)


def _self_consistency_rms(base, cam_ids, wf):
    """tests/test_calib_workflow.py's check: DLT-triangulate the trace
    with the written calibration and reproject; rms over observations."""
    C = len(cam_ids)
    K2, xi2, D2 = np.zeros((C, 3, 3)), np.zeros(C), np.zeros((C, 4))
    rv2, tv2 = np.zeros((C, 3)), np.zeros((C, 3))
    with h5py.File(os.path.join(base, "cam_intrinsic_optim.h5"), "r") as fi, \
            h5py.File(os.path.join(base, "cam_extrinsic_optim.h5"),
                      "r") as fe:
        for i, cid in enumerate(cam_ids):
            K2[i] = np.asarray(fi[f"/{cid}/K"])
            xi2[i] = np.asarray(fi[f"/{cid}/xi"]).ravel()[0]
            D2[i] = np.asarray(fi[f"/{cid}/D"]).ravel()[:4]
            rv2[i] = np.asarray(fe[f"/{cid}/rvec"]).ravel()
            tv2[i] = np.asarray(fe[f"/{cid}/tvec"]).ravel()
    obs, *_ = wf._load_marker_problem(base, cam_ids)
    kw = F64 if wf is twf else {}
    pts = wf._triangulate_trace(obs, K2, xi2, D2, rv2, tv2, **kw)
    seen = ~np.isnan(pts[:, 0])
    reproj = tcw._project_rig(K2, xi2, D2, rv2, tv2, pts[seen])
    return np.sqrt(np.nanmean((reproj - obs[:, seen]) ** 2))


def test_optimize_all_camera_params_driver_matches_jax(marker_dirs):
    cfg_j, cfg_t, cam_ids, (K, xi, D, rvec, tvec) = marker_dirs
    out_j = jwf.optimize_all_camera_params_driver(cfg_j, verbose=False)
    out_t = twf.optimize_all_camera_params_driver(cfg_t, verbose=False,
                                                  **F64)
    base_j, base_t = os.path.dirname(cfg_j), os.path.dirname(cfg_t)
    for name in ("cam_extrinsic_optim.h5", "cam_intrinsic_optim.h5"):
        assert _h5_tree(os.path.join(base_t, name)) == \
            _h5_tree(os.path.join(base_j, name)), name
    errs = tcw._campos_errors(out_t, cam_ids, K, xi, D, rvec, tvec,
                              scale_align=True)
    assert errs.max() < 60.0, errs
    rms_t = _self_consistency_rms(base_t, cam_ids, twf)
    rms_j = _self_consistency_rms(base_j, cam_ids, jwf)
    assert rms_t < 0.5, rms_t
    # both solves end on the 60-iteration cap, not on ftol: rounding
    # amplified along the free-intrinsics gauge parts them by 1.4e-5
    assert abs(rms_t - rms_j) <= 1e-4 * rms_j, (rms_t, rms_j)


def test_fix_extrinsic_optim_matches_jax(marker_dirs):
    from macaque_tpu.calib.graph_init import get_rtvec, make_M

    cfg_j, cfg_t, cam_ids, (K, xi, D, rvec, tvec) = marker_dirs
    drift = make_M(np.array([0.02, -0.01, 0.03]),
                   np.array([15.0, -8.0, 4.0]))
    for cfg in (cfg_j, cfg_t):
        with h5py.File(os.path.join(os.path.dirname(cfg),
                                    "cam_extrinsic_optim.h5"), "w") as f:
            for i, cid in enumerate(cam_ids):
                rv, tv = get_rtvec(make_M(rvec[i], tvec[i])
                                   @ np.linalg.inv(drift))
                f.create_dataset(f"/{cid}/rvec", data=rv.reshape(3, 1))
                f.create_dataset(f"/{cid}/tvec", data=tv.reshape(3, 1))
    out_j = jwf.fix_extrinsic_optim(cfg_j, ref=0, verbose=False)
    out_t = twf.fix_extrinsic_optim(cfg_t, ref=0, verbose=False)
    got, want = _h5_arrays(out_t), _h5_arrays(out_j)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9)
    errs = tcw._campos_errors(out_t, cam_ids, K, xi, D, rvec, tvec)
    assert errs.max() < 1e-6, errs


def test_triangulate_trace_matches_jax(marker_dirs):
    cfg_j, _, cam_ids, _ = marker_dirs
    base = os.path.dirname(cfg_j)
    obs, K, xi, D, rvec, tvec = jwf._load_marker_problem(base, cam_ids)
    obs_t, *rest = twf._load_marker_problem(base, cam_ids)
    np.testing.assert_array_equal(obs_t, obs)
    want = jwf._triangulate_trace(obs, K, xi, D, rvec, tvec)
    got = twf._triangulate_trace(obs, K, xi, D, rvec, tvec, **F64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    scale = np.nanmax(np.abs(want))
    assert np.nanmax(np.abs(got - want)) <= 1e-9 * scale


def test_calibrate_command_optimize_on_the_cpu(marker_dirs):
    """``python -m macaque_tpu_torch calibrate --step optimize --device
    cpu``: the port's default float32 on the CPU, held to the JAX test's
    bound."""
    _, cfg_t, cam_ids, (K, xi, D, rvec, tvec) = marker_dirs
    proc = subprocess.run(
        [sys.executable, "-m", "macaque_tpu_torch", "calibrate", cfg_t,
         "--step", "optimize", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "extrinsic BA:" in proc.stdout
    out = os.path.join(os.path.dirname(cfg_t), "cam_extrinsic_optim.h5")
    errs = tcw._campos_errors(out, cam_ids, K, xi, D, rvec, tvec,
                              scale_align=True)
    assert errs.max() < 3.0, errs


# ----------------------------------------------------- host drivers


def _short_fit(monkeypatch):
    """Both packages' intrinsic fit at the short budget, patched into
    their ``calib/bundle.py`` for the test (the drivers take no budget)."""
    import functools

    from macaque_tpu.calib import bundle as jb
    from macaque_tpu.geometry.lm import LMConfig as JLMConfig
    from macaque_tpu_torch.calib import bundle as tb
    from macaque_tpu_torch.geometry.lm import LMConfig

    lm, cg = SHORT
    for mod, cfg in ((jb, JLMConfig), (tb, LMConfig)):
        fn = mod.calibrate_intrinsics_omnidir
        monkeypatch.setattr(mod, "calibrate_intrinsics_omnidir",
                            functools.partial(fn, cfg=cfg(
                                lm_iters=lm, cg_iters=cg, ftol=1e-12)))


@pytest.fixture
def cv2_one_thread():
    """cv2.calibrateCamera's threaded reductions part two calls on the
    same input by ~1e-7; on one thread it repeats bit for bit."""
    n = cv2.getNumThreads()
    cv2.setNumThreads(1)
    yield
    cv2.setNumThreads(n)


def test_calibrate_intrinsics_driver_matches_jax(tmp_path, monkeypatch,
                                                 cv2_one_thread):
    """A ``chessboard_points.h5`` of 8 pinhole views of the 9x6 board
    (tests/test_calib_workflow.py's poses) for two cameras."""
    src = tmp_path / "scene"
    src.mkdir()
    cam_ids = [101, 102]
    board = twf.Checkerboard(9, 6, 23.0)
    obj = board.object_points()
    rng = np.random.default_rng(9)
    with h5py.File(src / "chessboard_points.h5", "w") as f:
        for seed, cid in enumerate(cam_ids):
            imp = []
            for rvec, tvec in tcw.board_poses(8, seed=seed):
                p, _ = cv2.projectPoints(obj.reshape(-1, 1, 3), rvec, tvec,
                                         tcw.K_GT, np.zeros(5))
                imp.append(p.reshape(-1, 1, 2)
                           + rng.normal(0, 0.05, (54, 1, 2)))
            f.create_dataset(f"/{cid}/imp", data=np.stack(imp))
            f.create_dataset(f"/{cid}/objp", data=np.tile(obj, (8, 1, 1)))
    with open(src / "config.yaml", "w") as f:
        yaml.safe_dump({"camera_id": cam_ids,
                        "img_size": [tcw.IMG_W, tcw.IMG_H]}, f)
    dj, dt = _two_copies(tmp_path, src)
    _short_fit(monkeypatch)
    out_j = jwf.calibrate_intrinsics_driver(str(dj / "config.yaml"),
                                            verbose=False)
    out_t = twf.calibrate_intrinsics_driver(str(dt / "config.yaml"),
                                            verbose=False, **F64)
    assert _h5_tree(out_t) == _h5_tree(out_j)
    got, want = _h5_arrays(out_t), _h5_arrays(out_j)
    for k in want:
        if k.endswith(("mtx", "dist")):
            np.testing.assert_array_equal(got[k], want[k])
        else:
            scale = np.abs(want[k]).max()
            assert np.abs(got[k] - want[k]).max() <= 1e-9 * scale, k


def test_analyze_chessboard_videos_matches_jax(tmp_path):
    src = tmp_path / "scene"
    (src / "chessboard").mkdir(parents=True)
    cam_ids = [101, 102]
    for seed, cid in enumerate(cam_ids):
        vw = cv2.VideoWriter(str(src / "chessboard" / f"{cid}.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 24,
                             (tcw.IMG_W, tcw.IMG_H))
        for rvec, tvec in tcw.board_poses(4, seed=seed):
            vw.write(cv2.cvtColor(tcw.render_board_view(rvec, tvec),
                                  cv2.COLOR_GRAY2BGR))
        vw.release()
    with open(src / "config.yaml", "w") as f:
        yaml.safe_dump({"camera_id": cam_ids,
                        "chessboard_vid_folder": "chessboard",
                        "chessboard_square_size": 23,
                        "img_size": [tcw.IMG_W, tcw.IMG_H]}, f)
    dj, dt = _two_copies(tmp_path, src)
    out_j = jwf.analyze_chessboard_videos(str(dj / "config.yaml"),
                                          frame_intv=1, verbose=False)
    out_t = twf.analyze_chessboard_videos(str(dt / "config.yaml"),
                                          frame_intv=1, verbose=False)
    got, want = _h5_arrays(out_t), _h5_arrays(out_j)
    assert set(got) == set(want) and got["101/imp"].shape[0] >= 3
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_get_extrinsics_from_cage_keypoints_matches_jax(tmp_path):
    rvec_gt = np.array([np.pi * 0.9, 0.1, -0.05])
    tvec_gt = np.array([30.0, -20.0, 2000.0])
    rng = np.random.default_rng(1)
    obj = rng.uniform(-500, 500, (12, 3))
    obj[:, 2] = rng.uniform(0, 800, 12)
    proj, _ = cv2.projectPoints(obj.reshape(-1, 1, 3), rvec_gt, tvec_gt,
                                tcw.K_GT, np.zeros(5))
    ann = np.column_stack([np.ones(12), proj.reshape(-1, 2) * 640.0
                           / tcw.IMG_W, obj])
    ann[3, 0] = 0
    outs = []
    for name, wf in (("jax", jwf), ("port", twf)):
        d = tmp_path / name
        d.mkdir()
        with open(d / "config.yaml", "w") as f:
            yaml.safe_dump({"camera_id": [401],
                            "img_size": [tcw.IMG_W, tcw.IMG_H]}, f)
        with h5py.File(d / "cam_intrinsic.h5", "w") as f:
            f.create_dataset("/401/mtx", data=tcw.K_GT)
            f.create_dataset("/401/dist", data=np.zeros((1, 5)))
        wf.save_cage_annotations(str(d / "config.yaml"), {"401": ann})
        outs.append(wf.get_extrinsics_from_cage_keypoints(
            str(d / "config.yaml"), verbose=False))
    want, got = (_h5_arrays(p) for p in outs)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["401/rvec"].ravel(), rvec_gt, atol=1e-4)


def test_trace_marker_video_matches_jax():
    marker_len = 175.0
    rng = np.random.default_rng(2)
    frames = []
    for _ in range(4):
        rvec = np.array([np.pi, 0, 0]) + rng.uniform(-0.2, 0.2, 3)
        tvec = np.array([rng.uniform(-150, 150), rng.uniform(-100, 100),
                         rng.uniform(900, 1400)])
        frames.append(tcw._render_marker_view(rvec, tvec, marker_len))
    frames.append(np.full((tcw.IMG_H, tcw.IMG_W, 3), 255, np.uint8))
    for kw in ({}, {"center_offset": [[0.0, 0.0, -40.0]], "gate_px": 60.0}):
        got = twf._trace_marker_video(frames, tcw.K_GT, np.zeros(5),
                                      marker_len, **kw)
        want = jwf._trace_marker_video(frames, tcw.K_GT, np.zeros(5),
                                       marker_len, **kw)
        np.testing.assert_array_equal(got, want)
    assert (got[-1] == -1).all() and (got[:4] >= 0).all()


def test_extract_frames_for_3dannotation_matches_jax(tmp_path):
    from macaque_tpu.video.imgstore import write_imgstore

    cam_ids = [301, 302]
    rng = np.random.default_rng(0)
    for cid in cam_ids:
        write_imgstore(str(tmp_path / f"session.{cid}"),
                       rng.integers(0, 255, (30, 48, 64, 3), dtype=np.uint8),
                       fps=24.0)
    outs = []
    for name, wf in (("jax", jwf), ("port", twf)):
        base = tmp_path / name
        base.mkdir()
        with open(base / "config.yaml", "w") as f:
            yaml.safe_dump({"camera_id": cam_ids, "img_size": [64, 48]}, f)
        for fname in ("cam_intrinsic.h5", "cam_extrinsic_optim.h5"):
            with h5py.File(base / fname, "w") as f:
                for cid in cam_ids:
                    f.create_dataset(f"/{cid}/x", data=np.zeros(1))
        outs.append(wf.extract_frames_for_3dannotation(
            str(base / "config.yaml"), str(tmp_path / "session"),
            str(tmp_path / f"anno_{name}"), n_frame_extract=4, n_animal=2,
            n_kp=17))
    want, got = outs
    files = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == files
    assert len([p for p in files if p.endswith(".json")]) >= 4
    for p in files:
        if p.endswith(".jpg"):
            np.testing.assert_array_equal(
                cv2.imread(os.path.join(got, p)),
                cv2.imread(os.path.join(want, p)))
        elif p.endswith((".json", ".yaml")):
            with open(os.path.join(got, p)) as a, \
                    open(os.path.join(want, p)) as b:
                assert a.read() == b.read(), p
    assert sorted(os.listdir(os.path.join(got, "calib"))) == \
        sorted(os.listdir(os.path.join(want, "calib")))
    with open(os.path.join(got, sorted(
            p for p in files if p.endswith(".json"))[0])) as f:
        assert np.asarray(json.load(f)["keypoints_2d"]).shape == (2, 2, 17, 2)
