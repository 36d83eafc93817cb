"""The ArUco drivers of the calibration (``calib/workflow.py``) in both
packages, on marker and cube videos rendered through a known rig: three
pinhole cameras (tests/test_calib_workflow.py's circle rig, with
``xi = 0`` and no distortion, so the omnidir model is exactly the pinhole
the renderer draws) watching a marker, or a cube's face marker, move
along a 3D path; every frame turns the marker toward its camera.

Held, with the worst difference measured here (in brackets):
- ``marker_pose_pnp`` on detected corners: equal in both packages (cv2 on
  the same input); the marker's center within 1 px of the truth [0.25]
  and its depth within 5 % [0.3 %];
- ``analyze_aruco_marker_videos`` (mp4 videos): equal ``marker_trace.h5``
  files, at least 90 % of the frames traced [all], each point within 2 px
  of the true projection of the marker's center [0.65];
- ``analyze_aruco_cube_videos`` (FFV1 imgstores): ``marker_trace.h5``
  files equal but for the rounding of each package's float64 Rodrigues
  formula, within 1e-9 px [5.7e-14]; at least 90 % of the grid frames
  traced [57 of 60], each point within 4 px of the true projection of the
  cube's center, which lies half a cube behind the face and takes the
  face pose's rotation error [1.98];
- ``calibrate_from_videos`` (cube mode, extrinsic bundle adjustment) from
  the intrinsic stage's files (the truth: the omnidir fit at the short
  budget of tests/test_torch_calib.py does not converge on a pinhole rig,
  xi about 1.0, and its default budget takes minutes), labeled cage
  points and the cube videos: ``cam_extrinsic.h5`` (the cage PnP) and
  ``marker_trace.h5`` within 1e-9 of the largest value; the port's camera
  positions within 10 mm of the truth after the scale alignment [3.0]
  and within 0.01 mm of the JAX package's [4.0e-7]; its self-consistency
  rms (the trace triangulated with the written calibration and
  reprojected) under 1 px [0.311], within 1e-4 of the JAX package's
  relative to it [3.8e-11].
The JAX package runs under x64 (tests/conftest.py), the port in float64
on the CPU.
"""

import os
import shutil

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
import h5py  # noqa: E402
import yaml  # noqa: E402

from macaque_tpu.calib import workflow as jwf  # noqa: E402
from macaque_tpu.video.imgstore import write_imgstore  # noqa: E402
from macaque_tpu_torch.calib import workflow as twf  # noqa: E402
from tests import test_calib_workflow as tcw  # noqa: E402
from tests import test_torch_calib_workflow as tcal  # noqa: E402

CAM_IDS = [501, 502, 503]
MARKER, CUBE = 250.0, 300.0          # mm: marker side, cube side
N_FRAME, FPS = 80, 2.0               # the cube analyzer skips 5 s at each end
F64 = {"device": "cpu", "dtype": torch.float64}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n, m = torch.get_num_threads(), cv2.getNumThreads()
    torch.set_num_threads(1)
    cv2.setNumThreads(1)
    yield
    torch.set_num_threads(n)
    cv2.setNumThreads(m)


@pytest.fixture(scope="module")
def rig():
    """(K, xi, D, rvec, tvec) of three pinhole cameras, and the path of the
    marker's center in world mm (N_FRAME, 3)."""
    K, _, _, rvec, tvec = tcw._make_rig(len(CAM_IDS))
    xi, D = np.zeros(len(CAM_IDS)), np.zeros((len(CAM_IDS), 4))
    t = np.linspace(0, 2 * np.pi, N_FRAME, endpoint=False)
    path = np.stack([700 * np.cos(t), 500 * np.sin(2 * t),
                     300 + 250 * np.sin(3 * t)], axis=1)
    return (K, xi, D, rvec, tvec), path


def _camera_points(rig, i, pts):
    (_, _, _, rvec, tvec), _ = rig
    R = cv2.Rodrigues(rvec[i])[0]
    return pts @ R.T + tvec[i]


def _render(rig, i, offset):
    """Camera ``i``'s frames of a marker facing it, whose pose puts
    ``offset`` (marker coordinates, mm) on the path; and the true pixels of
    the path. The marker turns 20-34 degrees away about each axis: nearer
    face-on, a marker this small (about 60 px) has two planar poses of
    near-equal error (IPPE's ambiguity), and the wrong one moves the cube's
    center, half a cube behind its face, by up to 9 px."""
    rng = np.random.default_rng(10 + i)
    pc = _camera_points(rig, i, rig[1])
    frames = []
    for p in pc:
        tilt = rng.uniform(0.35, 0.6, 3) * rng.choice([-1, 1], 3)
        rv = np.array([np.pi, 0, 0]) + tilt
        R = cv2.Rodrigues(rv)[0]
        frames.append(tcw._render_marker_view(rv, p - R @ offset, MARKER))
    uv = pc @ tcw.K_GT.T
    return np.stack(frames), uv[:, :2] / uv[:, 2:]


def _write_common(base, cube):
    os.makedirs(base, exist_ok=True)
    cfg = {"camera_id": CAM_IDS, "img_size": [tcw.IMG_W, tcw.IMG_H],
           "marker_size": MARKER, "marker_vid_folder": "marker"}
    if cube:
        cfg["cube_size"] = CUBE
    with open(os.path.join(base, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    return os.path.join(base, "config.yaml")


def _write_pinhole(base):
    with h5py.File(os.path.join(base, "cam_intrinsic.h5"), "w") as f:
        for cid in CAM_IDS:
            f.create_dataset(f"/{cid}/mtx", data=tcw.K_GT)
            f.create_dataset(f"/{cid}/dist", data=np.zeros((1, 5)))


@pytest.fixture(scope="module")
def marker_videos(rig, tmp_path_factory):
    """A directory of flat-marker mp4 videos, one a camera, and the true
    pixels of the marker's center."""
    src = tmp_path_factory.mktemp("aruco_marker")
    os.makedirs(src / "marker")
    truth = []
    for i, cid in enumerate(CAM_IDS):
        frames, uv = _render(rig, i, np.zeros(3))
        vw = cv2.VideoWriter(str(src / "marker" / f"{cid}.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 24,
                             (tcw.IMG_W, tcw.IMG_H))
        for fr in frames:
            vw.write(fr)
        vw.release()
        truth.append(uv)
    return src, np.stack(truth)


@pytest.fixture(scope="module")
def cube_videos(rig, tmp_path_factory):
    """A directory of cube imgstores (FFV1, FPS frames a second), the face
    marker toward each camera, and the true pixels of the cube's center."""
    src = tmp_path_factory.mktemp("aruco_cube")
    truth = []
    for i, cid in enumerate(CAM_IDS):
        frames, uv = _render(rig, i, np.array([0.0, 0.0, -CUBE / 2]))
        write_imgstore(str(src / "marker" / f"cube.{cid}"), frames, fps=FPS,
                       fourcc="FFV1")
        truth.append(uv)
    return src, np.stack(truth)


def test_marker_pose_pnp_matches_jax(rig):
    frames, _ = _render(rig, 0, np.zeros(3))
    det = twf._aruco_detector()
    corners, ids, _ = det.detectMarkers(cv2.cvtColor(frames[3],
                                                     cv2.COLOR_BGR2GRAY))
    assert ids is not None and len(ids) == 1
    corner = np.asarray(corners[0]).reshape(4, 2)
    got = twf.marker_pose_pnp(corner, MARKER, tcw.K_GT, np.zeros(5))
    want = jwf.marker_pose_pnp(corner, MARKER, tcw.K_GT, np.zeros(5))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    true = _camera_points(rig, 0, rig[1][3:4])[0]
    uv = tcw.K_GT @ (got[1] / got[1][2]) - tcw.K_GT @ (true / true[2])
    print(f"marker pose: center {np.abs(uv).max():.3f} px and depth "
          f"{abs(got[1][2] / true[2] - 1):.4f} relative off the truth")
    assert np.abs(uv).max() < 1.0 and abs(got[1][2] / true[2] - 1) < 0.05


def _traces(path):
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f}


def _two_dirs(tmp_path, src, cube):
    out = []
    for name in ("jax", "port"):
        shutil.copytree(src, tmp_path / name)
        _write_common(str(tmp_path / name), cube)
        _write_pinhole(str(tmp_path / name))
        out.append(str(tmp_path / name / "config.yaml"))
    return out


def _assert_traces(got, want, truth, bound):
    assert sorted(got) == sorted(want) == sorted(str(c) for c in CAM_IDS)
    for i, cid in enumerate(CAM_IDS):
        g, w = got[str(cid)], want[str(cid)]
        # the cube's offset turns through each package's own float64
        # Rodrigues formula: they round apart by an ulp [5.7e-14 px]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)
        assert g.shape == truth[i].shape
        seen = (g >= 0).all(-1)
        err = np.abs(g - truth[i])[seen].max()
        print(f"camera {cid}: {seen.sum()} of {len(seen)} frames traced, "
              f"{err:.3f} px off the truth")
        assert seen.mean() >= 0.9 and err < bound, (seen.sum(), err)


def test_analyze_aruco_marker_videos_matches_jax(marker_videos, tmp_path):
    src, truth = marker_videos
    cfg_j, cfg_t = _two_dirs(tmp_path, src, cube=False)
    want = _traces(jwf.analyze_aruco_marker_videos(cfg_j, verbose=False))
    got = _traces(twf.analyze_aruco_marker_videos(cfg_t, verbose=False))
    _assert_traces(got, want, truth, 2.0)


def test_analyze_aruco_cube_videos_matches_jax(cube_videos, tmp_path):
    src, truth = cube_videos
    cfg_j, cfg_t = _two_dirs(tmp_path, src, cube=True)
    kw = dict(frame_intv=1, fps=FPS, verbose=False)
    want = _traces(jwf.analyze_aruco_cube_videos(cfg_j, **kw))
    got = _traces(twf.analyze_aruco_cube_videos(cfg_t, **kw))
    # the grid skips 5 s at each end of the FPS-frame stores
    skip = int(FPS * 5)
    _assert_traces(got, want, truth[:, skip:N_FRAME - skip], 4.0)


def _board_points(base):
    """tests/test_torch_calib_workflow.py's ``chessboard_points.h5``: 8
    pinhole views of the 9x6 board a camera, 0.05 px noise."""
    board = twf.Checkerboard(9, 6, 23.0)
    obj = board.object_points()
    rng = np.random.default_rng(9)
    with h5py.File(os.path.join(base, "chessboard_points.h5"), "w") as f:
        for seed, cid in enumerate(CAM_IDS):
            imp = []
            for rvec, tvec in tcw.board_poses(8, seed=seed):
                p, _ = cv2.projectPoints(obj.reshape(-1, 1, 3), rvec, tvec,
                                         tcw.K_GT, np.zeros(5))
                imp.append(p.reshape(-1, 1, 2)
                           + rng.normal(0, 0.05, (54, 1, 2)))
            f.create_dataset(f"/{cid}/imp", data=np.stack(imp))
            f.create_dataset(f"/{cid}/objp", data=np.tile(obj, (8, 1, 1)))


def _cage_annotations(rig):
    """12 labeled cage points a camera (0.3 px noise), 640-wide pixels."""
    rng = np.random.default_rng(1)
    obj = np.column_stack([rng.uniform(-800, 800, (12, 2)),
                           rng.uniform(0, 900, 12)])
    out = {}
    for i, cid in enumerate(CAM_IDS):
        pc = _camera_points(rig, i, obj)
        uv = pc @ tcw.K_GT.T
        uv = uv[:, :2] / uv[:, 2:] + rng.normal(0, 0.3, (12, 2))
        out[str(cid)] = np.column_stack([np.ones(12), uv * 640.0 / tcw.IMG_W,
                                         obj])
    return out


def _write_intrinsics(base, rig):
    """``cam_intrinsic.h5`` as the intrinsic stage writes it: cv2's pinhole
    ``mtx``/``dist`` and the omnidir ``K``/``xi``/``D``, here the truth."""
    (K, xi, D, _, _), _ = rig
    with h5py.File(os.path.join(base, "cam_intrinsic.h5"), "w") as f:
        for i, cid in enumerate(CAM_IDS):
            f.create_dataset(f"/{cid}/mtx", data=tcw.K_GT)
            f.create_dataset(f"/{cid}/dist", data=np.zeros((1, 5)))
            f.create_dataset(f"/{cid}/K", data=K[i])
            f.create_dataset(f"/{cid}/xi", data=np.array([[xi[i]]]))
            f.create_dataset(f"/{cid}/D", data=D[i].reshape(1, 4))


def test_calibrate_from_videos_matches_jax(rig, cube_videos, tmp_path):
    (K, xi, D, rvec, tvec), _ = rig
    src, _ = cube_videos
    bases = []
    for name, wf in (("jax", jwf), ("port", twf)):
        shutil.copytree(src, tmp_path / name)
        cfg = _write_common(str(tmp_path / name), cube=True)
        # the intrinsic stage's files: calibrate_from_videos skips a stage
        # whose file is there
        _board_points(str(tmp_path / name))
        _write_intrinsics(str(tmp_path / name), rig)
        wf.save_cage_annotations(cfg, _cage_annotations(rig))
        bases.append(str(tmp_path / name))
    kw = dict(marker_mode="cube", full_ba=False, frame_intv=1, fps=FPS,
              verbose=False)
    jwf.calibrate_from_videos(os.path.join(bases[0], "config.yaml"), **kw)
    twf.calibrate_from_videos(os.path.join(bases[1], "config.yaml"), **kw,
                              **F64)
    for name in ("cam_intrinsic.h5", "marker_trace.h5", "cam_extrinsic.h5"):
        want = tcal._h5_arrays(os.path.join(bases[0], name))
        got = tcal._h5_arrays(os.path.join(bases[1], name))
        assert sorted(got) == sorted(want), name
        for k in want:
            scale = max(np.abs(want[k]).max(), 1.0)
            assert np.abs(got[k] - want[k]).max() <= 1e-9 * scale, (name, k)
    out = [os.path.join(b, "cam_extrinsic_optim.h5") for b in bases]
    errs = [tcw._campos_errors(o, CAM_IDS, K, xi, D, rvec, tvec,
                               scale_align=True) for o in out]
    print(f"camera positions against the truth: port {errs[1]}, JAX "
          f"{errs[0]} mm")
    assert errs[1].max() < 10.0, errs[1]
    np.testing.assert_allclose(errs[1], errs[0], rtol=0, atol=0.01)
    rms = [_self_consistency_rms(b, wf) for b, wf in zip(bases, (jwf, twf))]
    print(f"self-consistency rms: port {rms[1]:.4f}, JAX {rms[0]:.4f} px, "
          f"relative difference {abs(rms[1] - rms[0]) / rms[0]:.2e}")
    assert rms[1] < 1.0 and abs(rms[1] - rms[0]) <= 1e-4 * rms[0]


def _self_consistency_rms(base, wf):
    """tests/test_torch_calib_workflow.py's check, with the intrinsics the
    extrinsic adjustment kept (``cam_intrinsic.h5``)."""
    C = len(CAM_IDS)
    K2, xi2, D2 = np.zeros((C, 3, 3)), np.zeros(C), np.zeros((C, 4))
    rv2, tv2 = np.zeros((C, 3)), np.zeros((C, 3))
    with h5py.File(os.path.join(base, "cam_intrinsic.h5"), "r") as fi, \
            h5py.File(os.path.join(base, "cam_extrinsic_optim.h5"),
                      "r") as fe:
        for i, cid in enumerate(CAM_IDS):
            K2[i] = np.asarray(fi[f"/{cid}/K"])
            xi2[i] = np.asarray(fi[f"/{cid}/xi"]).ravel()[0]
            D2[i] = np.asarray(fi[f"/{cid}/D"]).ravel()[:4]
            rv2[i] = np.asarray(fe[f"/{cid}/rvec"]).ravel()
            tv2[i] = np.asarray(fe[f"/{cid}/tvec"]).ravel()
    ids = [str(c) for c in CAM_IDS]
    obs, *_ = wf._load_marker_problem(base, ids)
    kw = F64 if wf is twf else {}
    pts = wf._triangulate_trace(obs, K2, xi2, D2, rv2, tv2, **kw)
    seen = ~np.isnan(pts[:, 0])
    reproj = tcw._project_rig(K2, xi2, D2, rv2, tv2, pts[seen])
    return np.sqrt(np.nanmean((reproj - obs[:, seen]) ** 2))
