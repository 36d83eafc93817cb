"""The port's anipose session drivers (``macaque_tpu_torch/tools/
session.py``) against the JAX package's, on tests/test_session.py's
miniature project (3 cameras, 3 bodyparts, the 12-frame walk) written
twice from the same seeds, one tree per package, so each writes its own
outputs. JAX runs under x64 (tests/conftest.py); the port on the CPU in
float64.

Held, with each tolerance's measured value in brackets (the largest
relative difference of any comparison held to 1e-9 here was 1.5e-13):
- host-only outputs equal: the CSV columns ``fnum``, ``M_*`` and
  ``center_*`` without axes, ``ncams`` and scores, the summaries, the
  session angles and the 3D filter (the latter three on the same input
  CSV in both trees) within 1e-12 [0], the labeled videos' frames equal;
- triangulation without ``optim`` (DLT, and RANSAC with equal picks):
  points and errors within 1e-9 of the largest value [1e-13];
- ``ransac`` + ``optim`` with the axes correction, at the facade's budget:
  by accuracy, the median 3D error within 1 mm of the JAX package's
  (CGLS amplifies rounding, ROADMAP §3; tests/test_torch_aniposelib.py's
  tolerance) [7.160 against 7.166 mm];
- ``filter-2d``: ``medfilt`` within 1e-9 [0], ``viterbi`` with equal picks
  and scores within 1e-12 [6e-17], the autoencoder after
  ``train_autoencoder_project`` (float64) with weights and the chain's
  output within 1e-9 [6e-16] (as tests/test_torch_autoencoder.py);
- ``project-2d`` within 1e-9 of the largest value [1e-14];
- ``tracking-errors``' CSV by the triangulation's tolerance [1.5e-13];
- ``calibrate-session`` from a written ``detections.pickle`` with the
  bundle at 15 LM iterations of 2 CG sweeps (the tests' short budget):
  ``rms`` and focal lengths within 1e-4 relative [2e-13, 1e-15], and
  skip-if-done; from rendered board videos at the default budget (slow, as
  its JAX counterpart tests/test_calib_workflow.py:709): equal
  ``detections.pickle`` rows, ``rms`` and focal lengths within 1e-4
  relative, skip-if-done;
- the CLI's ``triangulate-session --device cpu`` (float32) and
  ``summarize`` against the JAX CLI's;
- a session driver given no device on a machine without a card raises.
"""

import functools
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
pd = pytest.importorskip("pandas")
import jax.numpy as jnp  # noqa: E402

from macaque_tpu.cameras import omnidir_project  # noqa: E402
from macaque_tpu.tools import session as jses  # noqa: E402
from macaque_tpu_torch.tools import session as tses  # noqa: E402
from tests.test_session import BODYPARTS, _make_camera_rig, _walk  # noqa: E402

ON = {"device": "cpu", "dtype": torch.float64}
REL = 1e-9
SHORT = (15, 2)      # tests/test_torch_calib.py's short budget


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CONFIG = """
project = "testproj"
path = "{root}"
nesting = 1
video_extension = "avi"

[triangulation]
cam_regex = "cam([0-9]+)"
optim = false
ransac = false
score_threshold = 0.5

[labeling]
scheme = [["head", "tail", "foot"]]

[angles]
bend = ["head", "tail", "foot"]
"""


def _write_project(root, rig, p2d):
    """tests/test_session.py's project tree under ``root``."""
    sess = root / "session1"
    (sess / "calibration").mkdir(parents=True)
    (sess / "pose-2d").mkdir()
    (sess / "videos-raw").mkdir()
    rig.to_calibration_toml(str(sess / "calibration" / "calibration.toml"))
    _, F, J, _ = p2d.shape
    rng = np.random.default_rng(5)
    scores = rng.uniform(0.85, 1.0, (3, F, J))
    scores[0, 2, 1] = 0.1  # below threshold -> dropped
    for c in range(3):
        jses.write_pose2d(p2d[c], scores[c], BODYPARTS,
                          str(sess / "pose-2d" / f"vid1-cam{c}.h5"))
        vw = cv2.VideoWriter(
            str(sess / "videos-raw" / f"vid1-cam{c}.avi"),
            cv2.VideoWriter_fourcc(*"MJPG"), 24, (64, 48))
        for _ in range(F):
            vw.write(np.zeros((48, 64, 3), np.uint8))
        vw.release()
    with open(root / "config.toml", "w") as f:
        f.write(CONFIG.format(root=root))
    return str(sess)


@pytest.fixture
def projects(tmp_path):
    """The project twice: {"jax": (config, session), "port": (config,
    session), "rig", "p3d", "p2d"}, each config loaded by its package."""
    rig = _make_camera_rig(3)
    p3d = _walk()
    F, J, _ = p3d.shape
    p2d = np.array(omnidir_project(
        rig.omni(), jnp.asarray(p3d.reshape(-1, 3)))).reshape(3, F, J, 2)
    out = {"rig": rig, "p3d": p3d, "p2d": p2d}
    for name, mod in (("jax", jses), ("port", tses)):
        root = tmp_path / name
        root.mkdir()
        sess = _write_project(root, rig, p2d)
        out[name] = (mod.load_session_config(str(root / "config.toml")), sess)
    return out


def _files(out):
    return [f for v in out.values() for f in v]


def _rel_close(got, want, rel=REL):
    """Within ``rel`` of the largest |value| (NaNs in the same places)."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    scale = max(np.nanmax(np.abs(want)) if np.isfinite(want).any() else 0,
                1.0)
    if np.isfinite(want).any():
        assert np.nanmax(np.abs(got - want)) <= rel * scale


def _exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


HOST_COLUMNS = ("fnum", "M_", "center_", "_ncams", "_score")


def _csv_match(got, want, rel=REL, host_exact=True, skip=()):
    """Two pose-3d CSVs: the same columns; the host-only ones equal, the
    rest within ``rel`` of their largest value."""
    g, w = pd.read_csv(got), pd.read_csv(want)
    assert list(g.columns) == list(w.columns) and len(g) == len(w) > 0
    for col in w.columns:
        if col in skip:
            continue
        if not pd.api.types.is_numeric_dtype(w[col]):
            assert list(g[col]) == list(w[col]), col
        elif host_exact and any(k in col for k in HOST_COLUMNS):
            _exact(g[col], w[col])
        else:
            _rel_close(g[col], w[col], rel)
    return g, w


def _both(projects, fn_name, *args, port_kw=ON, **kw):
    """Run ``fn_name`` of each package on its own tree's config."""
    (jc, _), (tc, _) = projects["jax"], projects["port"]
    want = getattr(jses, fn_name)(jc, *args, **kw)
    got = getattr(tses, fn_name)(tc, *args, **kw, **port_kw)
    return got, want


def _twin(path, projects):
    """The port tree's path of a JAX tree's file."""
    j, t = (os.path.dirname(projects[k][1]) for k in ("jax", "port"))
    return t + path[len(j):]


def _copy_outputs(projects, sub):
    """Put the JAX tree's ``session1/<sub>`` into the port's tree, so a
    host driver runs on the same input in both."""
    src = os.path.join(projects["jax"][1], sub)
    dst = os.path.join(projects["port"][1], sub)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)


# ---------------------------------------------------------- config, naming


def test_config_and_naming_match_jax(projects):
    (jc, js), (tc, ts) = projects["jax"], projects["port"]
    for k in jc:
        if k != "path":
            assert tc[k] == jc[k], k
    assert tses.DEFAULT_SESSION_CONFIG == jses.DEFAULT_SESSION_CONFIG
    for f in ("vid1-cam2.h5", "a/b/rec 3-cam10.avi", "nocam.h5"):
        assert tses.get_cam_name(tc, f) == jses.get_cam_name(jc, f)
        assert tses.get_video_name(tc, f) == jses.get_video_name(jc, f)
        assert tses.true_basename(f) == jses.true_basename(f)
    assert tses.natural_keys("c10x2") == jses.natural_keys("c10x2")
    assert tses.find_calibration_folder(tc, ts) == ts
    assert tses.process_all(tc, lambda c, s: s) == {("session1",): ts}
    missing = tses.load_session_config(os.path.join(ts, "missing.toml"))
    assert missing["pipeline"] == jses.DEFAULT_SESSION_CONFIG["pipeline"]


def test_pose2d_io_matches_jax(projects, tmp_path):
    (_, js), (_, ts) = projects["jax"], projects["port"]
    a = tses.read_pose2d(os.path.join(ts, "pose-2d", "vid1-cam0.h5"))
    b = jses.read_pose2d(os.path.join(js, "pose-2d", "vid1-cam0.h5"))
    assert a["bodyparts"] == b["bodyparts"] == BODYPARTS
    _exact(a["points"], b["points"])
    _exact(a["scores"], b["scores"])
    rng = np.random.default_rng(2)
    pts, sc = rng.normal(0, 50, (5, 3, 2)), rng.uniform(0, 1, (5, 3))
    tses.write_pose2d(pts, sc, BODYPARTS, str(tmp_path / "t.h5"),
                      extra={"interpolated": sc > 0.5})
    back = jses.read_pose2d(str(tmp_path / "t.h5"))
    _exact(back["points"], pts)
    _exact(back["interpolated"], sc > 0.5)


# ---------------------------------------------------------- triangulation


def test_triangulate_matches_jax(projects):
    got, want = _both(projects, "triangulate_all")
    (g,), (w,) = _files(got), _files(want)
    assert g == _twin(w, projects)
    d, _ = _csv_match(g, w)
    p3d = projects["p3d"]
    pts = np.stack([np.asarray(d.loc[:, (f"{bp}_x", f"{bp}_y", f"{bp}_z")])
                    for bp in BODYPARTS], axis=1)
    np.testing.assert_allclose(pts, p3d, atol=0.5)
    assert d["tail_ncams"][2] == 2
    # resumable: a second run skips
    assert not _files(tses.triangulate_all(projects["port"][0], **ON))


def test_triangulate_ransac_matches_jax(projects):
    for name in ("jax", "port"):
        projects[name][0]["triangulation"]["ransac"] = True
    got, want = _both(projects, "triangulate_all")
    (g,), (w,) = _files(got), _files(want)
    d, _ = _csv_match(g, w)
    assert (d["head_ncams"] >= 2).all()


def _world(d):
    """The CSV's points back in the world frame (F, J, 3)."""
    M = np.array([[d[f"M_{i}{j}"][0] for j in range(3)] for i in range(3)])
    center = np.array([d[f"center_{i}"][0] for i in range(3)])
    pts = np.stack([np.asarray(d.loc[:, (f"{bp}_x", f"{bp}_y", f"{bp}_z")])
                    for bp in BODYPARTS], axis=1)
    return (pts + center) @ np.linalg.inv(M.T), M


def test_triangulate_ransac_optim_axes_by_accuracy(projects):
    for name in ("jax", "port"):
        tri = projects[name][0]["triangulation"]
        tri.update(ransac=True, optim=True, constraints=[["head", "tail"]],
                   reference_point="tail",
                   axes=[["x", "tail", "foot"], ["z", "tail", "head"]])
    got, want = _both(projects, "triangulate_all")
    (g,), (w,) = _files(got), _files(want)
    coords = [c for c in pd.read_csv(w).columns
              if c[-2:] in ("_x", "_y", "_z") or c[-6:] == "_error"
              or c.startswith(("M_", "center_"))]
    d, dj = _csv_match(g, w, skip=coords)
    errs = []
    for frame in (d, dj):
        world, M = _world(frame)
        np.testing.assert_allclose(M @ M.T, np.eye(3), atol=1e-6)
        errs.append(np.nanmedian(np.linalg.norm(world - projects["p3d"],
                                                axis=-1)))
    # the smoothness prior pulls the 8 mm steps of the walk ~7 mm off it
    assert abs(errs[0] - errs[1]) <= 1.0 and errs[0] < 10.0, errs
    tail = np.asarray(d.loc[:, ("tail_x", "tail_y", "tail_z")])
    assert np.abs(np.median(tail, axis=0)).max() < 1.0


# ---------------------------------------------------------- 2D filters


def test_filter_2d_medfilt_matches_jax(projects):
    for name in ("jax", "port"):
        projects[name][0]["filter"].update(
            type="medfilt", medfilt=5, offset_threshold=100.0,
            score_threshold=0.05)
    got, want = _both(projects, "filter_pose_2d_all")
    assert len(_files(got)) == len(_files(want)) == 3
    for g, w in zip(_files(got), _files(want)):
        a, b = tses.read_pose2d(g), jses.read_pose2d(w)
        _rel_close(a["points"], b["points"])
        _rel_close(a["scores"], b["scores"])
    # triangulation consumes the filtered files when filter.enabled
    for name in ("jax", "port"):
        projects[name][0]["filter"]["enabled"] = True
    got, want = _both(projects, "triangulate_all")
    _csv_match(_files(got)[0], _files(want)[0])
    assert not _files(tses.filter_pose_2d_all(projects["port"][0], **ON))


def _jumpy(projects):
    """Outliers and low scores in camera 0's detections, in both trees."""
    for name in ("jax", "port"):
        rng = np.random.default_rng(11)
        path = os.path.join(projects[name][1], "pose-2d", "vid1-cam0.h5")
        d = jses.read_pose2d(path)
        pts, sc = d["points"].copy(), d["scores"].copy()
        pts[3, 0] += 200.0
        pts[8, 2] -= 150.0
        sc[rng.uniform(size=sc.shape) < 0.2] = 0.1
        jses.write_pose2d(pts, sc, BODYPARTS, path)


def test_filter_2d_viterbi_equal_picks(projects):
    _jumpy(projects)
    for name in ("jax", "port"):
        projects[name][0]["filter"].update(type="viterbi", n_back=3,
                                           offset_threshold=60.0,
                                           score_threshold=0.3)
    got, want = _both(projects, "filter_pose_2d_all")
    assert len(_files(got)) == 3
    for g, w in zip(_files(got), _files(want)):
        a, b = tses.read_pose2d(g), jses.read_pose2d(w)
        _exact(a["points"], b["points"])
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=0,
                                   atol=1e-12)
    # camera 0 (the first file) has frames where "missing" was picked
    assert (tses.read_pose2d(_files(got)[0])["scores"] < 0.01).any()


def test_filter_2d_autoencoder_chain_matches_jax(projects):
    _jumpy(projects)
    paths = [jses.train_autoencoder_project(projects["jax"][0], epochs=50),
             tses.train_autoencoder_project(projects["port"][0], epochs=50,
                                            **ON)]
    assert paths[1] == _twin(paths[0], projects)
    with np.load(paths[0]) as w, np.load(paths[1]) as g:
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-9)
    for name in ("jax", "port"):
        projects[name][0]["filter"].update(type=["viterbi", "autoencoder"],
                                           n_back=3, offset_threshold=60.0,
                                           score_threshold=0.3)
    got, want = _both(projects, "filter_pose_2d_all")
    assert len(_files(got)) == 3
    for g, w in zip(_files(got), _files(want)):
        a, b = tses.read_pose2d(g), jses.read_pose2d(w)
        _exact(a["points"], b["points"])
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=0,
                                   atol=1e-9)
        assert (a["scores"] <= 1.0 + 1e-6).all()


def test_filter_pose_2d_arrays_is_the_file_driver(projects, tmp_path):
    """The array core gives what the file driver writes."""
    config, sess = projects["port"]
    config["filter"].update(type=["medfilt", "viterbi"], medfilt=5,
                            n_back=3)
    src = os.path.join(sess, "pose-2d", "vid1-cam1.h5")
    out = tses.filter_pose_2d_file(config, src, str(tmp_path / "f.h5"), **ON)
    d = tses.read_pose2d(src)
    pts, sc = tses.filter_pose_2d_arrays(config["filter"], d["points"],
                                         d["scores"], **ON)
    back = tses.read_pose2d(out)
    _exact(back["points"], pts)
    _exact(back["scores"], sc)
    with pytest.raises(AssertionError, match="invalid filter type"):
        tses.filter_pose_2d_arrays({"type": "kalman"}, pts, sc, **ON)


# ---------------------------------------------------------- 3D outputs


def test_project_2d_matches_jax(projects):
    _both(projects, "triangulate_all")
    got, want = _both(projects, "project_2d_all")
    assert len(_files(got)) == len(_files(want)) == 3
    for c, (g, w) in enumerate(zip(_files(got), _files(want))):
        assert g == _twin(w, projects)
        a, b = tses.read_pose2d(g), jses.read_pose2d(w)
        assert a["bodyparts"] == BODYPARTS
        _rel_close(a["points"], b["points"])
        _rel_close(a["scores"], b["scores"])
        good = np.isfinite(a["points"][..., 0])
        np.testing.assert_allclose(a["points"][good],
                                   projects["p2d"][c][good], atol=1.0)


def test_filter_3d_matches_jax(projects):
    _both(projects, "triangulate_all")
    _copy_outputs(projects, "pose-3d")
    got, want = _both(projects, "filter_pose_3d_all", port_kw={})
    (g,), (w,) = _files(got), _files(want)
    _csv_match(g, w, rel=1e-12)
    assert (pd.read_csv(g)["head_error"] == 10).all()


def _summary_match(got, want):
    g, w = pd.read_csv(got), pd.read_csv(want)
    assert list(g.columns) == list(w.columns) and len(g) == len(w) > 0
    for col in w.columns:
        if not pd.api.types.is_numeric_dtype(w[col]):
            assert list(g[col]) == list(w[col]), col
        else:
            np.testing.assert_allclose(g[col], w[col], rtol=0, atol=1e-12)


def test_summaries_and_angles_match_jax(projects):
    _both(projects, "triangulate_all")
    _copy_outputs(projects, "pose-3d")
    for name in ("jax", "port"):
        projects[name][0]["filter"].update(type="medfilt", medfilt=5)
    _both(projects, "filter_pose_2d_all")
    _both(projects, "filter_pose_3d_all", port_kw={})
    got, want = _both(projects, "angles_all", port_kw={})
    (g,), (w,) = _files(got), _files(want)
    _summary_match(g, w)
    assert np.nanmedian(np.abs(pd.read_csv(g)["bend"] - 90)) < 3.0
    for fn in ("summarize_pose3d", "summarize_pose3d_filtered",
               "summarize_pose2d", "summarize_pose2d_filtered",
               "summarize_angles", "summarize_errors"):
        g, w = _both(projects, fn, port_kw={})
        assert g == _twin(w, projects)
        _summary_match(g, w)
    d = pd.read_csv(g)
    assert (d["project"] == "testproj").all() and "cam_name" in d


def _frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        out.append(fr)
    cap.release()
    return out


def test_label_videos_equal_frames(projects):
    rng = np.random.default_rng(9)
    pts = rng.uniform(10, 40, (6, 3, 2))
    for name in ("jax", "port"):
        sess = projects[name][1]
        jses.write_pose2d(pts, np.ones((6, 3)), BODYPARTS,
                          os.path.join(sess, "pose-2d", "vid2-cam0.h5"))
        vw = cv2.VideoWriter(os.path.join(sess, "videos-raw",
                                          "vid2-cam0.avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), 24, (64, 48))
        for _ in range(6):
            vw.write(np.zeros((48, 64, 3), np.uint8))
        vw.release()
    got, want = _both(projects, "label_videos_all", port_kw={})
    assert len(_files(got)) == len(_files(want)) == 4
    for g, w in zip(_files(got), _files(want)):
        assert g == _twin(w, projects)
        fg, fw = _frames(g), _frames(w)
        assert len(fg) == len(fw) > 0
        for a, b in zip(fg, fw):
            _exact(a, b)
    assert sum(f.sum() for f in _frames(_files(got)[-1])) > 0


def _labeled(projects, name, pick):
    config, sess = projects[name]
    labeled = os.path.join(os.path.dirname(sess), "labeled-data")
    p2d, J = projects["p2d"], len(BODYPARTS)
    calib_path = os.path.join(sess, "calibration", "calibration.toml")
    for c in range(3):
        d = os.path.join(labeled, f"vid1--{c}")
        os.makedirs(d)
        jses.write_pose2d(p2d[c][pick], np.ones((len(pick), J)),
                          BODYPARTS, os.path.join(d, "labels.h5"))
        pd.DataFrame({
            "framenum": pick,
            "calib": [calib_path] * len(pick),
            "video": [os.path.join(sess, "videos-raw",
                                   f"vid1-cam{c}.avi")] * len(pick),
            "img": ["x.png"] * len(pick),
        }).to_csv(os.path.join(d, "anipose_metadata.csv"), index=False)
    return labeled


def test_tracking_errors_match_jax(projects):
    _both(projects, "triangulate_all")
    pick = [2, 7, 10]
    for name in ("jax", "port"):
        projects[name][0]["angles"] = {
            "bend": ["head", "tail", "foot"],
            "twist": ["axis", "head", "tail", "foot"]}
    want = jses.get_tracking_errors(projects["jax"][0],
                                    labeled_dir=_labeled(projects, "jax",
                                                         pick))
    got = tses.get_tracking_errors(projects["port"][0],
                                   labeled_dir=_labeled(projects, "port",
                                                        pick), **ON)
    assert got == _twin(want, projects)
    g, w = pd.read_csv(got), pd.read_csv(want)
    assert list(g.columns) == list(w.columns) and len(g) == len(pick)
    for col in w.columns:
        if not pd.api.types.is_numeric_dtype(w[col]):
            assert [_twin(x, projects) if x.startswith("/") else x
                    for x in w[col]] == list(g[col]), col
        else:
            _rel_close(g[col], w[col])
    for bp in BODYPARTS:
        assert np.nanmax(np.asarray(g[f"{bp}_error"])) < 1.0


# ---------------------------------------------------------- calibrate-session


def _board_scene(n_cam=2, n_views=9, seed=11):
    """tests/test_calib_workflow.py's calibrate-session cameras and board
    views."""
    from macaque_tpu.calib.graph_init import make_M

    rng = np.random.default_rng(seed)
    cam_M = [make_M(rng.normal(0, 0.03, 3),
                    np.array([-80.0 + 160.0 * i, rng.normal(0, 8),
                              rng.normal(0, 8)]))
             for i in range(n_cam)]
    views = [make_M(np.array([np.pi, 0, 0]) + rng.uniform(-0.3, 0.3, 3),
                    np.array([rng.uniform(-60, 40), rng.uniform(-40, 20),
                              rng.uniform(520, 760)]))
             for _ in range(n_views)]
    return cam_M, views


def _calib_project(root, frames_of_cam):
    """A project whose session holds one board video a camera."""
    from tests.test_calib_workflow import IMG_H, IMG_W

    calib_dir = root / "sessionA" / "calibration"
    calib_dir.mkdir(parents=True)
    for name, frames in frames_of_cam.items():
        vw = cv2.VideoWriter(str(calib_dir / f"calib-cam{name}.avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), 24,
                             (IMG_W, IMG_H))
        for fr in frames:
            vw.write(fr)
        vw.release()
    return calib_dir


def _calib_config(mod, root):
    config = mod.load_session_config(str(root / "missing.toml"))
    config["path"] = str(root)
    config["triangulation"]["cam_regex"] = r"cam([A-Z])"
    config["calibration"].update(board_type="checkerboard",
                                 board_size=[9, 6],
                                 board_square_side_length=23.0)
    return config


def _held_calibrations(got, want):
    """Both ``calibration.toml``s: names, flags, ``rms`` and focal lengths
    within 1e-4 relative."""
    from macaque_tpu.compat.aniposelib import CameraGroup as JGroup
    from macaque_tpu_torch.compat.aniposelib import CameraGroup

    g = CameraGroup.load(got, **ON)
    w = JGroup.load(want)
    assert g.get_names() == w.get_names() == ["A", "B"]
    assert g.rig.metadata["adjusted"] is False
    e_g, e_w = g.rig.metadata["error"], w.rig.metadata["error"]
    assert abs(e_g - e_w) <= 1e-4 * e_w and e_g < 1.0, (e_g, e_w)
    f_g, f_w = g.rig.K[:, [0, 1], [0, 1]], w.rig.K[:, [0, 1], [0, 1]]
    np.testing.assert_allclose(f_g, f_w, rtol=1e-4, atol=0)
    return g


def _short_bundle(monkeypatch):
    """Both packages' full bundle at the short budget (the drivers take no
    budget)."""
    from macaque_tpu.calib import bundle as jb
    from macaque_tpu.geometry.lm import LMConfig as JLMConfig
    from macaque_tpu_torch.calib import bundle as tb
    from macaque_tpu_torch.geometry.lm import LMConfig

    lm, cg = SHORT
    for mod, cfg in ((jb, JLMConfig), (tb, LMConfig)):
        monkeypatch.setattr(mod, "bundle_adjust_full", functools.partial(
            mod.bundle_adjust_full,
            cfg=cfg(lm_iters=lm, cg_iters=cg, ftol=1e-12)))


def test_calibrate_session_from_detections_short_budget(tmp_path,
                                                       monkeypatch):
    """``process_session_calibrate`` from a ``detections.pickle`` of the
    board's projected corners (0.05 px noise), one blank video a camera
    for the image size; both packages at the short budget."""
    from macaque_tpu.calib.graph_init import get_rtvec
    from macaque_tpu_torch.calib.videos import Checkerboard
    from tests.test_calib_workflow import IMG_H, IMG_W, K_GT

    cam_M, views = _board_scene()
    obj = Checkerboard(9, 6, 23.0).object_points()
    rng = np.random.default_rng(3)
    all_rows = []
    for M_cam in cam_M:
        rows = []
        for v, M_board in enumerate(views):
            rvec, tvec = get_rtvec(M_cam @ M_board)
            proj, _ = cv2.projectPoints(obj.reshape(-1, 1, 3), rvec, tvec,
                                        K_GT, np.zeros(5))
            pix = proj.reshape(-1, 2) + rng.normal(0, 0.05, (54, 2))
            rows.append({"framenum": (0, v), "corners": pix.reshape(-1, 1, 2),
                         "ids": None, "filled": pix.copy()})
        all_rows.append(rows)
    _short_bundle(monkeypatch)
    blank = [np.zeros((IMG_H, IMG_W, 3), np.uint8)]
    out = {}
    for name, mod, kw in (("jax", jses, {}), ("port", tses, ON)):
        root = tmp_path / name
        calib_dir = _calib_project(root, {"A": blank, "B": blank})
        with open(calib_dir / "detections.pickle", "wb") as f:
            pickle.dump(all_rows, f)
        config = _calib_config(mod, root)
        (path,) = [v for v in mod.calibrate_all(config, **kw).values() if v]
        out[name] = path
        # skip-if-done (reference calibrate.py:158-165)
        assert all(v is None
                   for v in mod.calibrate_all(config, **kw).values())
    _held_calibrations(out["port"], out["jax"])


@pytest.mark.slow
def test_calibrate_session_from_videos_matches_jax(tmp_path):
    """tests/test_calib_workflow.py::test_calibrate_session_from_videos on
    both packages, from the same rendered board videos, at the default
    budget: equal detections, the calibrations held as above."""
    from macaque_tpu.calib.graph_init import get_rtvec
    from tests.test_calib_workflow import render_board_view

    cam_M, views = _board_scene()
    frames = {}
    for i, name in enumerate("AB"):
        frames[name] = []
        for M_board in views:
            rvec, tvec = get_rtvec(cam_M[i] @ M_board)
            fr = render_board_view(rvec, tvec)
            frames[name].append(cv2.cvtColor(fr, cv2.COLOR_GRAY2BGR))
    out = {}
    for name, mod, kw in (("jax", jses, {}), ("port", tses, ON)):
        root = tmp_path / name
        calib_dir = _calib_project(root, frames)
        config = _calib_config(mod, root)
        (path,) = [v for v in mod.calibrate_all(config, **kw).values() if v]
        out[name] = path
        assert all(v is None
                   for v in mod.calibrate_all(config, **kw).values())
        with open(calib_dir / "detections.pickle", "rb") as f:
            out[name + "_rows"] = pickle.load(f)
    for rows_g, rows_w in zip(out["port_rows"], out["jax_rows"]):
        assert len(rows_g) == len(rows_w) > 0
        for a, b in zip(rows_g, rows_w):
            assert a["framenum"] == b["framenum"]
            _exact(a["filled"], b["filled"])
    _held_calibrations(out["port"], out["jax"])


# ---------------------------------------------------------- the card


def test_session_drivers_raise_without_a_card(projects, monkeypatch):
    """Given no device and no card, a driver raises before any work: it
    never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config, sess = projects["port"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tses.triangulate_all(config)
    assert not os.path.exists(os.path.join(sess, "pose-3d", "vid1-.csv"))
    d = tses.read_pose2d(os.path.join(sess, "pose-2d", "vid1-cam0.h5"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tses.filter_pose_2d_arrays({"type": "viterbi"}, d["points"],
                                   d["scores"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tses.train_autoencoder_project(config, epochs=1)


# ---------------------------------------------------------- the CLI


def test_cli_session_subcommands_match_jax(projects, capsys):
    """``python -m macaque_tpu_torch triangulate-session --device cpu``
    (float32, the CLI's dtype) and ``summarize pose3d`` against the JAX
    CLI: the same files and lines, host columns equal, the points within
    1e-3 mm and the errors within 1e-3 px [3.2e-4 mm; float32 DLT]."""
    from macaque_tpu.__main__ import main as jmain
    from macaque_tpu_torch.__main__ import main

    (jc, _), (tc, _) = projects["jax"], projects["port"]
    jcfg = os.path.join(jc["path"], "config.toml")
    tcfg = os.path.join(tc["path"], "config.toml")
    jmain(["triangulate-session", "--config", jcfg])
    want = capsys.readouterr().out
    main(["triangulate-session", "--config", tcfg, "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want.replace(jc["path"], tc["path"]) and "wrote" in got
    g, w = pd.read_csv(got.split()[-1]), pd.read_csv(want.split()[-1])
    assert list(g.columns) == list(w.columns)
    for col in w.columns:
        if any(k in col for k in HOST_COLUMNS):
            _exact(g[col], w[col])
        else:
            np.testing.assert_allclose(g[col], w[col], rtol=0, atol=1e-3)
    jmain(["summarize", "pose3d", "--config", jcfg])
    main(["summarize", "pose3d", "--config", tcfg])
    want, got = capsys.readouterr().out.splitlines()
    assert got == want.replace(jc["path"], tc["path"])
    assert len(pd.read_csv(got.split()[-1])) == len(projects["p3d"])
