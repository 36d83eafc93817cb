"""The port's remaining anipose tools (``macaque_tpu_torch/tools/
session_extras.py``, ``tools/report.py``) against the JAX package's: the
ten tests of tests/test_session_extras.py, each run by both packages on
tests/test_torch_session.py's twin project trees, and ``pose-videos``
through one fake perception backend on both sides. JAX runs under x64
(tests/conftest.py); the port on the CPU in float64.

Held: every rendered video with the JAX test's checks on the port's
output and frames equal to the JAX package's (the 2D renders, on the
same inputs) or within 1 grey level in mean (the 3D and combined renders,
drawn by matplotlib from points that differ by ~1e-13 mm; measured
0); ``pick_frames`` equal; ``extract_frames``' images, annotations and
provenance equal (the annotations come from identical detections, the
ranking from reprojections within 1e-13); ``calibration_errors.csv``
within 1e-9 of the largest value; the report's HTML equal; the
``pose-videos`` outputs equal."""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
pd = pytest.importorskip("pandas")

from macaque_tpu.tools import session as jses  # noqa: E402
from macaque_tpu.tools import session_extras as jsx  # noqa: E402
from macaque_tpu_torch.tools import session as tses  # noqa: E402
from macaque_tpu_torch.tools import session_extras as tsx  # noqa: E402
from tests.test_torch_session import (  # noqa: E402, F401
    BODYPARTS, ON, _exact, _files, _frames, _rel_close, _twin, projects)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(projects, name, port_kw={}, **kw):
    """``name`` of each package's session_extras on its own tree."""
    want = getattr(jsx, name)(projects["jax"][0], **kw)
    got = getattr(tsx, name)(projects["port"][0], **kw, **port_kw)
    return got, want


@pytest.fixture
def tracked(projects):
    """Both trees with 3D, projections and labeled videos computed."""
    for mod, name, on in ((jses, "jax", {}), (tses, "port", ON)):
        config = projects[name][0]
        mod.triangulate_all(config, **on)
        mod.project_2d_all(config, **on)
        mod.label_videos_all(config)
    return projects


def _same_videos(got_files, want_files, projects, mean_tol=None):
    assert len(got_files) == len(want_files) > 0
    for g, w in zip(got_files, want_files):
        assert g == _twin(w, projects)
        fg, fw = _frames(g), _frames(w)
        assert len(fg) == len(fw) > 0
        for a, b in zip(fg, fw):
            if mean_tol is None:
                _exact(a, b)
            else:
                assert a.shape == b.shape
                assert np.abs(a.astype(float) - b).mean() <= mean_tol


def test_label_filter_compare(projects):
    out0, _ = _run(projects, "label_filter_compare_all")
    assert not _files(out0)
    for mod, name in ((jses, "jax"), (tses, "port")):
        config = projects[name][0]
        config["filter"].update(type="medfilt", medfilt=5,
                                offset_threshold=100.0)
        mod.filter_pose_2d_all(config, **({} if mod is jses else ON))
    got, want = _run(projects, "label_filter_compare_all")
    (g,) = _files(got)
    assert g.endswith(os.path.join("videos-compare", "vid1-.mp4"))
    cap = cv2.VideoCapture(g)
    H = cap.get(cv2.CAP_PROP_FRAME_HEIGHT)
    cap.release()
    assert H == 3 * 320 and len(_frames(g)) == 12
    _same_videos(_files(got), _files(want), projects)
    assert not _files(tsx.label_filter_compare_all(projects["port"][0]))


def _multidigit_tree(root):
    sess = os.path.join(root, "s1")
    for sub in ("videos-raw", "pose-2d", "pose-2d-filtered"):
        os.makedirs(os.path.join(sess, sub))
    xpos = {"1": 10, "2": 30, "10": 50}
    for c, x in xpos.items():
        vw = cv2.VideoWriter(
            os.path.join(sess, "videos-raw", f"vid-cam{c}.avi"),
            cv2.VideoWriter_fourcc(*"MJPG"), 24, (64, 48))
        for _ in range(4):
            vw.write(np.zeros((48, 64, 3), np.uint8))
        vw.release()
        pts = np.full((4, 1, 2), [x, 24.0])
        for sub in ("pose-2d", "pose-2d-filtered"):
            jses.write_pose2d(pts, np.ones((4, 1)), ["nose"],
                              os.path.join(sess, sub, f"vid-cam{c}.h5"))
    return xpos


def test_label_filter_compare_multidigit_cams(tmp_path):
    """Cameras 1, 2, 10: each tile's labels from that camera's own file
    (natural order), in both packages, the same frames."""
    outs = {}
    for name, mod in (("jax", jses), ("port", tses)):
        root = str(tmp_path / name)
        xpos = _multidigit_tree(root)
        config = mod.load_session_config(os.path.join(root, "missing.toml"))
        config["path"] = root
        config["triangulation"]["cam_regex"] = r"cam([0-9]+)"
        sx = jsx if mod is jses else tsx
        (outs[name],) = _files(sx.label_filter_compare_all(config))
    frame = _frames(outs["port"])[0]
    h3, w = frame.shape[0] // 3, frame.shape[1] // 3
    row2 = frame[h3:2 * h3]
    for tile, c in enumerate(["1", "2", "10"]):
        tile_img = row2[:, tile * w:(tile + 1) * w]
        red = (tile_img[:, :, 2] > 150) & (tile_img[:, :, 1] < 100)
        assert red.any(), c
        xs = np.where(red.any(axis=0))[0]
        assert abs(xs.mean() - xpos[c] * 320 / 48) < 25, c
    for a, b in zip(_frames(outs["port"]), _frames(outs["jax"])):
        _exact(a, b)


def test_label_videos_3d(tracked):
    got, want = _run(tracked, "label_videos_3d_all")
    (g,) = _files(got)
    assert g.endswith(os.path.join("videos-3d", "vid1-.mp4"))
    assert len(_frames(g)) == 12
    _same_videos(_files(got), _files(want), tracked, mean_tol=1.0)
    assert not _files(tsx.label_videos_3d_all(tracked["port"][0]))


def test_label_videos_proj(tracked):
    got, want = _run(tracked, "label_videos_proj_all")
    assert len(_files(got)) == 3
    for f in _files(got):
        assert "videos-labeled-proj" in f and len(_frames(f)) == 12
    _same_videos(_files(got), _files(want), tracked)


def test_label_combined(tracked):
    for name, sx in (("jax", jsx), ("port", tsx)):
        sx.label_videos_3d_all(tracked[name][0])
    got, want = _run(tracked, "label_combined_all")
    (g,) = _files(got)
    assert g.endswith(os.path.join("videos-combined", "vid1-.mp4"))
    frame = _frames(g)[0]
    assert frame.shape[1] > frame.shape[0]
    _same_videos(_files(got), _files(want), tracked, mean_tol=1.0)


@pytest.mark.parametrize("mode", ["bad", "good", "random"])
def test_pick_frames_spacing_and_ranking(mode):
    errors = np.full(100, 0.1)
    errors[40:80] = 10.0
    errors[5] = np.nan
    vidnums = np.repeat([0, 1], 50)
    framenums = np.tile(np.arange(50), 2)
    kw = dict(num_frames_pick=3, spacing=10)
    got = tsx.pick_frames(errors, vidnums, framenums, mode=mode,
                          rng=np.random.default_rng(0), **kw)
    want = jsx.pick_frames(errors, vidnums, framenums, mode=mode,
                           rng=np.random.default_rng(0), **kw)
    assert got == want and len(got) == 3
    if mode == "bad":
        errors = np.full(100, 0.1)
        errors[40:80] = 10.0
        picked = tsx.pick_frames(errors, np.zeros(100, int), np.arange(100),
                                 mode="bad", rng=np.random.default_rng(0),
                                 **kw)
        fs = sorted(f for _, f in picked)
        assert all(40 <= f < 80 for f in fs), fs
        assert all(b - a > 10 for a, b in zip(fs, fs[1:])), fs
    with pytest.raises(ValueError):
        tsx.pick_frames(errors, vidnums, framenums, mode="worst")


def test_extract_frames(tracked):
    got, want = _run(tracked, "extract_frames", port_kw=ON, mode="bad",
                     num_frames_pick=3, spacing=3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g == _twin(w, tracked)
        pngs = sorted(f for f in os.listdir(g) if f.endswith(".png"))
        assert pngs == sorted(f for f in os.listdir(w) if f.endswith(".png"))
        assert len(pngs) == 3
        for p in pngs:
            _exact(cv2.imread(os.path.join(g, p)), cv2.imread(os.path.join(w, p)))
        ann_g = pd.read_csv(os.path.join(g, "annotations.csv"))
        ann_w = pd.read_csv(os.path.join(w, "annotations.csv"))
        assert list(ann_g.columns) == list(ann_w.columns)
        assert f"{BODYPARTS[0]}_x" in ann_g.columns and len(ann_g) == 3
        _exact(ann_g.drop(columns="img"), ann_w.drop(columns="img"))
        meta_g = pd.read_csv(os.path.join(g, "frames.csv"))
        meta_w = pd.read_csv(os.path.join(w, "frames.csv"))
        assert {"img", "video", "framenum"} <= set(meta_g.columns)
        _exact(meta_g["framenum"], meta_w["framenum"])
        assert list(meta_g["video"]) == [_twin(v, tracked)
                                         for v in meta_w["video"]]


def test_load_2d_data_matches_jax(tracked):
    got = tsx.load_2d_data(tracked["port"][0], **ON)
    want = jsx.load_2d_data(tracked["jax"][0])
    assert got["cam_names"] == want["cam_names"]
    assert got["bodyparts"] == want["bodyparts"] == BODYPARTS
    for k in ("points", "scores"):
        for a, b in zip(got[k], want[k]):
            _exact(a, b)
    for a, b in zip(got["proj"], want["proj"]):
        _rel_close(a, b)


def test_convert_videos(tracked):
    got, want = _run(tracked, "convert_videos_all")
    assert len(_files(got)) == 3
    for f in _files(got):
        assert f.endswith(".mp4") and "videos-raw-mp4" in f
        assert len(_frames(f)) == 12
    _same_videos(_files(got), _files(want), tracked)


def test_calibration_errors(tracked, monkeypatch):
    """A stubbed board detector (the same in both packages): board corners
    projected into each camera triangulate back with ~0 error for every
    camera pair."""
    import jax.numpy as jnp

    from macaque_tpu.calib import videos as jvids
    from macaque_tpu.cameras import omnidir_project
    from macaque_tpu_torch.calib import videos as tvids

    rig = tracked["rig"]
    board_pts = np.stack(np.meshgrid(np.arange(6) * 25.0,
                                     np.arange(5) * 25.0), -1).reshape(-1, 2)
    obj3d = np.concatenate([board_pts, np.zeros((len(board_pts), 1))], 1)
    obj3d = obj3d + np.array([0, 0, 60.0])
    proj = np.asarray(omnidir_project(
        rig.omni(), jnp.asarray(obj3d))).reshape(rig.n_cam, -1, 2)

    def fake_detect(path, board, skip=20, progress=False):
        cam = int(os.path.basename(path).split("cam")[1].split(".")[0])
        return [{"framenum": 0, "corners": proj[cam].reshape(-1, 1, 2),
                 "ids": np.arange(len(board_pts)), "filled": proj[cam]}]

    monkeypatch.setattr(jvids, "detect_board_video", fake_detect)
    monkeypatch.setattr(tvids, "detect_board_video", fake_detect)
    out = {}
    for name, sx, on in (("jax", jsx, {}), ("port", tsx, ON)):
        config, sess = tracked[name]
        cal_dir = os.path.join(sess, "calibration")
        for c in range(rig.n_cam):
            vw = cv2.VideoWriter(os.path.join(cal_dir, f"calib-cam{c}.avi"),
                                 cv2.VideoWriter_fourcc(*"MJPG"), 24,
                                 (64, 48))
            vw.write(np.zeros((48, 64, 3), np.uint8))
            vw.release()
        config["pipeline"]["calibration_videos"] = "calibration"
        config["calibration"] = {"board_type": "checkerboard",
                                 "board_size": [6, 5],
                                 "board_square_side_length": 25}
        (out[name],) = sx.calibration_errors_session(config, sess, **on)
    assert out["port"] == _twin(out["jax"], tracked)
    d, w = pd.read_csv(out["port"]), pd.read_csv(out["jax"])
    assert list(d.columns) == list(w.columns) and len(d) == 3
    assert (d["n_points"] == len(board_pts)).all()
    assert (d["error_mean"] < 0.1).all(), d
    for col in w.columns:
        if pd.api.types.is_numeric_dtype(w[col]):
            _rel_close(d[col], w[col])
        else:
            assert list(d[col]) == list(w[col])


def test_report(tracked):
    from macaque_tpu.tools.report import generate_report as jreport
    from macaque_tpu_torch.tools.report import generate_report

    for name, sx in (("jax", jsx), ("port", tsx)):
        sx.label_videos_3d_all(tracked[name][0])
    want = jreport(tracked["jax"][0])
    got = generate_report(tracked["port"][0])
    assert got == _twin(want, tracked)
    html = open(got).read()
    assert html == open(want).read()
    for s in ("testproj", "vid1", "<video", "per-bodypart stats", "head",
              "<img"):
        assert s in html
    assert sorted(os.listdir(os.path.join(os.path.dirname(got), "plots"))) \
        == sorted(os.listdir(os.path.join(os.path.dirname(want), "plots")))


class _FakePerception:
    """One box a frame (its score falls below 0.5 on every fifth frame)
    and keypoints from the frame's mean grey level: the same numpy
    backend for both packages."""

    def detect(self, frames):
        n = len(frames)
        level = frames.reshape(n, -1).mean(1)
        boxes = np.zeros((n, 2, 4), np.float32)
        boxes[:, 0] = [[5, 5, 40, 30]] * n
        scores = np.zeros((n, 2), np.float32)
        scores[:, 0] = np.where(level % 5 < 1, 0.3, 0.9)
        return boxes, scores

    def pose(self, frames, boxes, valid):
        n, D = boxes.shape[:2]
        level = frames.reshape(n, -1).mean(1)
        kps = np.zeros((n, D, 17, 3), np.float32)
        kps[..., 0] = level[:, None, None] + np.arange(17)
        kps[..., 1] = 2 * level[:, None, None]
        kps[..., 2] = 0.8
        return kps


def test_pose_videos(projects):
    for name in ("jax", "port"):
        sess = projects[name][1]
        vw = cv2.VideoWriter(os.path.join(sess, "videos-raw",
                                          "vid3-cam0.avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), 24, (64, 48))
        for i in range(20):
            vw.write(np.full((48, 64, 3), 3 * i, np.uint8))
        vw.release()
    want = jsx.pose_videos_all(projects["jax"][0], _FakePerception())
    got = tsx.pose_videos_all(projects["port"][0], _FakePerception())
    (g,), (w,) = _files(got), _files(want)
    assert g == _twin(w, projects)
    a, b = tses.read_pose2d(g), jses.read_pose2d(w)
    assert a["bodyparts"] == b["bodyparts"] and len(a["bodyparts"]) == 17
    _exact(a["points"], b["points"])
    _exact(a["scores"], b["scores"])
    assert a["points"].shape == (20, 17, 2)
    assert (a["scores"] == 0).any() and (a["scores"] > 0.7).any()
    assert not _files(tsx.pose_videos_all(projects["port"][0],
                                          _FakePerception()))
    with pytest.raises(ValueError, match="build_torch_perception"):
        tsx.process_session_pose_videos(projects["port"][0],
                                        projects["port"][1])
