"""The port's 2D-only video tools (``macaque_tpu_torch/tools/run2d.py``)
against the JAX package's (``macaque_tpu/tools/run2d.py``), on both
packages' tiny perceptions (tests/torch_parity.py's widths, the weights
carried across by ``nn/convert.py::*_from_jax``, float32 on the CPU).

``pose_2d_frames`` is the JAX package's chunk body (detect, threshold,
pose: ``macaque_tpu/tools/run2d.py:96-99``) behind the perception seam, so
run on the JAX perception it is the JAX computation. On 8 textured frames
of 96x128 at det_thr 0.5 the port's perception gives the same masks,
keypoint scores within 1e-4, keypoints within 0.1 px with the same NaN
pattern where their score reaches step 1's keypoint threshold of 0.3, and
at least 90 % of all joints within 0.1 px (the tolerances and reasons of
tests/test_torch_coco_eval.py: below 0.3 a random-weight heatmap's peak
can move to another near-equal maximum). Seen: 0.011 px at most above
0.3; 541 of 544 joints within 0.1 px, the other three moved 0.65, 2.5 and
56.6 px at scores 0.29, 0.19 and 0.15.

Drawing: ``_augment_neck`` and ``annotate_frame`` equal to the JAX
package's on the same keypoints; ``render_2d_video`` and
``check_skeleton`` given the same (JAX) perception draw the same frames as
the JAX package's, and given each package's own perception count the same
frames and detections."""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from macaque_tpu.tools import run2d as jrun2d
from macaque_tpu_torch.tools import run2d as trun2d
from tests.test_torch_step1 import MAX_DET, W, _frames, _variables
from tests.torch_parity import tiny_perceptions

DET_THR = 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def perceptions():
    return tiny_perceptions(*_variables(), max_det=MAX_DET, det_target=W)


def _eight_frames():
    return np.concatenate([_frames(0), _frames(1)[:2]])


def test_pose_2d_frames_matches_the_jax_chunk(perceptions):
    """Keypoints to the step-1 tolerances where step 1 keeps them (score
    >= 0.3: 0.1 px); below it the peak of a flat random heatmap may move
    to another near-equal maximum, so 90 % of all joints within 0.1 px."""
    flax, port = perceptions
    frames = _eight_frames()
    kj, vj = trun2d.pose_2d_frames(flax, frames, DET_THR)
    kt, vt = trun2d.pose_2d_frames(port, frames, DET_THR)
    assert kt.shape == kj.shape == (8, MAX_DET, 17, 3)
    assert vt.dtype == bool and vt.shape == (8, MAX_DET)
    np.testing.assert_array_equal(vt, vj)
    assert vj.any()
    np.testing.assert_array_equal(np.isnan(kt), np.isnan(kj))
    np.testing.assert_array_equal(np.isnan(kt[..., 0]), ~vt[..., None]
                                  .repeat(17, -1))
    np.testing.assert_allclose(kt[..., 2], kj[..., 2], atol=1e-4)
    sure = kj[..., 2] >= 0.3
    np.testing.assert_allclose(kt[sure][:, :2], kj[sure][:, :2], atol=0.1)
    moved = np.abs(kt[vt][..., :2] - kj[vj][..., :2]).max(-1)
    assert np.mean(moved <= 0.1) >= 0.9, np.sort(moved.ravel())[-5:]


def test_neck_and_annotation_equal_the_jax_packages():
    rng = np.random.default_rng(3)
    kps = np.concatenate([rng.uniform(0, 120, (3, 17, 2)),
                          rng.uniform(0, 1, (3, 17, 1))], -1)
    kps[0, 5] = np.nan                       # one shoulder missing
    kps[2, 5:7] = np.nan                     # both: the neck is NaN
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        np.testing.assert_array_equal(trun2d._augment_neck(kps),
                                      jrun2d._augment_neck(kps))
    frame = _frames()[0]
    for kw in ({}, {"score_thr": 0.6, "mrksize": 3}):
        with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
            got = trun2d.annotate_frame(frame, kps, **kw)
            want = jrun2d.annotate_frame(frame, kps, **kw)
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, frame)


def _video(path, n=6):
    """``n`` textured frames of 96x128 as an mp4v file."""
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                        (W, 96))
    for f in np.concatenate([_frames(0), _frames(1)])[:n]:
        w.write(f)
    w.release()
    return str(path)


def _decoded(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        frames.append(img)
    cap.release()
    return frames


def test_render_2d_video_matches_the_jax_packages(perceptions, tmp_path):
    flax, port = perceptions
    src = _video(tmp_path / "src.mp4")
    kw = dict(det_thr=DET_THR, chunk=4)
    want = jrun2d.render_2d_video(src, str(tmp_path / "j.mp4"), flax, **kw)
    same = trun2d.render_2d_video(src, str(tmp_path / "s.mp4"), flax, **kw)
    own = trun2d.render_2d_video(src, str(tmp_path / "t.mp4"), port, **kw)
    assert want["frames"] == same["frames"] == own["frames"] == 6
    assert want["detections"] == same["detections"] == own["detections"] > 0
    jf, sf, tf = (_decoded(str(tmp_path / f"{n}.mp4")) for n in "jst")
    assert len(jf) == len(sf) == len(tf) == 6
    for a, b in zip(sf, jf):
        np.testing.assert_array_equal(a, b)
    # max_frames and fps, as the JAX package reads them
    cut = trun2d.render_2d_video(src, str(tmp_path / "c.mp4"), port,
                                 max_frames=3, fps=5.0, **kw)
    assert cut["frames"] == 3 and len(_decoded(cut["out"])) == 3
    with pytest.raises(FileNotFoundError):
        trun2d.render_2d_video(str(tmp_path / "absent.mp4"),
                               str(tmp_path / "x.mp4"), port)


def test_check_skeleton_matches_the_jax_packages(perceptions):
    flax, port = perceptions
    frame = _frames()[2]
    img_j, kps_j = jrun2d.check_skeleton(frame, flax, det_thr=DET_THR)
    img_s, kps_s = trun2d.check_skeleton(frame, flax, det_thr=DET_THR)
    np.testing.assert_array_equal(img_s, img_j)
    np.testing.assert_array_equal(kps_s, kps_j)
    img_t, kps_t = trun2d.check_skeleton(frame, port, det_thr=DET_THR)
    assert img_t.shape == frame.shape
    assert kps_t.shape == kps_j.shape and kps_t.shape[1:] == (17, 3)
