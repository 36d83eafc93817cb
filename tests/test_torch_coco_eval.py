"""The port's COCO evaluation (``macaque_tpu_torch/tools/coco_eval.py``)
against the JAX package's.

On tests/test_coco_eval.py's synthetic scene (24 images of one camera,
two animals' filled boxes, the frame index encoded in the image) with the
oracle backend: ``load_coco`` equal, ``run_coco_eval`` equal results on
both packages (the oracle is the same numpy code drawing from the same
seeds: exact), the JAX test's bounds and its degradation under corruption;
``coco_eval_arrays`` on images read beforehand equal to ``run_coco_eval``
on the files, an unreadable image skipped by both.

Then both packages' tiny perceptions (tests/torch_parity.py's widths, the
weights carried across by ``nn/convert.py::*_from_jax``, float32 on the
CPU) at det_thr 0.5 on six textured 96x128 images, ground truth drawn from
the JAX package's own predictions with a few pixels of jitter so that the
APs are not trivial. Held: the same kept detections, detection scores and
keypoint scores within 1e-4, boxes within 1e-3 px, keypoints within 0.1
px with the same NaN pattern where their score reaches step 1's keypoint
threshold of 0.3 (the step-1 tolerances of
tests/test_torch_step1.py::_assert_rows_equal, for the same reason: DARK's
Newton step turns float32 noise into ~1e-3 heatmap px where the map is
flat; 0.089 px seen). Below 0.3, where step 1 writes NaN but the
evaluation still reads the joint, a random-weight heatmap has several
near-equal maxima and the peak can move to another one: at least 95 % of
all joints within 0.1 px (2 of 136 moved, by 0.35 and 2.8 px, at scores
0.29 and 0.19). The detection APs within 1e-9 (the boxes' noise moves no
IoU across a threshold here); the keypoint APs within 0.01, because the
joint that moved 2.8 px changes one OKS, and with it one greedy match at
one threshold (AP 0.6341 against 0.6374, AP50 and AP75 equal). The
port's recorded predictions replayed through the JAX package's
``run_coco_eval`` give the port's APs exactly."""

import json
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from macaque_tpu.tools import coco_eval as jce
from macaque_tpu.tools import synthetic as jsyn
from macaque_tpu_torch.tools import coco_eval as tce
from macaque_tpu_torch.tools import synthetic as tsyn
from tests.test_torch_step1 import MAX_DET, W, _frames, _variables
from tests.torch_parity import tiny_perceptions

N_IMG = 24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_coco(path, images, annotations):
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "macaque"}]}, f)


@pytest.fixture(scope="module")
def coco_scene(tmp_path_factory):
    """tests/test_coco_eval.py's scene."""
    root = tmp_path_factory.mktemp("coco")
    rig = jsyn.make_test_rig(1, seed=41)
    kp3d = jsyn.simulate_scene(2, N_IMG, seed=42)
    proj = jsyn.project_scene(rig, kp3d)          # (C, A, T, J, 2)

    imgdir = str(root / "images")
    os.makedirs(imgdir)
    images, annotations = [], []
    aid = 1
    for t in range(N_IMG):
        fname = f"f{t:03d}.png"
        img = np.full((480, 640, 3), 30, np.uint8)
        for a in range(2):
            pts = proj[0, a, t]
            x1, y1 = pts.min(axis=0) - 8
            x2, y2 = pts.max(axis=0) + 8
            cv2.rectangle(img, (int(x1), int(y1)), (int(x2), int(y2)),
                          (0, 180, 0), -1)
            kp = np.concatenate(
                [pts, np.full((pts.shape[0], 1), 2.0)], axis=1)
            annotations.append({
                "id": aid, "image_id": t, "category_id": 1,
                "bbox": [float(x1), float(y1), float(x2 - x1),
                         float(y2 - y1)],
                "area": float((x2 - x1) * (y2 - y1)),
                "keypoints": kp.ravel().tolist(),
            })
            aid += 1
        # the oracle backend reads the frame index from the image
        tsyn.encode_index(img, t)
        cv2.imwrite(os.path.join(imgdir, fname), img)
        images.append({"id": t, "file_name": fname,
                       "width": 640, "height": 480})
    ann_file = str(root / "test.json")
    _write_coco(ann_file, images, annotations)
    return dict(proj=proj, imgdir=imgdir, ann=ann_file, images=images,
                annotations=annotations, root=root)


class _FrameOracle:
    """tests/test_coco_eval.py's oracle: ``SyntheticPerception`` of the
    package ``syn``, keyed by the frame index in the image, with optional
    Gaussian jitter of boxes and keypoints."""

    def __init__(self, syn, proj, jitter=0.0, seed=0):
        self.inner = syn.SyntheticPerception(0, proj, noise=0.5)
        self.max_det = self.inner.max_det
        self.jitter = jitter
        self.rng = np.random.default_rng(seed)

    def detect(self, frames):
        b, s = self.inner.detect(frames)
        if self.jitter:
            b = b + self.rng.normal(0, self.jitter, b.shape)
        return b, s

    def pose(self, frames, boxes, valid):
        out = self.inner.pose(frames, boxes, valid)
        if self.jitter:
            out[..., :2] += self.rng.normal(0, self.jitter,
                                            out[..., :2].shape)
        return out


def test_load_coco_equals_the_jax_packages(coco_scene):
    got, want = tce.load_coco(coco_scene["ann"]), jce.load_coco(coco_scene["ann"])
    assert len(got) == len(want) == N_IMG
    assert got[0]["boxes"].shape == (2, 4)
    assert got[0]["keypoints"].shape == (2, 17, 3)
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["file_name"] == w["file_name"]
        for k in ("boxes", "keypoints", "areas"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("jitter", [0.0, 25.0])
def test_oracle_eval_equals_the_jax_packages(coco_scene, jitter):
    kw = dict(det_thr=0.5, progress=False)
    got = tce.run_coco_eval(_FrameOracle(tsyn, coco_scene["proj"], jitter),
                            coco_scene["imgdir"], coco_scene["ann"], **kw)
    want = jce.run_coco_eval(_FrameOracle(jsyn, coco_scene["proj"], jitter),
                             coco_scene["imgdir"], coco_scene["ann"], **kw)
    assert got == want
    assert got["n_images"] == N_IMG
    if not jitter:                      # tests/test_coco_eval.py's bounds
        assert got["det"]["AP50"] > 0.95, got
        assert got["pose"]["AP50"] > 0.95, got
        assert got["det"]["mAP"] > 0.5


def test_eval_degrades_with_corruption(coco_scene):
    kw = dict(det_thr=0.5, progress=False)
    clean = tce.run_coco_eval(_FrameOracle(tsyn, coco_scene["proj"]),
                              coco_scene["imgdir"], coco_scene["ann"], **kw)
    bad = tce.run_coco_eval(_FrameOracle(tsyn, coco_scene["proj"], 25.0),
                            coco_scene["imgdir"], coco_scene["ann"], **kw)
    assert bad["det"]["mAP"] < clean["det"]["mAP"] - 0.1
    assert bad["pose"]["AP"] < clean["pose"]["AP"] - 0.1


def test_arrays_core_equals_run_coco_eval(coco_scene):
    """``coco_eval_arrays`` on images read beforehand (a None for the
    unreadable one) gives ``run_coco_eval``'s result on the files, and both
    skip the image that cannot be read, as the JAX package does; a
    ``max_images`` cut is the same cut of the records."""
    images = coco_scene["images"] + [{"id": N_IMG, "file_name": "absent.png",
                                      "width": 640, "height": 480}]
    ann = str(coco_scene["root"] / "with_absent.json")
    _write_coco(ann, images, coco_scene["annotations"])
    records = tce.load_coco(ann)
    arrays = [cv2.imread(os.path.join(coco_scene["imgdir"], r["file_name"]))
              for r in records]
    assert arrays[-1] is None
    for n in (None, 7):
        got = tce.coco_eval_arrays(_FrameOracle(tsyn, coco_scene["proj"]),
                                   arrays[:n], records[:n], det_thr=0.5,
                                   progress=False)
        files = tce.run_coco_eval(_FrameOracle(tsyn, coco_scene["proj"]),
                                  coco_scene["imgdir"], ann, det_thr=0.5,
                                  max_images=n, progress=False)
        want = jce.run_coco_eval(_FrameOracle(jsyn, coco_scene["proj"]),
                                 coco_scene["imgdir"], ann, det_thr=0.5,
                                 max_images=n, progress=False)
        assert got == files == want
        assert got["n_images"] == (N_IMG if n is None else n)


class _Recorder:
    """A perception whose detect and pose outputs are kept."""

    def __init__(self, inner):
        self.inner, self.max_det = inner, inner.max_det
        self.detections, self.poses = [], []

    def detect(self, frames):
        boxes, scores = (np.asarray(o) for o in self.inner.detect(frames))
        self.detections.append((boxes, scores))
        return boxes, scores

    def pose(self, frames, boxes, valid):
        out = np.asarray(self.inner.pose(frames, boxes, valid))
        self.poses.append(out)
        return out


class _Replay:
    """A perception that returns a ``_Recorder``'s outputs in order."""

    def __init__(self, rec):
        self.max_det = rec.max_det
        self.detections, self.poses = iter(rec.detections), iter(rec.poses)

    def detect(self, frames):
        return next(self.detections)

    def pose(self, frames, boxes, valid):
        return next(self.poses)


def test_tiny_perceptions_evaluate_alike(tmp_path):
    det_thr = 0.5
    flax, port = tiny_perceptions(*_variables(), max_det=MAX_DET,
                                  det_target=W)
    frames = _frames()
    rng = np.random.default_rng(7)
    images, annotations = [], []
    os.makedirs(tmp_path / "images")
    for t, img in enumerate(frames):
        cv2.imwrite(str(tmp_path / "images" / f"{t}.png"), img)
        images.append({"id": t, "file_name": f"{t}.png"})
        boxes, scores = (np.asarray(o) for o in flax.detect(img[None]))
        keep = scores[0] > det_thr
        kps = np.asarray(flax.pose(img[None], boxes, scores > det_thr))[0]
        for b, kp in zip(boxes[0][keep], kps[keep]):
            b = b + rng.normal(0, 2.0, 4)
            kp = np.concatenate([kp[:, :2] + rng.normal(0, 2.0, (17, 2)),
                                 np.full((17, 1), 2.0)], 1)
            annotations.append({
                "id": len(annotations) + 1, "image_id": t, "category_id": 1,
                "bbox": [float(b[0]), float(b[1]), float(b[2] - b[0]),
                         float(b[3] - b[1])],
                "keypoints": np.nan_to_num(kp).ravel().tolist()})
    assert annotations                    # the scene has ground truth
    ann = str(tmp_path / "test.json")
    _write_coco(ann, images, annotations)

    rj, rt = _Recorder(flax), _Recorder(port)
    want = jce.run_coco_eval(rj, str(tmp_path / "images"), ann,
                             det_thr=det_thr, progress=False)
    got = tce.run_coco_eval(rt, str(tmp_path / "images"), ann,
                            det_thr=det_thr, progress=False)
    for (bt, st), (bj, sj) in zip(rt.detections, rj.detections):
        np.testing.assert_array_equal(st > det_thr, sj > det_thr)
        np.testing.assert_allclose(st, sj, atol=1e-4)
        keep = sj > det_thr
        np.testing.assert_allclose(bt[keep], bj[keep], atol=1e-3)
    moved = []
    for pt, pj in zip(rt.poses, rj.poses):
        np.testing.assert_array_equal(np.isnan(pt), np.isnan(pj))
        np.testing.assert_allclose(pt[..., 2], pj[..., 2], atol=1e-4)
        sure = pj[..., 2] >= 0.3
        np.testing.assert_allclose(pt[sure][:, :2], pj[sure][:, :2], atol=0.1)
        d = np.abs(pt[..., :2] - pj[..., :2]).max(-1)
        moved += list(d[~np.isnan(d)])
    assert np.mean(np.asarray(moved) <= 0.1) >= 0.95, sorted(moved)[-5:]
    assert got["n_images"] == want["n_images"] == len(frames)
    assert 0 < want["det"]["mAP"] < 1 and 0 < want["pose"]["AP"] < 1, want
    np.testing.assert_allclose(list(got["det"].values()),
                               list(want["det"].values()), rtol=0, atol=1e-9)
    np.testing.assert_allclose(list(got["pose"].values()),
                               list(want["pose"].values()), rtol=0, atol=0.01)
    # the port's own predictions through the JAX package's run_coco_eval: the
    # port's APs exactly
    assert jce.run_coco_eval(_Replay(rt), str(tmp_path / "images"), ann,
                             det_thr=det_thr, progress=False) == got
