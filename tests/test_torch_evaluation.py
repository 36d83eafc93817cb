"""The port's COCO-style evaluation (``macaque_tpu_torch/tools/
evaluation.py``) against the JAX package's: tests/test_evaluation.py's four
tests on the port, then ``bbox_iou_np``, ``oks``, ``evaluate_detections``
and ``evaluate_keypoints`` equal to the JAX package's, exact floats, on 20
seeded random scenes (both are the same numpy code: any difference is a
fault); and the JAX package's empty-prediction fault, which the port
answers with COCO's AP of 0."""

import numpy as np
import pytest

from macaque_tpu.tools import evaluation as jev
from macaque_tpu_torch.tools import evaluation as tev
from macaque_tpu_torch.tools.evaluation import (
    evaluate_detections, evaluate_keypoints, oks,
)


# ------------------------------------ tests/test_evaluation.py, on the port

def test_perfect_detections_ap1():
    rng = np.random.default_rng(0)
    pb, ps, gb = [], [], []
    for _ in range(10):
        boxes = rng.uniform(0, 400, (3, 2))
        boxes = np.concatenate([boxes, boxes + rng.uniform(50, 150, (3, 2))], 1)
        gb.append(boxes)
        pb.append(boxes.copy())
        ps.append(rng.uniform(0.5, 1.0, 3))
    r = evaluate_detections(pb, ps, gb)
    assert r["mAP"] > 0.99 and r["AP50"] > 0.99


def test_detection_ap_penalizes_misses_and_fps():
    gb = [np.array([[0, 0, 100, 100], [200, 200, 300, 300.0]])]
    pb = [np.array([[0, 0, 100, 100], [500, 500, 600, 600.0]])]
    ps = [np.array([0.9, 0.8])]
    r = evaluate_detections(pb, ps, gb)
    # one TP of two GT with one FP: AP ~ 0.5 at every threshold
    assert 0.3 < r["mAP"] < 0.6


def test_oks_identity_and_decay():
    rng = np.random.default_rng(1)
    kp = rng.uniform(0, 200, (1, 17, 2))
    gt = np.concatenate([kp[0], np.ones((17, 1))], axis=1)[None]
    area = np.array([10000.0])
    s = oks(kp, gt, area)
    assert s[0, 0] > 0.999
    s2 = oks(kp + 30.0, gt, area)
    assert s2[0, 0] < s[0, 0]


def test_keypoint_ap_with_jitter():
    rng = np.random.default_rng(2)
    pk, ps, gk, ga = [], [], [], []
    for _ in range(8):
        kp = rng.uniform(50, 450, (2, 17, 2))
        gt = np.concatenate([kp, np.ones((2, 17, 1))], axis=2)
        pk.append(kp + rng.normal(0, 1.5, kp.shape))
        ps.append(rng.uniform(0.7, 1.0, 2))
        gk.append(gt)
        ga.append(np.full(2, 40000.0))
    r = evaluate_keypoints(pk, ps, gk, ga)
    assert r["AP"] > 0.9
    assert r["AP50"] >= r["AP75"] >= 0.0


# ------------------------------------------- against the JAX package

def _scene(seed):
    """Images with 0-4 ground-truth animals (some images none, some
    invisible joints), jittered predictions with misses, false positives
    and images without prediction; the first image has at least one
    prediction."""
    rng = np.random.default_rng(seed)
    n_img = int(rng.integers(2, 7))
    pb, ps, gb, pk, pks, gk, ga = [], [], [], [], [], [], []
    for i in range(n_img):
        M = int(rng.integers(0, 5))
        lo = rng.uniform(0, 400, (M, 2))
        boxes = np.concatenate([lo, lo + rng.uniform(40, 200, (M, 2))], 1)
        kp = rng.uniform(0, 500, (M, 17, 2))
        vis = (rng.uniform(size=(M, 17, 1)) > 0.2).astype(float) * 2
        gb.append(boxes)
        gk.append(np.concatenate([kp, vis], -1))
        ga.append(rng.uniform(2000, 40000, M))
        keep = rng.uniform(size=M) > 0.25
        n_fp = int(rng.integers(0, 3))
        fp_lo = rng.uniform(0, 400, (n_fp, 2))
        pbox = np.concatenate([
            boxes[keep] + rng.normal(0, rng.uniform(1, 30), (keep.sum(), 4)),
            np.concatenate([fp_lo, fp_lo + 60], 1)])
        pkp = np.concatenate([
            kp[keep] + rng.normal(0, rng.uniform(1, 20), (keep.sum(), 17, 2)),
            rng.uniform(0, 500, (n_fp, 17, 2))])
        if i == 0 and len(pbox) == 0:           # at least one prediction
            pbox, pkp = np.array([[0, 0, 50, 50.0]]), rng.uniform(0, 50, (1, 17, 2))
        pb.append(pbox)
        ps.append(rng.uniform(0.3, 1.0, len(pbox)))
        pk.append(pkp)
        pks.append(rng.uniform(0.3, 1.0, len(pkp)))
    return pb, ps, gb, pk, pks, gk, ga


@pytest.mark.parametrize("seed", range(20))
def test_metrics_equal_the_jax_packages(seed):
    pb, ps, gb, pk, pks, gk, ga = _scene(seed)
    a = np.concatenate(pb)
    b = np.concatenate(gb) if sum(len(g) for g in gb) else np.zeros((1, 4))
    np.testing.assert_array_equal(tev.bbox_iou_np(a, b), jev.bbox_iou_np(a, b))
    for p, g, area in zip(pk, gk, ga):
        if len(p) and len(g):
            np.testing.assert_array_equal(tev.oks(p, g, area),
                                          jev.oks(p, g, area))
    got = tev.evaluate_detections(pb, ps, gb)
    want = jev.evaluate_detections(pb, ps, gb)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(list(got.values()), list(want.values()))
    got = tev.evaluate_keypoints(pk, pks, gk, ga)
    want = jev.evaluate_keypoints(pk, pks, gk, ga)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(list(got.values()), list(want.values()))


def test_empty_prediction_fault_of_the_jax_package():
    """``macaque_tpu/tools/evaluation.py:60`` takes ``~`` of the empty
    float array it gets when ground truth exists and no image has a
    prediction, and raises; the port returns COCO's AP of 0. Whenever one
    prediction exists, the two agree."""
    empty = ([np.zeros((0, 4))], [np.zeros(0)], [[[0, 0, 10, 10]]])
    with pytest.raises(TypeError):
        jev.evaluate_detections(*empty)
    assert tev.evaluate_detections(*empty) == {"mAP": 0.0, "AP50": 0.0,
                                               "AP75": 0.0}
    kp_empty = ([np.zeros((0, 17, 2))], [np.zeros(0)],
                [np.ones((1, 17, 3))], [np.ones(1)])
    with pytest.raises(TypeError):
        jev.evaluate_keypoints(*kp_empty)
    assert tev.evaluate_keypoints(*kp_empty) == {"AP": 0.0, "AP50": 0.0,
                                                 "AP75": 0.0}
    for box in ([[0, 0, 10, 10]], [[0, 0, 5, 10]], [[40, 40, 50, 50]]):
        one = ([np.asarray(box, float), np.zeros((0, 4))],
               [np.array([0.7]), np.zeros(0)],
               [[[0, 0, 10, 10]], [[20, 20, 30, 30]]])
        assert tev.evaluate_detections(*one) == jev.evaluate_detections(*one)
