"""The port's 3D tracking validation against the JAX package's: centroids,
``check_performance`` on random cases (absent animals, the exit zone,
more predictions than truths and fewer), and ``validate_kp3d_file``."""

import pickle

import numpy as np
import pytest

from macaque_tpu.tools import validation as jval
from macaque_tpu_torch.tools import validation as tval


def _case(seed):
    rng = np.random.default_rng(seed)
    A_p, A_g, T = rng.integers(1, 6), rng.integers(1, 6), rng.integers(5, 40)
    gt = rng.uniform(-1500, 1500, (A_g, T, 3))
    if seed % 3 == 0:
        gt[0, : T // 2] = [5000.0, 100.0, 800.0]      # inside the exit zone
    pred = gt[rng.integers(0, A_g, A_p)] + rng.normal(0, 250, (A_p, T, 3))
    pred[rng.random((A_p, T)) < 0.2] = np.nan
    gt[rng.random((A_g, T)) < 0.1] = np.nan
    return pred, gt


def _same(a, b):
    assert (a.tp, a.fp, a.fn) == (b.tp, b.fp, b.fn)
    assert (a.precision, a.recall) == (b.precision, b.recall)
    assert repr(a) == repr(b)


@pytest.mark.parametrize("seed", range(12))
def test_check_performance_matches_jax(seed):
    pred, gt = _case(seed)
    for kw in ({}, {"tp_threshold": 150.0}, {"exit_point": None}):
        _same(tval.check_performance(pred, gt, **kw),
              jval.check_performance(pred, gt, **kw))


def test_centroids_and_validate_kp3d_file_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    kp3d = rng.normal(0, 500, (3, 20, 17, 3))
    kp3d[1, 4, 5] = np.nan
    np.testing.assert_array_equal(tval.centroids_from_kp3d(kp3d),
                                  jval.centroids_from_kp3d(kp3d))
    pred = kp3d + rng.normal(0, 80, kp3d.shape)
    with open(tmp_path / "kp3d.pickle", "wb") as f:
        pickle.dump({"kp3d": pred}, f)
    for name, gt in (("gt_joints", kp3d),
                     ("gt_centroids", tval.centroids_from_kp3d(kp3d))):
        with open(tmp_path / f"{name}.pickle", "wb") as f:
            pickle.dump(gt, f)
        args = (str(tmp_path / "kp3d.pickle"), str(tmp_path / f"{name}.pickle"))
        _same(tval.validate_kp3d_file(*args), jval.validate_kp3d_file(*args))
