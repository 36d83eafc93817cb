"""The port's post-hoc analysis (``macaque_tpu_torch/tools/analysis.py``)
and plots (``tools/plots.py``) against the JAX package's: the analysis
tests of tests/test_tools.py (shapes, the training-log parser and class
weights, the joint-length summary and the calibration ``.h5`` summary) on
the port, every ``analysis.py`` function equal to the JAX one on the same
inputs made from a seed (host numpy in both: held bit for bit, NaNs in
the same places), and ``plot_all`` and the CLI's ``plots`` writing the
same file names."""

import json
import os
import pickle

import numpy as np
import pytest

from macaque_tpu.tools import analysis as jan
from macaque_tpu_torch.tools import analysis as tan


def _kp3d(seed=1):
    """(A, T, J, 3) with some NaN joints and one animal missing a stretch."""
    rng = np.random.default_rng(seed)
    kp = rng.normal(0, 100, (3, 40, 17, 3))
    kp += np.cumsum(rng.normal(0, 30, (3, 40, 1, 3)), axis=1)
    kp[rng.uniform(size=kp.shape[:3]) < 0.1] = np.nan
    kp[2, 10:20] = np.nan
    return kp


def _equal(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)) and want and isinstance(want[0], str):
        assert list(got) == list(want)
    elif want is None or isinstance(want, (int, float)):
        assert got == want or (np.isnan(got) and np.isnan(want))
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ------------------------------------ tests/test_tools.py on the port


def test_shapes():
    kp3d = np.random.default_rng(1).normal(0, 100, (2, 30, 17, 3))
    assert tan.trajectories(kp3d).shape == (2, 30, 3)
    assert tan.pairwise_proximity(kp3d).shape == (2, 2, 30)
    assert tan.speed(kp3d).shape == (2, 29)
    stats = tan.joint_length_stats(kp3d, [(5, 6), (11, 12)])
    assert set(stats) == {(5, 6), (11, 12)}


def _training_log(path):
    with open(path, "w") as f:
        for ep in range(1, 4):
            for it in range(3):
                f.write(json.dumps({"epoch": ep, "iter": it,
                                    "loss": 1.0 / ep + it * 0.01}) + "\n")
            f.write(json.dumps({"step": ep,
                                "accuracy/top1": 50.0 + ep * 10}) + "\n")
    return str(path)


def test_class_weights_and_training_log(tmp_path):
    counts = [176, 50, 121, 165, 1340, 52]
    w = tan.class_weights_from_counts(counts)
    assert abs(w[0] - sum(counts) / (6 * 176)) < 1e-9
    assert w[4] == min(w)
    d = tan.parse_training_log(_training_log(tmp_path / "vis.json"))
    assert list(d["train_epochs"]) == [1, 2, 3]
    assert d["avg_loss"][0] > d["avg_loss"][2]
    assert d["best_step"] == 3 and d["best_acc"] == 80.0
    m = tan.moving_average([1.0, 1, 1, 5, 1, 1, 1], window=3)
    assert m.shape == (7,) and abs(m[3] - 7 / 3) < 1e-9


def _calibration_h5(path):
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("/123/mtx", data=np.diag([800.0, 900, 1]))
        f.create_dataset("/123/dist", data=np.zeros((1, 5)))
        f.create_dataset("/7/K", data=np.array([[610.0, 0, 330],
                                                [0, 620, 250], [0, 0, 1]]))
    return str(path)


def test_joint_length_summary_and_h5_inspect(tmp_path):
    jl = np.abs(np.random.default_rng(0).normal(100, 5, (4, 16)))
    s = tan.joint_length_summary(jl)
    assert s["mean"].shape == (16,) and len(s["labels"]) == 16
    np.testing.assert_allclose(s["mean"], jl.mean(axis=0))
    info = tan.inspect_calibration_h5(_calibration_h5(tmp_path / "c.h5"))
    assert info["123"]["fx"] == 800.0 and info["123"]["fy"] == 900.0
    assert info["123"]["dist"] == (1, 5)


# ------------------------------------ every function against the JAX one


@pytest.mark.parametrize("name", ["trajectories", "pairwise_proximity",
                                  "speed"])
def test_kp3d_functions_equal_jax(name):
    kp = _kp3d()
    _equal(getattr(tan, name)(kp), getattr(jan, name)(kp))


def test_proximity_events_and_joint_lengths_equal_jax():
    kp = _kp3d(2)
    got = tan.proximity_events(kp, threshold_mm=150.0)
    want = jan.proximity_events(kp, threshold_mm=150.0)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert any(v.any() for v in want.values())
    cons = [(5, 6), (11, 12), (0, 16)]
    _equal(tan.joint_length_stats(kp, cons), jan.joint_length_stats(kp, cons))
    _equal(tan.speed(kp, fps=30.0), jan.speed(kp, fps=30.0))


def test_log_weights_and_summaries_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    counts = rng.integers(10, 500, 7).tolist()
    _equal(tan.class_weights_from_counts(counts),
           jan.class_weights_from_counts(counts))
    arr = rng.normal(0, 1, 50)
    for window in (1, 2, 5, 8):
        _equal(tan.moving_average(arr, window), jan.moving_average(arr, window))
    _equal(tan.moving_average([], 5), jan.moving_average([], 5))
    log = _training_log(tmp_path / "vis.json")
    _equal(tan.parse_training_log(log), jan.parse_training_log(log))
    empty = tmp_path / "empty.json"
    empty.write_text("\n")
    _equal(tan.parse_training_log(str(empty)), jan.parse_training_log(str(empty)))
    jl = np.abs(rng.normal(100, 5, (4, 16)))
    jl[1, 3] = np.nan
    for a in (jl, jl[0]):
        _equal(tan.joint_length_summary(a), jan.joint_length_summary(a))
    h5 = _calibration_h5(tmp_path / "c.h5")
    _equal(tan.inspect_calibration_h5(h5), jan.inspect_calibration_h5(h5))


def test_plot_all_writes_the_jax_files(tmp_path):
    pytest.importorskip("matplotlib")
    from macaque_tpu.tools.plots import plot_all as jplot_all
    from macaque_tpu_torch.tools.plots import plot_all

    path = tmp_path / "kp3d.pickle"
    with open(path, "wb") as f:
        pickle.dump({"kp3d": _kp3d(4)}, f)
    want = jplot_all(str(path), str(tmp_path / "jax"))
    got = plot_all(str(path), str(tmp_path / "port"))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    for p in got:
        assert os.path.getsize(p) > 1000
    # and through ``python -m macaque_tpu_torch plots``
    from macaque_tpu_torch.__main__ import main

    main(["plots", str(path), "--out", str(tmp_path / "cli")])
    assert sorted(os.listdir(tmp_path / "cli")) == \
        sorted(os.listdir(tmp_path / "jax"))
