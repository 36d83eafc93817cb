"""The port's on-device tracker against the JAX package's, on the CPU: the
batched Kalman filter, the Jonker-Volgenant assignment, ``track_chunk_device``
on the three scenes of ``test_device_tracker.py``, and step 1 with
``use_device_tracker=True`` on ``test_step1_device_tracker.py``'s scene.

Tolerances: the Kalman predict/update within 1e-12 relative (float64 both
sides, sums of a few terms in another order); assignments and track ids
equal; tracked boxes within 1e-9 px (float64 both sides); step 1's
``alldata.json`` rows equal."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from macaque_tpu.pipeline.step1 import run_step1 as jax_run_step1
from macaque_tpu.tools import synthetic as jsyn
from macaque_tpu.tracking.device_tracker import make_table as jax_make_table
from macaque_tpu.tracking.device_tracker import (
    track_chunk_device as jax_track_chunk)
from macaque_tpu.tracking.hungarian import hungarian_jax
from macaque_tpu.tracking.kalman import kalman_predict_jax, kalman_update_jax
from macaque_tpu_torch.pipeline.step1 import run_step1
from macaque_tpu_torch.tools import synthetic as tsyn
from macaque_tpu_torch.tracking import (
    hungarian_torch, kalman_predict, kalman_update, make_table,
    track_chunk_device)
from tests.test_device_tracker import _pad
from tests.test_tracking import simulate_boxes


def _state(rng, n=12):
    mean = np.concatenate([rng.uniform(100, 1500, (n, 2)),
                           rng.uniform(80, 300, (n, 2)),
                           rng.normal(0, 3, (n, 4))], 1)
    a = rng.normal(0, 5, (n, 8, 8))
    cov = a @ np.swapaxes(a, 1, 2) + 10 * np.eye(8)
    return mean, cov


def test_kalman_predict_matches_jax():
    mean, cov = _state(np.random.default_rng(0))
    jm, jc = kalman_predict_jax(jnp.asarray(mean), jnp.asarray(cov))
    tm, tc = kalman_predict(torch.from_numpy(mean), torch.from_numpy(cov))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-12, atol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-12,
                               atol=1e-12)


def test_kalman_update_matches_jax():
    rng = np.random.default_rng(1)
    mean, cov = _state(rng)
    meas = mean[:, :4] + rng.normal(0, 4, (len(mean), 4))
    jm, jc = kalman_update_jax(jnp.asarray(mean), jnp.asarray(cov),
                               jnp.asarray(meas))
    tm, tc = kalman_update(torch.from_numpy(mean), torch.from_numpy(cov),
                           torch.from_numpy(meas))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-12, atol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-12,
                               atol=1e-12)


def _cost_matrices(n=200):
    """Random (N, M), N <= M, every fifth with ties: costs on a coarse grid,
    as the tracker's BIG-padded matrices have."""
    rng = np.random.default_rng(7)
    out = []
    for k in range(n):
        N = int(rng.integers(1, 9))
        M = N + int(rng.integers(0, 9))
        c = rng.uniform(0, 1, (N, M))
        if k % 5 == 0:
            c = np.round(c * 4) / 4
        out.append(c.astype(np.float32))
    return out


def test_hungarian_matches_jax_and_scipy():
    from scipy.optimize import linear_sum_assignment

    solve_jax = jax.jit(hungarian_jax)       # one trace per shape
    n_tied = 0
    for c in _cost_matrices():
        got = hungarian_torch(torch.from_numpy(c)).numpy()
        want = np.asarray(solve_jax(jnp.asarray(c)))
        np.testing.assert_array_equal(got, want)
        r, col = linear_sum_assignment(c)
        assert np.isclose(c[np.arange(len(c)), got].sum(), c[r, col].sum(),
                          rtol=0, atol=1e-5)
        n_tied += len(np.unique(c)) < c.size
    assert n_tied >= 35      # of the 40 rounded matrices, the rest too small


def test_hungarian_counts_host_reads():
    """One read a solve, the cost matrix; the counts add up across calls
    and over the tracker's 3 associations a frame."""
    stats = {"host_reads": 5}
    hungarian_torch(torch.eye(3), stats)
    assert stats["host_reads"] == 6
    hungarian_torch(torch.eye(3), stats)
    assert stats["host_reads"] == 7
    stats = {}
    track_chunk_device(make_table(4, device="cpu"), np.zeros((2, 3, 4)),
                       np.zeros((2, 3)), stats=stats)
    assert stats["host_reads"] == 2 * 3


def _scenes():
    """The three scenes of test_device_tracker.py: clean tracks, ID
    stability, a 10-frame occlusion."""
    out = []
    for T, n_obj, seed in ((40, 3, 11), (50, 3, 13), (40, 1, 17)):
        frames = list(simulate_boxes(T=T, n_obj=n_obj, seed=seed))
        if seed == 17:
            for t in range(15, 25):
                frames[t] = (np.zeros((0, 4)), np.zeros((0,)), frames[t][2])
        out.append(frames)
    return out


@pytest.mark.parametrize("scene", range(3), ids=["clean", "ids", "occlusion"])
def test_track_chunk_matches_jax(scene):
    frames = _scenes()[scene]
    boxes = np.stack([_pad(b, s)[0] for b, s, _ in frames])
    scores = np.stack([_pad(b, s)[1] for b, s, _ in frames])
    jtab, jb, jt = jax_track_chunk(jax_make_table(16), jnp.asarray(boxes),
                                   jnp.asarray(scores))
    ttab, tb, tt = track_chunk_device(
        make_table(16, device="cpu", dtype=torch.float64), boxes, scores)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert (tt.numpy() >= 0).sum() > 0
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-9)
    for name in ("tid", "state", "lost_frames", "next_id", "frame"):
        np.testing.assert_array_equal(getattr(ttab, name).numpy(),
                                      np.asarray(getattr(jtab, name)), name)
    np.testing.assert_allclose(ttab.mean.numpy(), np.asarray(jtab.mean),
                               rtol=1e-12, atol=1e-9)


def test_track_chunk_in_two_chunks_equals_one():
    """The table carries the state across chunks: two calls equal one."""
    frames = _scenes()[1]
    boxes = np.stack([_pad(b, s)[0] for b, s, _ in frames])
    scores = np.stack([_pad(b, s)[1] for b, s, _ in frames])
    table = make_table(16, device="cpu", dtype=torch.float64)
    _, b1, t1 = track_chunk_device(table, boxes, scores)
    table, b2a, t2a = track_chunk_device(table, boxes[:20], scores[:20])
    _, b2b, t2b = track_chunk_device(table, boxes[20:], scores[20:])
    np.testing.assert_array_equal(torch.cat([t2a, t2b]).numpy(), t1.numpy())
    np.testing.assert_array_equal(torch.cat([b2a, b2b]).numpy(), b1.numpy())


def test_make_table_defaults_to_the_card():
    if torch.cuda.is_available():
        assert make_table(4).mean.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_table(4)


def test_step1_device_tracker_rows_equal_jax(tmp_path):
    """Both packages' run_step1 with the device tracker on the scene of
    test_step1_device_tracker.py (2 cameras, 2 animals, 60 frames, the
    oracle perception): equal alldata.json rows and frame numbers."""
    raw = str(tmp_path / "videos")
    rig = tsyn.make_test_rig(2)
    kp3d = tsyn.simulate_scene(2, 60, seed=21)
    proj = jsyn.project_scene(jsyn.make_test_rig(2), kp3d)
    jsyn.render_stores(raw, "synth", rig, proj)

    def jfactory(cam):
        return jsyn.SyntheticPerception(rig.camera_ids.index(cam), proj,
                                        noise=1.0, seed=5)

    def tfactory(cam):
        return tsyn.SyntheticPerception(rig.camera_ids.index(cam), proj,
                                        noise=1.0, seed=5, device="cpu")

    jax_run_step1("synth", str(tmp_path / "jax"), raw, jfactory,
                  use_device_tracker=True)
    run_step1("synth", str(tmp_path / "torch"), raw, tfactory,
              use_device_tracker=True, prefetch=False)
    n_rows = 0
    for cam in rig.camera_ids:
        out = {}
        for name in ("jax", "torch"):
            d = tmp_path / name / "synth" / cam
            with open(d / "alldata.json") as f:
                out[name] = (json.load(f), np.load(d / "frame_num.npy"))
        assert out["torch"][0] == out["jax"][0], cam
        np.testing.assert_array_equal(out["torch"][1], out["jax"][1])
        n_rows += sum(len(r) for r in out["torch"][0])
    assert n_rows > 0
    assert os.path.exists(tmp_path / "torch" / "synth" / cam / "alldata.json")
