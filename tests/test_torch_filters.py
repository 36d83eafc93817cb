"""The port's temporal filters against the JAX package's: the particle
Viterbi (``viterbi_filter``, ``viterbi_filter_joints``, batched over
streams as step 4 runs it) on tests/test_filters.py's cases, against JAX
and the NumPy oracle ``viterbi_path_np``, with equal keep/drop (NaN and
missing-particle pattern) and values within 1e-9; the smoothing functions
within 1e-12. JAX runs under x64 (tests/conftest.py), the port in float64
on the CPU, on the same seeded numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from macaque_tpu.filters import smoothing as js
from macaque_tpu.filters import viterbi as jv
from macaque_tpu_torch.filters import smoothing as ts
from macaque_tpu_torch.filters import viterbi as tv
from tests.oracles import viterbi_path_np
from tests import test_filters


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU runs here are many small tensor operations, faster
    on one thread than on all of them, beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


CASES = {  # test_filters.py's Viterbi cases: (T, P, seed, gap, thres_dist)
    "p1-gap": (40, 1, 2, (10, 14), 25.0),
    "p2-decoy": (25, 2, 5, None, 25.0),
    "p2-decoy-default": (25, 2, 7, None, 30.0),
    "p1-short": (20, 1, 9, None, 30.0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_viterbi_filter_matches_jax_and_the_oracle(name):
    T, P, seed, gap, thres = CASES[name]
    points, scores = test_filters.TestViterbi()._run_case(T=T, P=P, seed=seed, gap=gap)
    got_p, got_s = tv.viterbi_filter(_t(points), _t(scores), 3, thres, 0.3)
    want_p, want_s = jv.viterbi_filter(jnp.asarray(points),
                                       jnp.asarray(scores), 3, thres, 0.3)
    _close(got_p, want_p, 1e-9)
    _close(got_s, want_s, 1e-9)
    pts = points.copy()
    pts[scores < 0.3] = np.nan
    o_p, o_s = viterbi_path_np(pts, scores, n_back=3, thres_dist=thres)
    _close(got_p, o_p, 1e-9)
    _close(got_s, o_s, 1e-9)
    # keep/drop: the missing particle (-1, -1) at the same frames
    np.testing.assert_array_equal(got_p.numpy()[:, 0] == -1, o_p[:, 0] == -1)


def _streams(T=60, J=4, P=2, seed=0):
    """(S, T, J, P, 2) candidates with decoys, gaps, sub-threshold scores
    and near-duplicates within a frame."""
    rng = np.random.default_rng(seed)
    S = 3
    truth = np.cumsum(rng.normal(0, 4, (S, T, J, 2)), axis=1) + 300
    pts = np.repeat(truth[..., None, :], P, axis=-2)
    pts += rng.normal(0, 1, pts.shape)
    if P > 1:
        pts[..., 1, :] += rng.choice([2.0, 80.0], (S, T, J, 1))  # dup or decoy
    scs = rng.uniform(0.1, 1.0, (S, T, J, P))
    gone = rng.random((S, T, J)) < 0.15
    pts[gone] = np.nan
    scs[gone] = 0.0
    return pts, scs


def test_viterbi_filter_joints_batch_matches_jax_per_stream():
    """Step 4's layout: every (animal x camera, joint) stream in one batch,
    equal to the JAX function run stream by stream."""
    pts, scs = _streams()
    got_p, got_s = tv.viterbi_filter_joints(_t(pts), _t(scs), 3, 25.0, 0.3)
    assert got_p.shape == pts.shape[:3] + (2,)
    for s in range(pts.shape[0]):
        want_p, want_s = jv.viterbi_filter_joints(
            jnp.asarray(pts[s]), jnp.asarray(scs[s]), 3, 25.0, 0.3)
        _close(got_p[s], want_p, 1e-9)
        _close(got_s[s], want_s, 1e-9)


def test_viterbi_single_frame_and_all_missing():
    pts = np.full((1, 2, 1, 2), np.nan)
    scs = np.zeros((1, 2, 1))
    got = tv.viterbi_filter_joints(_t(pts), _t(scs))
    want = jv.viterbi_filter_joints(jnp.asarray(pts), jnp.asarray(scs))
    for g, w in zip(got, want):
        _close(g, w, 0)
    pts, scs = _streams(T=12, J=2, P=1, seed=3)
    pts[:, 4:8] = np.nan
    got = tv.viterbi_filter_joints(_t(pts[0]), _t(scs[0]))
    want = jv.viterbi_filter_joints(jnp.asarray(pts[0]), jnp.asarray(scs[0]))
    for g, w in zip(got, want):
        _close(g, w, 1e-9)


# ----------------------------------------------------------- smoothing

def test_interpolate_nan_matches_jax_column_by_column():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 6))
    x[rng.random(x.shape) < 0.3] = np.nan
    x[:5, 1] = np.nan              # leading run
    x[-7:, 2] = np.nan             # trailing run
    x[:, 3] = np.nan               # all NaN -> zeros
    x[:, 4] = 1.5                  # none missing
    got = ts.interpolate_nan(_t(x), dim=0)
    want = np.stack([np.asarray(js.interpolate_nan(jnp.asarray(x[:, i])))
                     for i in range(x.shape[1])], axis=1)
    _close(got, want, 1e-12)
    _close(ts.interpolate_nan(_t(x.T.copy()), dim=1), want.T, 1e-12)


@pytest.mark.parametrize("size", [7, 4, 13])
def test_median_filter_matches_jax(size):
    x = np.random.default_rng(size).normal(size=(40, 3))
    got = ts.median_filter_1d(_t(x), size, dim=0)
    want = np.stack([np.asarray(js.median_filter_1d(jnp.asarray(x[:, i]),
                                                    size))
                     for i in range(3)], axis=1)
    _close(got, want, 1e-12)


def test_median_matches_jnp_median_and_nanmedian():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, 8))
    x[1, 2] = np.nan
    x[3] = np.nan
    for dim in (0, 1):
        _close(ts.median(_t(x), dim), jnp.median(jnp.asarray(x), axis=dim),
               1e-12)
        _close(ts.median(_t(x), dim, ignore_nan=True),
               jnp.nanmedian(jnp.asarray(x), axis=dim), 1e-12)


def test_ema_smooth_matches_jax():
    rng = np.random.default_rng(5)
    kp = rng.normal(0, 12, (30, 6, 3))
    kp[4, 1, :2] = np.nan
    kp[10:13, 2, :2] = np.nan
    got = ts.ema_smooth(_t(kp), alpha=0.5, disp_thr=20.0)
    _close(got, js.ema_smooth(jnp.asarray(kp), alpha=0.5, disp_thr=20.0),
           1e-12)


@pytest.mark.parametrize("spline", [True, False])
def test_filter_pose_medfilt_2d_matches_jax(spline):
    rng = np.random.default_rng(6)
    pts = np.cumsum(rng.normal(0, 2, (60, 3, 1, 2)), axis=0) + 100
    pts[rng.random((60, 3, 1)) < 0.1] += 80.0        # outliers
    sc = rng.uniform(0.0, 1.0, (60, 3, 1, 1))
    arr = np.concatenate([pts, sc], axis=-1)
    got = ts.filter_pose_medfilt_2d(arr, spline=spline)
    want = js.filter_pose_medfilt_2d(arr, spline=spline)
    for g, w in zip(got, want):
        _close(g, w, 1e-12)
