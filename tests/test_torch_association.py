"""The port's step-2 association (simplex projection, the doubly-
stochastic block projection, batched SVT matching, the ray-distance
affinity) against the JAX package's and the numpy oracles of
tests/test_association.py, on the same seeded inputs: JAX under x64, the
port in float64. Match matrices equal; affinities within 1e-10."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from macaque_tpu import association as ja
from macaque_tpu.association.svt import proj_2dpam as j_proj_2dpam
from macaque_tpu.cameras import omnidir_project, omnidir_undistort
from macaque_tpu_torch import association as ta
from macaque_tpu_torch.cameras import OmnidirCamera
from tests.test_association import (
    _block_mask, match_svt_np, match_svt_np_dual, proj2pav_np)
from tests.test_triangulate import make_rig

TOL = 1e-10


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _port_cam(cam):
    return OmnidirCamera(*[_t(np.asarray(f)) for f in cam])


def _two_people(seed, N=8):
    """The oracle's case: 4 cameras x 2 detections, even slots one person,
    odd the other."""
    rng = np.random.default_rng(seed)
    S = np.zeros((N, N))
    for i in range(N):
        for j in range(N):
            if i // 2 != j // 2 and i % 2 == j % 2:
                S[i, j] = 0.9 + rng.uniform(-0.05, 0.05)
            elif i // 2 != j // 2:
                S[i, j] = 0.1 + rng.uniform(-0.05, 0.05)
    return (S + S.T) / 2


# --------------------------------------------------------------- simplex

def test_project_simplex_matches_jax_and_oracle():
    y = np.random.default_rng(0).normal(0.3, 1.0, (20, 8))
    got = ta.project_simplex(_t(y))
    _close(got, ja.project_simplex(jnp.asarray(y)))
    _close(got, np.stack([proj2pav_np(r) for r in y]))


def test_proj_2dpam_matches_jax():
    rng = np.random.default_rng(1)
    Y = rng.uniform(0, 1, (3, 4, 5, 5))
    _close(ta.proj_2dpam(_t(Y)), j_proj_2dpam(jnp.asarray(Y)))
    denom = rng.integers(1, 26, (3, 4)).astype(float)
    _close(ta.proj_2dpam(_t(Y), denom=_t(denom)),
           j_proj_2dpam(jnp.asarray(Y), denom=jnp.asarray(denom)))


# ------------------------------------------------------------------- SVT

def _jsvt(S, blk, **kw):
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    return np.asarray(ja.match_svt(jnp.asarray(S), jnp.asarray(blk), **kw))


def _tsvt(S, blk, **kw):
    kw = {k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return ta.match_svt(_t(S), _t(blk), **kw).numpy()


@pytest.mark.parametrize("dual", [False, True], ids=["plain", "dual"])
def test_match_svt_matches_jax_and_oracle(dual):
    dimGroup = [0, 2, 4, 6, 8]
    S = _two_people(7 if dual else 3)
    blk = _block_mask(dimGroup, 8)
    kw = {"dual_stochastic": True, "block_size": 2} if dual else {}
    got = _tsvt(S, blk, **kw)
    np.testing.assert_array_equal(got, _jsvt(S, blk, **kw))
    oracle = match_svt_np_dual if dual else match_svt_np
    np.testing.assert_array_equal(got, oracle(S.copy(), dimGroup))
    assert got[0, 2] == 1 and got[0, 3] == 0


def test_match_svt_batched_iterates_until_every_matrix_converged():
    """A batch of three: each matrix matches its own oracle and JAX's
    result, each records where it first converged (where it stops when
    run alone), and the batch runs until all three have converged at
    once (the JAX package's stop test, ``done = all(conv)``)."""
    rng = np.random.default_rng(4)
    blk = _block_mask([0, 2, 4, 6], 6)
    batch = np.stack([(lambda S: (S + S.T) / 2)(rng.uniform(0, 1, (6, 6)))
                      for _ in range(3)])
    stats, alone = {}, []
    got = ta.match_svt(_t(batch), _t(blk), stats=stats).numpy()
    np.testing.assert_array_equal(got, _jsvt(batch, blk))
    for b in range(3):
        np.testing.assert_array_equal(got[b], match_svt_np(batch[b].copy(),
                                                           [0, 2, 4, 6]))
        st = {}
        ta.match_svt(_t(batch[b]), _t(blk), stats=st)
        alone.append(st["iterations"])
    assert stats["first_converged"].tolist() == alone
    assert stats["iterations"] == max(alone) > min(alone)
    assert stats["host_reads"] == stats["iterations"]


@pytest.mark.parametrize("dual", [False, True], ids=["plain", "dual"])
def test_match_svt_padded_matches_jax_and_compact(dual):
    """Padded slot layout (3 cameras x 2 slots, detection counts 2, 1, 2)
    with ``valid``: equal to JAX's and to the compact matrix's oracle."""
    rng = np.random.default_rng(9)
    dimGroup, Nc = [0, 2, 3, 5], 5
    S = rng.uniform(0.0, 0.2, (Nc, Nc))
    for i, j in [(0, 2), (0, 3), (2, 3)]:
        S[i, j] = S[j, i] = 0.92
    S = (S + S.T) / 2
    slot_of = [0, 1, 2, 4, 5]
    Sp = np.zeros((6, 6))
    Sp[np.ix_(slot_of, slot_of)] = S
    valid = np.isin(np.arange(6), slot_of)
    blk = _block_mask([0, 2, 4, 6], 6)
    kw = {"valid": valid, "block_size": 2, "dual_stochastic": dual}
    got = _tsvt(Sp, blk, **kw)
    np.testing.assert_array_equal(got, _jsvt(Sp, blk, **kw))
    oracle = match_svt_np_dual if dual else match_svt_np
    np.testing.assert_array_equal(got[np.ix_(slot_of, slot_of)],
                                  oracle(S.copy(), dimGroup))
    assert not got[3].any() and not got[:, 3].any()


def test_match_svt_dual_needs_block_size():
    with pytest.raises(ValueError, match="block_size"):
        ta.match_svt(_t(np.eye(4)), _t(np.eye(4, dtype=bool)),
                     dual_stochastic=True)


# -------------------------------------------------------------- affinity

def _scene(n_kf=3, seed=5):
    """Two people seen by 4 cameras as 6 detections (the case of
    tests/test_association.py), over ``n_kf`` keyframes that move them,
    with some keypoints below threshold."""
    cam = make_rig(4)
    rng = np.random.default_rng(seed)
    J = 17
    cam_idx = np.array([0, 0, 1, 1, 2, 3])
    und = np.zeros((n_kf, 6, J, 2))
    for t in range(n_kf):
        a = rng.uniform(-100, 100, (J, 3)) + rng.normal(0, 50, 3)
        b = a + np.array([600.0, 400.0, 0.0])
        world = np.stack([a, b, a, b, a, b])
        for m in range(6):
            c = cam_idx[m]
            sub = jax.tree.map(lambda x: x[c:c + 1], cam)
            p = omnidir_project(sub, jnp.asarray(world[m]))[0]
            und[t, m] = np.asarray(omnidir_undistort(sub, p[None])[0])
    scores = rng.uniform(0.0, 1.0, (n_kf, 6, J))
    valid = np.ones((n_kf, 6), bool)
    valid[-1, 4] = False
    return cam, und, scores, cam_idx, valid


def test_build_rays_and_line_distances_match_jax():
    cam, und, _, cam_idx, _ = _scene()
    o, d = ta.build_rays(_port_cam(cam), _t(und), _t(cam_idx))
    jo, jd = ja.build_rays(cam, jnp.asarray(und), jnp.asarray(cam_idx))
    _close(o, jo)
    _close(d, jd)
    _close(ta.line_distance_matrix(o, d),
           ja.line_distance_matrix(jo, jd))


def test_geometry_and_combined_affinity_match_jax():
    cam, und, scores, cam_idx, valid = _scene()
    got = ta.geometry_affinity(_port_cam(cam), _t(und), _t(scores),
                               _t(cam_idx), _t(valid))
    want = ja.geometry_affinity(cam, jnp.asarray(und), jnp.asarray(scores),
                                jnp.asarray(cam_idx), jnp.asarray(valid))
    _close(got, want)
    aff = got[0].numpy()
    assert aff[0, 2] > 0.7 and aff[0, 4] > 0.7        # same person
    assert aff[0, 3] < 0.2 and aff[1, 2] < 0.2        # different people
    assert aff[0, 1] == 0.0                           # same camera
    off = torch.arange(6) != 4               # (the diagonal stays ~0.94)
    assert not got[-1, 4, off].any() and not got[-1, off, 4].any()
    cids = np.array([[0, 2, 0, -1, 2, 5]] * 3)
    # a Python float, and the float32 scalar run_step2 passes
    for t_alpha, j_alpha in ((0.2, 0.2), (torch.tensor(0.2, dtype=torch.float32),
                                          jnp.float32(0.2))):
        _close(ta.combined_affinity(got, _t(cids), _t(cam_idx), t_alpha),
               ja.combined_affinity(want, jnp.asarray(cids),
                                    jnp.asarray(cam_idx), j_alpha))


def test_combined_affinity_id_boost():
    W = ta.combined_affinity(_t(np.full((1, 4, 4), 0.5)),
                             _t(np.array([[0, 2, 0, -1]])),
                             _t(np.array([0, 0, 1, 1])), alpha_id=0.2)[0]
    assert W[0, 2] > W[1, 2]
    assert W[0, 2] == 0.2 * 1 + 0.8 * 0.5
    assert W[0, 3] == 0.8 * 0.5
