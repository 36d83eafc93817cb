"""The port's LM-CGLS engine, constrained 3D refinement and RANSAC
triangulation against the JAX package's. JAX runs under x64
(tests/conftest.py), the port in float64 on the CPU, on the same seeded
numpy inputs.

Held: the Hutchinson probe stream bit for bit; ``lm_solve`` on a small
batched nonlinear problem within 1e-9 with equal LM iterations and CG
sweeps; ``_residuals`` within 1e-10; ``initialize_joint_lengths`` within
1e-10; ``refine_points_3d_batch`` on tests/test_refine3d.py's scene, free
and fixed lengths, within 1e-6 mm with equal LM iterations and CG sweeps
per lane over fifteen LM iterations of two CG sweeps; the converged optimum
(100 LM iterations, CG to 1e-8) within 1e-4 mm and its cost within 1e-9;
lane independence (one animal alone equals that animal in a batch of
three with an all-NaN slot, bit for bit); ``triangulate_ransac``.

Why not the production budget (30 LM iterations of up to 60 sweeps) to
1e-6 mm: past about ten sweeps CGLS amplifies a rounding difference
about fourfold a sweep on this problem, in the JAX package itself (a
1e-15 relative change of its input moves its result by millimetres), so
two implementations agree to rounding only while the sweeps are few
(fixed lengths are stiffer: four sweeps an iteration already part them
by 0.1 mm), and at convergence."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from macaque_tpu.cameras import omnidir_undistort
from macaque_tpu.geometry import ransac as jransac
from macaque_tpu.geometry import refine3d as jr
from macaque_tpu.geometry import triangulate_dlt
from macaque_tpu.geometry.lm import LMConfig as JLMConfig, lm_solve as jlm
from macaque_tpu_torch.cameras import OmnidirCamera
from macaque_tpu_torch.geometry import ransac as transac
from macaque_tpu_torch.geometry import refine3d as tr
from macaque_tpu_torch.geometry.lm import (
    LMConfig, hutchinson_probes, lm_solve)
from macaque_tpu_torch.utils import threefry
from tests.test_refine3d import make_walk, project_with_noise
from tests.test_triangulate import make_rig


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


def _cam(cam):
    return OmnidirCamera(*[_t(np.asarray(f, np.float64)) for f in cam])


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# ----------------------------------------------------------------- probes

@pytest.mark.parametrize("it", [0, 1, 7, 29, 1000])
@pytest.mark.parametrize("n", [1, 5, 262, 4896])
def test_probe_stream_is_jax_bit_for_bit(it, n):
    key = jax.random.fold_in(jax.random.PRNGKey(7), it)
    want = np.asarray(jax.random.rademacher(key, (8, n), dtype=jnp.float64))
    np.testing.assert_array_equal(hutchinson_probes(it, 8, n), want)
    np.testing.assert_array_equal(
        threefry.fold_in(threefry.prng_key(7), it), np.asarray(key))


def test_threefry_hash_known_answer():
    """The Threefry-2x32 (20 rounds) reference vector of Salmon et al.,
    as JAX's tests check it."""
    a, b = threefry.threefry2x32(
        np.array([0x13198A2E, 0x03707344], np.uint32),
        np.array([0x243F6A88], np.uint32), np.array([0x85A308D3], np.uint32))
    assert (int(a[0]), int(b[0])) == (0xC4923A9C, 0x483DF7A0)


# --------------------------------------------------------------- lm_solve

def _lm_problem(B=3, n=6, m=20, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, m, n)), rng.normal(size=(B, m)),
            rng.normal(size=(B, n)))


def test_lm_solve_batch_matches_jax_lane_by_lane():
    A, y, x0 = _lm_problem()
    cfg = dict(lm_iters=40, cg_iters=30, ftol=1e-9, cg_rtol=1e-6)
    At, yt = _t(A), _t(y)

    def resid(x):
        z = (At * x[:, None, :]).sum(-1)
        return torch.tanh(z) * 2 + 0.1 * z ** 2 - yt

    x, info = lm_solve(resid, _t(x0), LMConfig(**cfg), return_info=True)
    for b in range(A.shape[0]):
        Ab, yb = jnp.asarray(A[b]), jnp.asarray(y[b])
        wx, winfo = jlm(lambda v: jnp.tanh(Ab @ v) * 2 + 0.1 * (Ab @ v) ** 2
                        - yb, jnp.asarray(x0[b]), JLMConfig(**cfg),
                        return_info=True)
        _close(x[b], wx, 1e-9)
        assert int(info["lm_iters"][b]) == int(winfo["lm_iters"])
        assert int(info["cg_iters"][b]) == int(winfo["cg_iters"])
        assert bool(info["ftol_stop"][b]) == bool(winfo["ftol_stop"])
        _close(info["cost"][b], winfo["cost"], 1e-9)
    assert info["lm_steps"] == int(info["lm_iters"].max())
    assert info["host_reads"] == (2 * info["lm_steps"] + 1
                                  + info["cg_sweeps"])


# ------------------------------------------------------------ refinement

CFG = dict(scale_smooth=3.0, scale_length=5.0, reproj_error_threshold=3.0,
           n_deriv_smooth=2)
CONS, CONS_W = [[0, 1], [1, 2], [2, 3]], [[0, 2]]


@pytest.fixture(scope="module")
def walks():
    """tests/test_refine3d.py's scene: three 4-joint walks seen by 4
    cameras (3 px noise, 15 % missing), their DLT init."""
    cam = make_rig(4)
    p2, p3, truth = [], [], []
    for s in range(3):
        p3d_true = make_walk(F=30, J=4, seed=s)
        p2d = project_with_noise(cam, p3d_true, noise=3.0, seed=s + 1)
        und = omnidir_undistort(cam, jnp.asarray(p2d.reshape(4, -1, 2)))
        undT = jnp.swapaxes(und, 0, 1)
        mask = ~jnp.isnan(undT[..., 0])
        p3.append(np.asarray(triangulate_dlt(
            jnp.nan_to_num(undT), cam.pmat, mask)).reshape(30, 4, 3))
        p2.append(p2d)
        truth.append(p3d_true)
    return cam, np.stack(p2), np.stack(p3), np.stack(truth)


@pytest.mark.parametrize("loss", ["soft_l1", "huber", "linear"])
@pytest.mark.parametrize("n_deriv", [1, 2])
def test_residuals_match_jax(walks, loss, n_deriv):
    cam, p2, p3, _ = walks
    cfg = jr.RefineConfig(reproj_loss=loss, n_deriv_smooth=n_deriv)
    rng = np.random.default_rng(1)
    x = p3[:2] + rng.normal(0, 5, p3[:2].shape)
    jl = rng.uniform(80, 200, (2, 4))
    scores = rng.uniform(0.5, 1, p2.shape[1:-1])
    ssf = np.array([0.7, 1.3])
    cons = np.asarray(CONS)
    cons_w = np.asarray(CONS_W)
    got = tr._residuals(_t(x), _t(jl), _cam(cam), _t(p2[:2]),
                        _t(~np.isnan(p2[:2])), _t(cons), _t(cons_w), _t(ssf),
                        tr.RefineConfig(**cfg._asdict()))
    for a in range(2):
        want = jr._residuals(
            jnp.asarray(x[a]), jnp.asarray(jl[a]), cam, jnp.asarray(p2[a]),
            jnp.asarray(~np.isnan(p2[a])), jnp.asarray(cons),
            jnp.asarray(cons_w), ssf[a], cfg)
        _close(got[a], want, 1e-10)
    got = tr._residuals(_t(x[0]), _t(jl[0]), _cam(cam), _t(p2[0]),
                        _t(~np.isnan(p2[0])), _t(cons), _t(cons_w), ssf[0],
                        tr.RefineConfig(**cfg._asdict()), _t(scores))
    want = jr._residuals(
        jnp.asarray(x[0]), jnp.asarray(jl[0]), cam, jnp.asarray(p2[0]),
        jnp.asarray(~np.isnan(p2[0])), jnp.asarray(cons),
        jnp.asarray(cons_w), ssf[0], cfg, jnp.asarray(scores))
    _close(got, want, 1e-10)


def test_initialize_joint_lengths_matches_jax(walks):
    _, _, p3, _ = walks
    cases = [p3[0], p3[1].copy()]
    cases[1][:, 2] *= 40.0                           # an outlier segment
    p = np.zeros((10, 3, 3))
    p[:, 1, 0] = 100.0
    p[:, 2, 0] = 5000.0
    cases.append(p)
    for x in cases:
        for cons, cons_w in ((CONS[:x.shape[1] - 1], CONS_W),
                             (CONS[:2], np.zeros((0, 2), int))):
            got = tr.initialize_joint_lengths(_t(x), cons, cons_w)
            want = jr.initialize_joint_lengths(
                jnp.asarray(x), jnp.asarray(cons, jnp.int32),
                jnp.asarray(np.reshape(cons_w, (-1, 2)), jnp.int32))
            _close(got, want, 1e-10)


def _jax_lanes(cam, p2, p3, cfg, jl=None):
    out = []
    for a in range(p2.shape[0]):
        out.append(jr.refine_points_3d(
            cam, jnp.asarray(p2[a]), jnp.asarray(p3[a]), CONS, CONS_W, cfg,
            None if jl is None else jnp.asarray(jl), return_info=True))
    return out


@pytest.mark.parametrize("fixed", [False, True])
def test_refine_batch_matches_jax_step_by_step(walks, fixed):
    """Fifteen LM iterations of two CG sweeps at the production settings
    otherwise: every lane within 1e-6 mm of the JAX package's, with the
    same LM iterations, CG sweeps and costs."""
    cam, p2, p3, truth = walks
    cfg = jr.RefineConfig(**CFG, lm_iters=15, cg_iters=2)
    jl = None
    if fixed:
        jl = np.array([np.linalg.norm(truth[0, 0, a] - truth[0, 0, b])
                       for a, b in CONS + CONS_W])
    got_p, got_l, info = tr.refine_points_3d_batch(
        _cam(cam), _t(p2), _t(p3), CONS, CONS_W,
        tr.RefineConfig(**cfg._asdict()),
        None if jl is None else _t(jl), return_info=True)
    assert got_p.shape == p3.shape and got_l.shape == (3, 4)
    for a, (wp, wl, winfo) in enumerate(_jax_lanes(cam, p2, p3, cfg, jl)):
        _close(got_p[a], wp, 1e-6)
        _close(got_l[a], wl, 1e-6)
        assert int(info["lm_iters"][a]) == int(winfo["lm_iters"])
        assert int(info["cg_iters"][a]) == int(winfo["cg_iters"])
        np.testing.assert_allclose(float(info["cost"][a]),
                                   float(winfo["cost"]), rtol=1e-9)


def test_refine_converges_to_the_jax_optimum():
    """tests/test_refine3d.py's scipy-parity scene (12 frames, 3 joints)
    solved to convergence: the same optimum within 1e-4 mm, the same
    cost within 1e-9."""
    cam = make_rig(4)
    p3d_true = make_walk(F=12, J=3, seed=2)
    p2d = project_with_noise(cam, p3d_true, noise=3.0, seed=5)
    und = omnidir_undistort(cam, jnp.asarray(p2d.reshape(4, -1, 2)))
    undT = jnp.swapaxes(und, 0, 1)
    p3 = np.asarray(triangulate_dlt(jnp.nan_to_num(undT), cam.pmat,
                                    ~jnp.isnan(undT[..., 0]))).reshape(12, 3, 3)
    cfg = jr.RefineConfig(**CFG, lm_iters=100, cg_iters=200, cg_rtol=1e-8,
                          ftol=1e-12)
    wp, wl, winfo = jr.refine_points_3d(cam, jnp.asarray(p2d),
                                        jnp.asarray(p3), [[0, 1], [1, 2]],
                                        (), cfg, return_info=True)
    gp, gl, info = tr.refine_points_3d(_cam(cam), _t(p2d), _t(p3),
                                       [[0, 1], [1, 2]], (),
                                       tr.RefineConfig(**cfg._asdict()),
                                       return_info=True)
    _close(gp, wp, 1e-4)
    _close(gl, wl, 1e-4)
    np.testing.assert_allclose(float(info["cost"]), float(winfo["cost"]),
                               rtol=1e-9)
    assert bool(info["ftol_stop"]) and bool(winfo["ftol_stop"])


def test_refine_lanes_are_independent(walks):
    """At the production budget, one animal alone gives exactly what it
    gives inside a batch of three that includes an all-NaN slot; the empty
    slot stops at once (NaN cost) and stays NaN-free in its points."""
    cam, p2, p3, truth = walks
    cfg = tr.RefineConfig(**CFG)
    p2b, p3b = p2.copy(), p3.copy()
    p2b[2] = np.nan
    p3b[2] = np.nan
    bp, bl, binfo = tr.refine_points_3d_batch(
        _cam(cam), _t(p2b), _t(p3b), CONS, CONS_W, cfg, return_info=True)
    ap, al, ainfo = tr.refine_points_3d(_cam(cam), _t(p2[1]), _t(p3[1]),
                                        CONS, CONS_W, cfg, return_info=True)
    np.testing.assert_array_equal(bp[1].numpy(), ap.numpy())
    np.testing.assert_array_equal(bl[1].numpy(), al.numpy())
    assert int(binfo["lm_iters"][1]) == int(ainfo["lm_iters"])
    assert int(binfo["lm_iters"][2]) == 1 and int(binfo["cg_iters"][2]) == 0
    # the refinement beats the noisy DLT init, as the JAX test asserts
    err = np.linalg.norm(bp[1].numpy() - truth[1], axis=-1).mean()
    assert err < np.nanmean(np.linalg.norm(p3[1] - truth[1], axis=-1))


# ------------------------------------------------------------------ RANSAC

@pytest.mark.parametrize("max_drop", [None, 1])
def test_triangulate_ransac_matches_jax(max_drop):
    cam = make_rig(5, seed=3)
    p3d_true = make_walk(F=6, J=4, seed=8).reshape(-1, 3)
    pix = project_with_noise(cam, p3d_true[None], noise=0.3, miss_frac=0.2,
                             seed=9)[:, 0]
    rng = np.random.default_rng(2)
    out = rng.random(pix.shape[:2]) < 0.15           # gross outliers
    pix[out] += rng.uniform(30, 60, (out.sum(), 2))
    got = transac.triangulate_ransac(_cam(cam), _t(pix), max_drop=max_drop)
    want = jransac.triangulate_ransac(cam, jnp.asarray(pix),
                                      max_drop=max_drop)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip(got[::2] + got[3:], want[::2] + want[3:]):
        _close(g, w, 1e-8)
    np.testing.assert_array_equal(transac._subset_masks(5, max_drop),
                                  jransac._subset_masks(5, max_drop))
