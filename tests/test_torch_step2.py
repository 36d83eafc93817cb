"""Step 2 of the port against the JAX package's: collar-ID voting, keyframe
packing, cluster extraction, DLT triangulation, the pose helpers, the
best-combination pass, the synthetic scene that feeds it, and
``run_step2`` end to end. JAX runs under x64 (tests/conftest.py), the
port in float64 on the CPU, on the same seeded numpy inputs. Equal where
the result is discrete; 3D points within 1e-8 mm and pixels within
1e-8 px; ``match_keyframe.pickle`` with equal frames and ``bcomb`` lists in
order, ``pose3d`` within 1e-6 mm."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from macaque_tpu.cameras import omnidir_project, omnidir_undistort
from macaque_tpu.core.config import CrossViewConfig as JCrossViewConfig
from macaque_tpu.geometry import triangulate as jtri
from macaque_tpu.pipeline import geometry3d as jgeo
from macaque_tpu.pipeline import step2 as js2
from macaque_tpu.pipeline.artifacts import read_pickle, write_alldata
from macaque_tpu.pipeline.idvote import collar_ids_per_camera as j_vote
from macaque_tpu.tools import synthetic as jsyn
from macaque_tpu_torch.cameras import OmnidirCamera
from macaque_tpu_torch.cameras.rig import CameraRig as TRig
from macaque_tpu_torch.core.config import CrossViewConfig, VALID_COLLAR_CLASSES
from macaque_tpu_torch.geometry import triangulate as ttri
from macaque_tpu_torch.pipeline import geometry3d as tgeo
from macaque_tpu_torch.pipeline import step2 as ts2
from macaque_tpu_torch.pipeline.idvote import collar_ids_per_camera as t_vote
from macaque_tpu_torch.tools import synthetic as tsyn
from tests.test_cameras import world_points
from tests.test_triangulate import make_rig


def _t(x):
    return torch.from_numpy(np.array(x))


def _cam(cam):
    return OmnidirCamera(*[_t(np.asarray(f, np.float64)) for f in cam])


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _port_rig(rig):
    return TRig(**{f.name: getattr(rig, f.name)
                   for f in dataclasses.fields(TRig)})


@pytest.fixture(scope="module")
def scene():
    """8 cameras, 4 animals, 60 frames of the synthetic scene, made by
    the JAX package's generator."""
    rig = jsyn.make_test_rig(8, seed=0)
    kp3d = jsyn.simulate_scene(4, 60, seed=1)
    return rig, kp3d, jsyn.synthesize_alldata(rig, kp3d, seed=2)


# ------------------------------------------------------ synthetic scene

@pytest.mark.parametrize("n_cam, seed", [(4, 0), (8, 5)])
def test_synthetic_rig_and_rows_match_jax(n_cam, seed):
    jrig, rig = jsyn.make_test_rig(n_cam, seed), tsyn.make_test_rig(n_cam, seed)
    for f in dataclasses.fields(TRig):
        a, b = getattr(rig, f.name), getattr(jrig, f.name)
        if isinstance(a, np.ndarray):
            _close(a, b, 1e-9)
        else:
            assert a == b, f.name
    kp3d = tsyn.simulate_scene(3, 40, seed=seed)
    np.testing.assert_array_equal(kp3d, jsyn.simulate_scene(3, 40, seed=seed))
    _close(tsyn.project_scene(rig, kp3d), jsyn.project_scene(jrig, kp3d), 1e-9)
    got = tsyn.synthesize_alldata(rig, kp3d, seed=seed)
    want = jsyn.synthesize_alldata(jrig, kp3d, seed=seed)
    assert [[len(f) for f in c] for c in got] == [[len(f) for f in c]
                                                  for c in want]
    for gc, wc in zip(got, want):
        for gf, wf in zip(gc, wc):
            for g, w in zip(gf, wf):
                assert (g[0], g[6]) == (w[0], w[6])
                _close(g[1:5] + [g[7]], w[1:5] + [w[7]], 1e-9)
                _close(g[5], w[5], 1e-9)


# ------------------------------------------------- voting, packing, clusters

def test_collar_ids_and_packing_match_jax(scene):
    rig, _, rows = scene
    cfg = CrossViewConfig()
    cid_t = [t_vote(r, 60, cfg.cid_thr, cfg.id_vote_window) for r in rows]
    cid_j = [j_vote(r, 60, cfg.cid_thr, cfg.id_vote_window) for r in rows]
    for a, b in zip(cid_t, cid_j):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    kf = np.arange(1, 48, 12)
    got = ts2.pack_keyframes(rows, cid_t, kf, 8, 6, 17)
    want = js2.pack_keyframes(rows, cid_j, kf, 8, 6, 17)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_extract_clusters_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        m = (rng.random((12, 12)) < 0.25).astype(np.uint8)
        m = np.maximum(m, m.T)
        valid = rng.random(12) < 0.8
        got = ts2._extract_clusters(m, valid)
        want = js2._extract_clusters(m, valid)
        assert [c.tolist() for c in got] == [c.tolist() for c in want]


# ---------------------------------------------------------- triangulation

def _dlt_inputs():
    cam = make_rig(5, seed=3)
    pts = world_points(4, 10) * 0.3
    und = np.asarray(omnidir_undistort(cam, omnidir_project(
        cam, jnp.asarray(pts)))).swapaxes(0, 1)
    und = und + np.random.default_rng(0).normal(0, 1e-3, und.shape)
    mask = np.ones(und.shape[:2], bool)
    mask[0, 2:] = False                     # point 0: 2 cameras
    mask[1, 1:] = False                     # point 1: 1 camera -> NaN
    und[2, 3] = np.nan                      # a NaN under the mask
    mask[2, 3] = False
    return cam, und, mask


@pytest.mark.parametrize("fn", ["triangulate_dlt", "triangulate_dlt_pinv"])
def test_triangulate_dlt_matches_jax(fn):
    cam, und, mask = _dlt_inputs()
    got = getattr(ttri, fn)(_t(und), _cam(cam).pmat, _t(mask))
    want = getattr(jtri, fn)(jnp.asarray(und), cam.pmat, jnp.asarray(mask))
    _close(got, want, 1e-8)
    assert torch.isnan(got[1]).all() and torch.isfinite(got[0]).all()


def test_reprojection_error_mean_matches_jax():
    cam = make_rig(4)
    pts = world_points(11, 6) * 0.3
    pix = np.array(omnidir_project(cam, jnp.asarray(pts)))
    pix[1:, 0] = np.nan
    pix[2, 3] += 2.0
    _close(ttri.reprojection_error_mean(_cam(cam), _t(pts), _t(pix)),
           jtri.reprojection_error_mean(cam, jnp.asarray(pts),
                                        jnp.asarray(pix)), 1e-8)


def test_pose_triangulation_and_rmse_match_jax(scene):
    rig, _, rows = scene
    kp = np.full((6, 8, 17, 3), np.nan)
    for i in range(6):                      # animal i % 4 at frame 3 i
        for c in range(8):
            if (i + c) % 5:                 # some cameras miss it
                det = [d for d in rows[c][3 * i] if d[0] == i % 4 + 1]
                if det:
                    kp[i, c] = np.asarray(det[0][5])
    use = ~np.isnan(kp[..., 0]).all(-1)
    jcam, cam = rig.omni(), _cam(rig.omni())
    p3d = tgeo.triangulate_poses(cam, _t(kp))
    _close(p3d, jgeo.triangulate_poses(jcam, jnp.asarray(kp)), 1e-8)
    _close(tgeo.reproject_poses(cam, p3d),
           jgeo.reproject_poses(jcam, jnp.asarray(p3d.numpy())), 1e-8)
    _close(tgeo.reprojection_rmse(cam, p3d, _t(kp), _t(use)),
           jgeo.reprojection_rmse(jcam, jnp.asarray(p3d.numpy()),
                                  jnp.asarray(kp), jnp.asarray(use)), 1e-8)


def test_affinity_program_at_48_slots_matches_jax(scene):
    """W of the packed keyframes at M = 8 x 6 (the synthetic scene's
    collar IDs and ghost detection included), within 1e-10."""
    rig, _, rows = scene
    cfg = CrossViewConfig()
    cid = [t_vote(r, 60, cfg.cid_thr, cfg.id_vote_window) for r in rows]
    packed = ts2.pack_keyframes(rows, cid, np.arange(1, 48, 12), 8, 6, 17)
    jW = js2._affinity_program(
        rig.omni(), jnp.asarray(packed["cam_idx"]), jnp.asarray(packed["pose"]),
        jnp.asarray(packed["valid"]), jnp.asarray(packed["cids"]),
        jnp.float32(cfg.alpha_id))
    W, match = ts2.affinity_and_match(_port_rig(rig).omni("cpu", torch.float64),
                                      packed, cfg, 6)
    _close(W, jW, 1e-10)
    same = packed["cam_idx"][:, None] == packed["cam_idx"][None, :]
    np.testing.assert_array_equal(match, js2.match_svt(
        jW, jnp.asarray(same), valid=jnp.asarray(packed["valid"]),
        block_size=6))


# ------------------------------------------------------- best combination

def test_best_comb_same_camera_collision_matches_jax():
    """tests/test_step2_bestcomb.py's case: a merged cluster of two
    animals and a duplicate in camera 0 resolves into animal A, then the
    leftover pass picks the true B in camera 0, as in the JAX package."""
    jrig = jsyn.make_test_rig(4, seed=5)
    kp3d = jsyn.simulate_scene(2, 4, seed=6)
    kp3d[1] = kp3d[0] + np.array([60.0, 0.0, 0.0])
    J = kp3d.shape[2]
    proj = np.asarray(omnidir_project(
        jrig.omni(), jnp.asarray(kp3d.reshape(-1, 3)))).reshape(2, 4, 4, J, 2)
    rng = np.random.default_rng(1)

    def kp_for(animal, c, shift=0.0):
        pts = proj[animal, 1, c] + rng.normal(0, 0.3, (J, 2)) + shift
        return np.concatenate([pts, np.full((J, 1), 0.95)], axis=1)

    pose_np = np.stack([kp_for(0, 0), kp_for(1, 0), kp_for(1, 0, 30.0),
                        kp_for(0, 1), kp_for(1, 1), kp_for(0, 2), kp_for(0, 3)])
    cam_of = np.array([0, 0, 0, 1, 1, 2, 3])

    def combo_tensor(ti, slots):
        kp = np.zeros((4, J, 3))
        for s in slots:
            kp[cam_of[s]] = pose_np[s]
        return kp

    cam = _port_rig(jrig).omni("cpu", torch.float64)
    for cands in ([(0, list(range(7)))], [(0, [1, 2, 4])]):
        got = ts2.batched_best_combs(cands, combo_tensor, cam_of, cam, 4)
        assert got == js2.batched_best_combs(cands, combo_tensor, cam_of,
                                             jrig.omni(), 4)
    assert sorted(ts2.batched_best_combs([(0, list(range(7)))], combo_tensor,
                                         cam_of, cam, 4)[0]) == [0, 3, 5, 6]
    assert sorted(ts2.batched_best_combs([(0, [1, 2, 4])], combo_tensor,
                                         cam_of, cam, 4)[0]) == [1, 4]


# -------------------------------------------------------------- end to end

def _synthetic(n_cam, n_animal, n_frame):
    rig = jsyn.make_test_rig(n_cam, seed=0)
    kp3d = jsyn.simulate_scene(n_animal, n_frame, seed=1)
    return rig, jsyn.synthesize_alldata(rig, kp3d, seed=2)


def _wrong_detection_scene():
    """tests/test_step2_bestcomb.py's scene: one animal, and camera 0 adds
    a shifted wrong detection to every frame."""
    rig = jsyn.make_test_rig(4, seed=3)
    kp3d = jsyn.simulate_scene(1, 40, seed=4)
    proj = jsyn.project_scene(rig, kp3d)
    rng = np.random.default_rng(0)
    rows = []
    for c in range(4):
        frames = []
        for t in range(40):
            pts = proj[c, 0, t] + rng.normal(0, 0.5, (17, 2))
            dets = [[1, *map(float, (*(pts.min(0) - 5), *(pts.max(0) + 5))),
                     [[float(x), float(y), 0.95] for x, y in pts],
                     int(VALID_COLLAR_CLASSES[0]), 0.95]]
            if c == 0:
                p2 = pts + np.array([25.0, 18.0])
                dets.append([2, *map(float, (*(p2.min(0) - 5), *(p2.max(0) + 5))),
                             [[float(x), float(y), 0.95] for x, y in p2],
                             -1, 0.0])
            frames.append(dets)
        rows.append(frames)
    return rig, rows


SCENES = {
    "4cam-2animal-120frame": lambda: _synthetic(4, 2, 120),
    "8cam-4animal-60frame": lambda: _synthetic(8, 4, 60),
    "4cam-wrong-detection-40frame": _wrong_detection_scene,
}


@pytest.mark.parametrize("name", list(SCENES))
def test_run_step2_writes_the_jax_packages_pickle(tmp_path, name):
    rig, rows = SCENES[name]()
    for pkg in ("jax", "port"):
        for c, cam_id in enumerate(rig.camera_ids):
            write_alldata(str(tmp_path / pkg / cam_id), rows[c],
                          np.arange(len(rows[c]), dtype=np.int32))
    js2.run_step2(str(tmp_path / "jax"), rig, JCrossViewConfig())
    times = {}
    ts2.run_step2(str(tmp_path / "port"), _port_rig(rig), CrossViewConfig(),
                  device="cpu", dtype=torch.float64, times=times)
    want = read_pickle(str(tmp_path / "jax" / "match_keyframe.pickle"))
    got = read_pickle(str(tmp_path / "port" / "match_keyframe.pickle"))
    assert [k["frame"] for k in got] == [k["frame"] for k in want]
    assert sum(len(k["bcomb"]) for k in got) > 0
    for g, w in zip(got, want):
        assert [b.tolist() for b in g["bcomb"]] == [b.tolist() for b in w["bcomb"]]
        assert len(g["pose3d"]) == len(w["pose3d"])
        for pg, pw in zip(g["pose3d"], w["pose3d"]):
            assert pg.dtype == np.float64
            _close(pg, pw, 1e-6)
    assert set(times) == {"read_vote", "pack", "affinity", "svt", "best_comb",
                          "write", "svt_iterations", "svt_host_reads",
                          "svt_first_converged"}
    assert 1 <= times["svt_iterations"] == times["svt_host_reads"] <= 500
    assert times["svt_first_converged"].shape == (len(got),)
    assert 1 <= times["svt_first_converged"].max() <= times["svt_iterations"]
    # a second call finds the pickle and skips
    ts2.run_step2(str(tmp_path / "port"), _port_rig(rig), device="cpu")


def test_run_step2_refuses_a_mesh_and_needs_a_device(tmp_path):
    rig = tsyn.make_test_rig(4)
    with pytest.raises(TypeError, match="core.mesh.Mesh"):
        ts2.run_step2(str(tmp_path), rig, mesh=object())
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts2.run_step2(str(tmp_path), rig)
