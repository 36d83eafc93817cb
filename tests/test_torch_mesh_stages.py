"""Steps 2-4 of the port under a mesh of eight CPU entries
(``core/mesh.py``) against ``mesh=None``, on tests/test_multichip.py's
scene (4 cameras, rig seed 21; 2 animals x 96 frames, seed 22; alldata seed
23), float64 on the CPU; the same keyframes against the JAX package's
``mesh=None`` run (x64, tests/conftest.py); and ``run_pipeline`` with a
mesh on a small demo scene.

Held as tests/test_multichip.py holds the JAX package's sharded run, or
tighter: equal ``bcomb`` sets a keyframe; ``kp2d`` with equal NaN patterns
and values within 1e-9; ``kp3d`` finite in the same places and within 2 mm
(the JAX test's bound) and within 1e-9 mm (this port's). The JAX test needs
its converged budget (``lm_iters=100, cg_iters=300, cg_rtol=1e-4``)
because XLA compiles another program for 8 padded lanes than for 2, and
CGLS amplifies the rounding; the port solves each animal of the mesh run
in a batch of its own with the same operations in the same order (a lane's
iterates do not depend on its batch), so its difference is 0.0 at every
budget (measured). The refinement here runs tests/test_torch_step4.py's
bounded budget (15 LM iterations of 2 CG sweeps): the converged budget
takes ~4 minutes a run on the CPU and runs on the card instead
(``chip_smoke.py``'s ``mesh`` phase, tests/test_torch_cuda.py)."""

import os

import numpy as np
import pytest
import torch

from macaque_tpu.pipeline import step2 as js2
from macaque_tpu.pipeline import step3 as js3
from macaque_tpu.pipeline.artifacts import read_pickle, write_alldata
from macaque_tpu.tools import synthetic as jsyn
from macaque_tpu_torch.core.mesh import make_mesh
from macaque_tpu_torch.pipeline import step2 as ts2
from macaque_tpu_torch.pipeline import step3 as ts3
from macaque_tpu_torch.pipeline import step4 as ts4
from tests.test_torch_step2 import _port_rig

BOUNDED = dict(lm_iters=15, cg_iters=2)
N_FRAME = 96


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bcombs(mk):
    return [(k["frame"], {tuple(np.asarray(b).tolist()) for b in k["bcomb"]})
            for k in mk]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The scene through the JAX package's steps 2-3 and through the
    port's steps 2-4 with and without the mesh."""
    root = tmp_path_factory.mktemp("mesh_stages")
    rig = jsyn.make_test_rig(4, seed=21)
    kp3d = jsyn.simulate_scene(2, N_FRAME, seed=22)
    percam = jsyn.synthesize_alldata(rig, kp3d, seed=23)
    prig = _port_rig(rig)
    mesh = make_mesh(8, cam_axis_size=4, devices=["cpu"] * 8)
    out, times = {}, {}
    for tag in ("jax", "single", "mesh"):
        rd = str(root / tag / "scene")
        for c, cam_id in enumerate(rig.camera_ids):
            write_alldata(os.path.join(rd, cam_id), percam[c],
                          np.arange(N_FRAME, dtype=np.int32))
        if tag == "jax":
            js2.run_step2(rd, rig)
            js3.run_step3(rd, rig)
        else:
            m = mesh if tag == "mesh" else None
            on = dict(device="cpu", dtype=torch.float64, mesh=m)
            times[tag] = {2: {}, 4: {}}
            ts2.run_step2(rd, prig, times=times[tag][2], **on)
            ts3.run_step3(rd, prig, **on)
            ts4.run_step4(rd, prig, refine_overrides=BOUNDED,
                          times=times[tag][4], **on)
        out[tag] = rd
    return out, times


def test_step2_bcombs_equal_under_the_mesh(runs):
    out, times = runs
    mk = {t: read_pickle(os.path.join(out[t], "match_keyframe.pickle"))
          for t in out}
    assert len(mk["single"]) == len(mk["mesh"]) > 3
    assert _bcombs(mk["mesh"]) == _bcombs(mk["single"])
    # the same keyframes as the JAX package's mesh=None run
    assert _bcombs(mk["mesh"]) == _bcombs(mk["jax"])
    # the lockstep SVT: the same iterations and host reads as one batch
    for k in ("svt_iterations", "svt_host_reads"):
        assert times["mesh"][2][k] == times["single"][2][k]
    np.testing.assert_array_equal(times["mesh"][2]["svt_first_converged"],
                                  times["single"][2]["svt_first_converged"])


def test_step3_kp2d_equal_under_the_mesh(runs):
    out, _ = runs
    kp = {t: np.asarray(read_pickle(os.path.join(out[t], "kp2d.pickle")))
          for t in out}
    for t in ("mesh", "jax"):
        assert kp[t].shape == kp["single"].shape
        np.testing.assert_array_equal(np.isnan(kp[t]), np.isnan(kp["single"]))
        ok = ~np.isnan(kp["single"])
        np.testing.assert_allclose(kp[t][ok], kp["single"][ok], rtol=0,
                                   atol=1e-9)
    trk = {t: read_pickle(os.path.join(out[t], "track.pickle"))
           for t in ("single", "mesh")}
    assert trk["single"].keys() == trk["mesh"].keys()
    for k in trk["single"]:
        np.testing.assert_array_equal(trk["mesh"][k], trk["single"][k])


def test_step4_kp3d_within_tolerance_under_the_mesh(runs):
    out, times = runs
    k3 = {t: read_pickle(os.path.join(out[t], "kp3d.pickle"))
          for t in ("single", "mesh")}
    fin_s = np.isfinite(k3["single"]["kp3d"])
    fin_m = np.isfinite(k3["mesh"]["kp3d"])
    np.testing.assert_array_equal(fin_s, fin_m)
    assert fin_s.any()
    d = np.abs(k3["single"]["kp3d"][fin_s] - k3["mesh"]["kp3d"][fin_m])
    assert d.max() < 2.0, d.max()   # mm, tests/test_multichip.py's bound
    assert d.max() < 1e-9, d.max()  # the port's shard-wise solve: 0.0
    kf = {t: read_pickle(os.path.join(out[t], "kp2d_f.pickle"))
          for t in ("single", "mesh")}
    np.testing.assert_array_equal(np.isnan(kf["mesh"]), np.isnan(kf["single"]))
    ok = ~np.isnan(kf["single"])
    np.testing.assert_allclose(kf["mesh"][ok], kf["single"][ok], rtol=0,
                               atol=1e-9)
    # the slowest shard's loop: each animal's own counts, one a shard
    s, m = times["single"][4], times["mesh"][4]
    assert m["lm_iters"] == s["lm_iters"] and m["cg_iters"] == s["cg_iters"]
    assert m["lm_lm_steps"] == max(s["lm_iters"])
    assert m["lm_host_reads"] > s["lm_host_reads"]


def test_run_pipeline_with_a_mesh(tmp_path):
    """``run_pipeline`` (steps 1-4, the oracle, RGBA stores, render off)
    with a mesh of four CPU entries writes the pickles of ``mesh=None``."""
    from macaque_tpu_torch.core.config import PipelineConfig
    from macaque_tpu_torch.pipeline.runner import run_pipeline
    from macaque_tpu_torch.tools import synthetic as tsyn

    n_frame = 36
    rig = tsyn.make_test_rig(4)
    proj = tsyn.project_scene(rig, tsyn.simulate_scene(2, n_frame, seed=1))
    raw = str(tmp_path / "videos")
    tsyn.render_stores(raw, "synth", rig, proj, fourcc="RGBA")

    def factory(cam_name):
        return tsyn.SyntheticPerception(rig.camera_ids.index(cam_name), proj,
                                        device="cpu")

    rds = {}
    for tag, mesh in (("single", None),
                      ("mesh", make_mesh(devices=["cpu"] * 4))):
        cfg = PipelineConfig(data_name="synth", raw_data_dir=raw,
                             results_dir=str(tmp_path / tag))
        rds[tag] = run_pipeline(cfg, rig, factory, render=False, mesh=mesh,
                                device="cpu", dtype=torch.float64)
    for name in ("match_keyframe.pickle", "kp2d.pickle", "kp3d.pickle"):
        a = read_pickle(os.path.join(rds["single"], name))
        b = read_pickle(os.path.join(rds["mesh"], name))
        if name == "match_keyframe.pickle":
            assert len(a) > 1 and _bcombs(a) == _bcombs(b)
            continue
        if name == "kp3d.pickle":
            a, b = a["kp3d"], b["kp3d"]
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        ok = ~np.isnan(a)
        assert ok.any()
        np.testing.assert_allclose(b[ok], a[ok], rtol=0, atol=1e-6)
