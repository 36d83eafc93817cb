"""Step 4 of the port against the JAX package's: ``run_step4`` after both
packages' ``run_step2`` and ``run_step3`` on tests/test_torch_step3.py's
scenes. JAX runs under x64 (tests/conftest.py), the port in float64 on the
CPU.

Held: ``kp2d_f`` with the same NaN pattern and values within 1e-9;
``kp3d``, ``kp3d_score`` and ``kp3d_err`` within 1e-6 mm; ``joint_len.npy``
within 1e-6; ``config.toml`` and ``calibration.toml`` byte-equal; the
fixed-length mode, ``axes_spec``/``ref_point`` and ``ransac=True``. The
refinement runs fifteen LM iterations of two CG sweeps
(``refine_overrides``): at the production budget CGLS amplifies rounding
differences about fourfold a sweep, in the JAX package itself, so that
budget is held here by its accuracy against the ground truth instead (see
tests/test_torch_refine3d.py)."""

import os

import numpy as np
import pytest
import torch

from macaque_tpu.core.config import TriangulationConfig as JTri
from macaque_tpu.pipeline import step4 as js4
from macaque_tpu.pipeline.artifacts import read_pickle
from macaque_tpu.tools import synthetic as jsyn
from macaque_tpu_torch.core.config import TriangulationConfig
from macaque_tpu_torch.pipeline import step4 as ts4
from macaque_tpu_torch.tools import synthetic as tsyn
from tests.test_torch_step2 import _port_rig
from tests.test_torch_step3 import STEP3_SCENES, run_both

BOUNDED = {"lm_iters": 15, "cg_iters": 2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU runs here are many small tensor operations, faster
    on one thread than on all of them, beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _step4_both(rig, jdir, pdir, jkw=None, pkw=None, out="kp3d.pickle"):
    js4.run_step4(jdir, rig, redo=True, **(jkw or {}))
    times = {}
    ts4.run_step4(pdir, _port_rig(rig), redo=True, device="cpu",
                  dtype=torch.float64, times=times, **(pkw or {}))
    return read_pickle(f"{jdir}/{out}"), read_pickle(f"{pdir}/{out}"), times


def _same_3d(want, got):
    for k in ("kp3d", "kp3d_score", "kp3d_err"):
        assert got[k].dtype == np.float64
        _close(got[k], want[k], 1e-6)
    assert len(got["joint_len"]) == len(want["joint_len"])
    for a, b in zip(got["joint_len"], want["joint_len"]):
        _close(a, b, 1e-6)


@pytest.mark.parametrize("name", list(STEP3_SCENES))
def test_run_step4_writes_the_jax_packages_pickles(tmp_path, name):
    rig, jdir, pdir, _ = run_both(tmp_path, name)
    ov = {"refine_overrides": BOUNDED}
    want, got, times = _step4_both(rig, jdir, pdir, ov, ov)
    _close(read_pickle(f"{pdir}/kp2d_f.pickle"),
           read_pickle(f"{jdir}/kp2d_f.pickle"), 1e-9)
    _same_3d(want, got)
    assert np.isfinite(got["kp3d"]).any()
    _close(np.load(f"{pdir}/joint_len.npy"), np.load(f"{jdir}/joint_len.npy"),
           1e-6)
    for f in ("config.toml", "calibration.toml"):
        with open(f"{pdir}/{f}", "rb") as a, open(f"{jdir}/{f}", "rb") as b:
            assert a.read() == b.read(), f
    assert set(times) == {"write", "viterbi", "dlt", "refine", "reproject",
                          "viterbi_frame_steps", "lm_iters", "cg_iters",
                          "lm_lm_steps", "lm_cg_sweeps", "lm_host_reads"}
    assert times["lm_iters"] and max(times["lm_iters"]) <= 15
    # one read an LM step and one a CG sweep, one ending each CG solve
    assert times["lm_lm_steps"] == max(times["lm_iters"])
    assert times["lm_cg_sweeps"] >= max(times["cg_iters"])
    assert times["lm_host_reads"] == (2 * times["lm_lm_steps"] + 1
                                      + times["lm_cg_sweeps"])
    # a second call finds the pickle and skips
    ts4.run_step4(pdir, _port_rig(rig), device="cpu")


@pytest.fixture(scope="module")
def two_animals(tmp_path_factory):
    """The 4-camera, 2-animal, 120-frame scene through both packages'
    steps 2-3, and its ground truth."""
    root = tmp_path_factory.mktemp("two")
    rig, jdir, pdir, _ = run_both(root, "4cam-2animal-120frame")
    return rig, jdir, pdir, jsyn.simulate_scene(2, 120, seed=1)


def test_run_step4_modes_match_jax(two_animals):
    """The fixed-length mode (``kp3d_fxdJointLen.pickle`` from the JAX run's
    ``joint_len.npy``), the coordinate-frame correction and the
    camera-subset RANSAC initialization."""
    rig, jdir, pdir, _ = two_animals
    ov = {"refine_overrides": BOUNDED}
    _step4_both(rig, jdir, pdir, ov, ov)
    jl = f"{jdir}/joint_len.npy"
    want, got, _ = _step4_both(rig, jdir, pdir, {**ov, "joint_len_path": jl},
                               {**ov, "joint_len_path": jl},
                               out="kp3d_fxdJointLen.pickle")
    _same_3d(want, got)
    med = np.median(np.load(jl), axis=0)
    for a in got["joint_len"]:
        _close(a, med, 1e-12)
    axes = {"axes_spec": [["x", "left_hip", "right_hip"],
                          ["y", "left_shoulder", "left_hip"]],
            "ref_point": "nose"}
    want, got, _ = _step4_both(rig, jdir, pdir, {**ov, **axes},
                               {**ov, **axes})
    _same_3d(want, got)
    want, got, _ = _step4_both(
        rig, jdir, pdir, {**ov, "tri_cfg": JTri(ransac=True)},
        {**ov, "tri_cfg": TriangulationConfig(ransac=True)})
    _same_3d(want, got)


def test_correct_coordinate_frame_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.normal(0, 100, (20, 17, 3))
    pts[3, 11] = np.nan
    spec = [["z", "left_hip", "right_hip"], ["x", "nose", "left_ankle"]]
    got = ts4.correct_coordinate_frame(pts, ts4.MACAQUE_BODYPARTS, spec,
                                       "left_eye")
    want = js4.correct_coordinate_frame(pts, ts4.MACAQUE_BODYPARTS, spec,
                                        "left_eye")
    for g, w in zip(got, want):
        _close(g, w, 1e-9)


def test_run_step4_production_budget_is_as_accurate_as_jax(two_animals):
    """At the production budget the two packages' solves part by rounding
    (see the module docstring); both reach the ground truth alike: every
    animal's median joint error under 30 mm (tests/test_four_animals.py's
    bound), within 1 mm of the JAX package's."""
    rig, jdir, pdir, truth = two_animals
    want, got, times = _step4_both(rig, jdir, pdir)
    assert max(times["lm_iters"]) <= 30
    cid = read_pickle(f"{pdir}/collar_id.pickle")
    assert {int(c) for v in cid.values() for c in np.unique(v) if c >= 0} \
        == {0, 1}
    T = got["kp3d"].shape[1]                 # up to the last keyframe
    for a in range(2):
        e = [np.nanmedian(np.linalg.norm(r["kp3d"][a] - truth[a, :T], axis=-1))
             for r in (got, want)]
        assert e[0] < 30.0 and abs(e[0] - e[1]) < 1.0, e


def test_run_step4_refuses_a_mesh_and_needs_a_device(tmp_path):
    rig = tsyn.make_test_rig(4)
    with pytest.raises(TypeError, match="core.mesh.Mesh"):
        ts4.run_step4(str(tmp_path), rig, mesh=object())
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    os.makedirs(tmp_path / "r")
    np.save(tmp_path / "r" / "x.npy", np.zeros(1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts4.run_step4(str(tmp_path / "r"), rig)
