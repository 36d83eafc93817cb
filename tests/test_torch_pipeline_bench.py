"""The port's benchmark tool and probes (``macaque_tpu_torch/tools/
pipeline_bench.py``, ``int8_probe.py``, ``roialign_probe.py``,
``trunk_probe.py``) against the JAX package's.

``run`` of both packages on the CPU at 26 frames (the shortest scene with
tracks: at 12 frames there is no keyframe, and both packages' step 3
raises on an empty keyframe list), render on where cv2 exists: the same
keys (the port's ``device`` aside), equal camera-frames, and the timed
pass's ``match_keyframe.pickle`` and ``track.pickle`` equal (the port runs
its stages in float32, JAX here under x64: the keyframes' 3D poses are
held to 1e-2 mm). ``kp3d`` is left out: at the production budget the
refinement amplifies rounding (ROADMAP §3). The real tiers run only on a
card; their settings are checked against JAX's
``_build_random_fullsize_perception`` without building the networks."""

import dataclasses
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from macaque_tpu_torch.tools import int8_probe, pipeline_bench as tpb
from macaque_tpu_torch.tools import roialign_probe, trunk_probe

N_FRAME = 26


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _has_cv2():
    try:
        import cv2  # noqa: F401
        return True
    except ImportError:
        return False


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    from macaque_tpu.tools import pipeline_bench as jpb

    root = tmp_path_factory.mktemp("bench")
    render = _has_cv2()
    out = {"jax": jpb.run(n_frame=N_FRAME, n_cam=4, render=render,
                          root=str(root / "jax")),
           "port": tpb.run(n_frame=N_FRAME, n_cam=4, render=render,
                           root=str(root / "port"), device="cpu")}
    return out, root, render


def _timed(root, pkg, name):
    with open(os.path.join(root, pkg, "results_timed", "synth", name),
              "rb") as f:
        return pickle.load(f)


def test_run_keys_and_camera_frames_follow_jax(both):
    out, _, render = both
    assert set(out["port"]) - {"device"} == set(out["jax"])
    assert out["port"]["device"] == "cpu"
    assert out["port"]["camera_frames"] == out["jax"]["camera_frames"] \
        == 4 * N_FRAME
    stages = {"step1_host", "step2_crossview", "step3_crossframe",
              "step4_3d"} | ({"render"} if render else set())
    assert set(out["port"]["stages_s"]) == set(out["jax"]["stages_s"]) \
        == stages
    for k, v in out["port"]["stages_s"].items():
        assert v > 0, k
    assert "step1_real_s" not in out["port"]     # only on a card


def test_timed_pass_pickles_equal_jax(both):
    _, root, render = both
    mk = {p: _timed(root, p, "match_keyframe.pickle") for p in ("jax", "port")}
    assert len(mk["port"]) == len(mk["jax"]) == 2
    for a, b in zip(mk["port"], mk["jax"]):
        assert a["frame"] == b["frame"]
        assert len(a["bcomb"]) == len(b["bcomb"]) == 2
        for x, y in zip(a["bcomb"], b["bcomb"]):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(a["pose3d"], b["pose3d"]):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-2)
    trk = {p: _timed(root, p, "track.pickle") for p in ("jax", "port")}
    assert trk["port"].keys() == trk["jax"].keys() and trk["port"]
    for k in trk["jax"]:
        np.testing.assert_array_equal(trk["port"][k], trk["jax"][k])
    if render:
        assert os.path.exists(os.path.join(
            root, "port", "results_timed", "synth", "overlay_10000.mp4"))


def test_main_prints_one_json_line(capsys):
    tpb.main(["--cpu", "--no-render", "--frames", "24", "--cams", "4"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["camera_frames"] == 96 and out["device"] == "cpu"
    assert "render" not in out["stages_s"]


def test_render_without_cv2_raises(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="--no-render"):
        tpb.run(n_frame=24, render=True, device="cpu")


@pytest.mark.parametrize("tier", tpb.TIERS)
def test_tier_settings_equal_jax(tier, monkeypatch):
    """JAX's ``_build_random_fullsize_perception`` with its three networks
    and FlaxPerception swapped for recorders (nothing is built at full
    width): the detector config, int8 pose, flip test, detector target and
    max_det of each tier."""
    import macaque_tpu.nn as jnn
    import macaque_tpu.pipeline.perception as jperc
    from macaque_tpu.tools import pipeline_bench as jpb

    seen = {}

    def recorder(name):
        class Model:
            def __init__(self, cfg):
                seen[name] = cfg

            def init(self, rng, x):
                return {}
        return Model

    for name in ("SwinMaskRCNN", "ViTPose", "ResNetClassifier"):
        monkeypatch.setattr(jnn, name, recorder(name))
    monkeypatch.setattr(jperc, "FlaxPerception",
                        lambda *a, **kw: seen.setdefault("perception", kw))
    jpb._build_random_fullsize_perception(tier)
    got = tpb.tier_settings(tier)
    jdet, tdet = seen["SwinMaskRCNN"], got["detector"]
    common = ({f.name for f in dataclasses.fields(jdet)}
              & {f.name for f in dataclasses.fields(tdet)}) - {
                  "swin", "compute_dtype"}
    assert len(common) >= 10
    for f in common:
        assert getattr(tdet, f) == getattr(jdet, f), f
    assert tdet.compute_dtype == torch.bfloat16
    assert tdet.swin.compute_dtype == torch.bfloat16
    assert got["int8_pose"] == (seen["ViTPose"].quantize == "int8")
    assert seen["ViTPose"].use_pallas_attention
    kw = seen["perception"]
    assert (got["flip_test"], got["det_target"], got["max_det"]) == (
        kw["flip_test"], kw["det_target"], kw["max_det"])


def test_real_tiers_run_only_on_a_card(monkeypatch):
    """BENCH_STEP1_REAL=1 on the CPU device still skips the full-width
    tiers, as the JAX tool skips them on its CPU backend."""
    monkeypatch.setenv("BENCH_STEP1_REAL", "1")
    monkeypatch.setattr(tpb, "_build_random_fullsize_perception",
                        lambda *a: pytest.fail("a real tier was built"))
    out = tpb.run(n_frame=24, render=False, device="cpu")
    assert "step1_real_s" not in out and jax.default_backend() == "cpu"


@pytest.mark.parametrize("probe,argv", [
    (int8_probe, ["micro"]), (int8_probe, ["model", "--device", "cpu"]),
    (roialign_probe, []), (roialign_probe, ["64", "--device", "cpu"]),
    (trunk_probe, ["map1"]), (trunk_probe, ["map2", "--device", "cpu"])])
def test_probes_raise_without_a_card(probe, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'|on the card"):
        probe.main(argv)


def test_trunk_probe_remat_raises_with_its_reason():
    with pytest.raises(NotImplementedError, match="rematerialization"):
        trunk_probe.main(["map1", "remat", "--device", "cpu"])
    assert [trunk_probe.sub_batch(f"map{n}") for n in (1, 2, 4, 8)] == [
        1, 2, 4, 8]
    with pytest.raises(ValueError):
        trunk_probe.sub_batch("map3")


def test_probe_variants_follow_jax():
    """The variant names of the JAX probes, each with the route it runs
    here."""
    import inspect

    from macaque_tpu.tools import int8_probe as jint8
    from macaque_tpu.tools import trunk_probe as jtrunk

    src = inspect.getsource(jint8.main)
    for v in int8_probe.ROUTES:
        assert f'"{v}"' in src, v
    assert set(int8_probe.SHAPES) == {"qkv", "proj", "fc1", "fc2"}
    for name, (K, N) in int8_probe.SHAPES.items():
        assert f'"{name}": ({K}, {N})' in src
    assert f"M = {int8_probe.M_ROWS}" in src
    tsrc = inspect.getsource(jtrunk.main)
    assert '["map1", "map2", "map4", "map8"]' in tsrc
    assert '"remat"' in tsrc
