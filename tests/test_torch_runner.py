"""``run_pipeline`` of the port against the JAX package's, end to end from
video to ``kp3d.pickle`` and the overlay, on one 4-camera, 2-animal,
48-frame FFV1 recording with the oracle perception; JAX under x64
(tests/conftest.py), the port in float64 on the CPU.

Held: equal ``alldata.json`` rows, equal step 2-3 pickles (``pose3d``
within 1e-6 mm), ``kp2d_f`` within 1e-9, each animal's ``kp3d`` median
error within 1 mm of the JAX package's (the production refinement
amplifies rounding, ROADMAP.md §3, so ``kp3d`` is held by its accuracy),
the same manifest, the overlay's frames, ``overlay_points`` within 1e-6
px of the JAX projection, resumability; then the stage timer, the
profiler hook, the CLI's and the demo's surfaces."""

import argparse
import ast
import inspect
import json
import os
import pickle
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from macaque_tpu.core.config import PipelineConfig as JConfig
from macaque_tpu.pipeline.runner import run_pipeline as jrun
from macaque_tpu.tools import synthetic as jsyn
from macaque_tpu_torch.core.config import PipelineConfig
from macaque_tpu_torch.pipeline.artifacts import read_pickle
from macaque_tpu_torch.pipeline.runner import run_pipeline
from macaque_tpu_torch.tools import synthetic as tsyn
from tests.test_torch_step2 import _port_rig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ["step1_2d", "step2_crossview", "step3_crossframe", "step4_3d",
          "render"]
PORTED = ("step1", "step2", "step3", "step4", "render", "pipeline",
          "validate", "angles", "plots", "pose2d", "eval-coco",
          "convert-weights", "triangulate-session", "project-2d",
          "label-videos", "session-angles", "tracking-errors", "label-3d",
          "label-proj", "label-combined", "convert-videos",
          "calibration-errors", "report", "filter-2d", "filter-3d",
          "train-autoencoder", "label-filter-compare", "calibrate-session",
          "extract-frames", "pose-videos", "sweep", "summarize", "label-cage",
          "calibrate")
# the subcommands whose work reaches a tensor: the JAX surface, then
# ``--device`` last
WITH_DEVICE = ("triangulate-session", "project-2d", "tracking-errors",
               "calibration-errors", "filter-2d", "train-autoencoder",
               "calibrate-session", "extract-frames", "pose-videos",
               "calibrate", "pose2d", "eval-coco", "sweep")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _factory(mod, rig, proj):
    def make(cam_name):
        return mod.SyntheticPerception(rig.camera_ids.index(cam_name), proj,
                                       noise=1.0)
    return make


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' run_pipeline on one recording, overlay of camera 0;
    the JAX package's once."""
    root = tmp_path_factory.mktemp("pipeline")
    rig = jsyn.make_test_rig(4)
    truth = jsyn.simulate_scene(2, 48, seed=1)
    proj = jsyn.project_scene(rig, truth)
    raw = str(root / "videos")
    jsyn.render_stores(raw, "synth", rig, proj)
    jrd = jrun(JConfig(data_name="synth", results_dir=str(root / "jax"),
                       raw_data_dir=raw),
               rig, _factory(jsyn, rig, proj), render_cams=[0])
    trig = _port_rig(rig)
    cfg = PipelineConfig(data_name="synth", results_dir=str(root / "port"),
                         raw_data_dir=raw)
    trd = run_pipeline(cfg, trig, _factory(tsyn, trig, proj), render_cams=[0],
                       device="cpu", dtype=torch.float64)
    return dict(rig=trig, jrig=rig, truth=truth, proj=proj, raw=raw, jrd=jrd,
                trd=trd, cfg=cfg)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_alldata_rows_equal(runs):
    from macaque_tpu_torch.pipeline.artifacts import read_alldata

    for cam in runs["rig"].camera_ids:
        got, fg = read_alldata(os.path.join(runs["trd"], cam))
        want, fw = read_alldata(os.path.join(runs["jrd"], cam))
        assert got == want and any(got)
        np.testing.assert_array_equal(fg, fw)


def test_step2_and_step3_pickles_equal(runs):
    got = read_pickle(f"{runs['trd']}/match_keyframe.pickle")
    want = read_pickle(f"{runs['jrd']}/match_keyframe.pickle")
    assert [k["frame"] for k in got] == [k["frame"] for k in want] and got
    for a, b in zip(got, want):
        assert [x.tolist() for x in a["bcomb"]] == \
            [x.tolist() for x in b["bcomb"]]
        for p, q in zip(a["pose3d"], b["pose3d"]):
            _close(p, q, 1e-6)
    for f in ("track.pickle", "collar_id.pickle", "kp2d.pickle",
              "keyframe_connection.pickle"):
        got = read_pickle(f"{runs['trd']}/{f}")
        want = read_pickle(f"{runs['jrd']}/{f}")
        if isinstance(want, dict):
            assert list(got) == list(want)
            got, want = list(got.values()), list(want.values())
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_kp2d_f_within_1e_9(runs):
    _close(read_pickle(f"{runs['trd']}/kp2d_f.pickle"),
           read_pickle(f"{runs['jrd']}/kp2d_f.pickle"), 1e-9)


def test_kp3d_is_as_accurate_as_the_jax_packages(runs):
    got = read_pickle(f"{runs['trd']}/kp3d.pickle")["kp3d"]
    want = read_pickle(f"{runs['jrd']}/kp3d.pickle")["kp3d"]
    assert got.shape == want.shape and got.dtype == np.float64
    T = got.shape[1]                         # up to the last keyframe
    for a in range(2):
        e = [np.nanmedian(np.linalg.norm(k[a] - runs["truth"][a, :T], axis=-1))
             for k in (got, want)]
        assert e[0] < 30.0 and abs(e[0] - e[1]) < 1.0, e


def test_every_artifact_and_the_same_manifest(runs):
    names = set(os.listdir(runs["jrd"]))
    assert set(os.listdir(runs["trd"])) == names
    assert {"config.toml", "calibration.toml", "kp3d.pickle",
            "overlay_10000.mp4", "run_manifest.json"} <= names
    manifests = []
    for rd in (runs["trd"], runs["jrd"]):
        with open(os.path.join(rd, "run_manifest.json")) as f:
            manifests.append(json.load(f))
    for m in manifests:
        assert list(m) == STAGES
        assert [v["calls"] for v in m.values()] == [1] * 5
        assert all(v["total_s"] >= 0 for v in m.values())


def _decoded(path):
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        frames.append(img)
    cap.release()
    return frames


def test_overlay_frames_equal_the_jax_packages(runs, tmp_path):
    """The port's overlay has the JAX overlay's frames in number and size;
    drawn from the same ``kp3d.pickle`` (the JAX run's) they are equal
    frame for frame: the two runs' kp3d part by the refinement's rounding,
    which moves a skeleton by a fraction of a pixel."""
    from macaque_tpu_torch.tools.visualize import render_overlay

    want = _decoded(os.path.join(runs["jrd"], "overlay_10000.mp4"))
    own = _decoded(os.path.join(runs["trd"], "overlay_10000.mp4"))
    assert len(own) == len(want) > 0
    assert own[0].shape == want[0].shape
    out = render_overlay("synth", 0, runs["jrd"], runs["raw"], runs["rig"],
                         out_path=str(tmp_path / "o.mp4"), device="cpu")
    got = _decoded(out)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # the skeletons are drawn: frames differ from the recording
    raw = _decoded(os.path.join(runs["raw"], "synth.10000", "000000.avi"))
    assert any(not np.array_equal(a, r) for a, r in zip(got, raw))


@pytest.mark.parametrize("kw", [
    {"style": "v2"},
    {"mrksize": 3, "colors": [(9, 200, 30), (250, 10, 120)], "fps": 12.0}])
def test_render_overlay_options_match_the_jax_packages(runs, tmp_path, kw):
    """Camera 1 in the second style (torso diagonals, eyes hidden), and
    with another marker size, palette and rate, from one ``kp3d.pickle``."""
    from macaque_tpu.tools.visualize import render_overlay as jrender
    from macaque_tpu_torch.tools.visualize import render_overlay

    out = {}
    for name, fn, rig, extra in (
            ("port", render_overlay, runs["rig"], {"device": "cpu"}),
            ("jax", jrender, runs["jrig"], {})):
        out[name] = fn("synth", 1, runs["jrd"], runs["raw"], rig,
                       out_path=str(tmp_path / f"{name}.mp4"), **kw, **extra)
    with open(out["port"], "rb") as a, open(out["jax"], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("i_cam", range(4))
def test_overlay_points_match_the_jax_projection(runs, i_cam):
    """The reprojection of ``macaque_tpu/tools/visualize.py:100-130`` (in
    the JAX package's functions) against ``overlay_points``."""
    import jax
    import jax.numpy as jnp

    from macaque_tpu.cameras.omnidir import omnidir_project
    from macaque_tpu_torch.tools.visualize import overlay_points

    data = read_pickle(f"{runs['jrd']}/kp3d.pickle")
    data["kp3d_score"] = np.where(np.random.default_rng(i_cam).random(
        data["kp3d"].shape[:3]) < 0.3, 0.0, 0.8)
    proj, draw = overlay_points(data, runs["rig"], i_cam, device="cpu")

    kp3d = np.asarray(data["kp3d"])
    A, T, J, _ = kp3d.shape
    neck = (kp3d[:, :, 5] + kp3d[:, :, 6]) / 2
    kp3d_n = np.concatenate([kp3d, neck[:, :, None, :]], axis=2)
    score = data["kp3d_score"]
    score_n = np.concatenate(
        [score, ((score[:, :, 5] + score[:, :, 6]) / 2)[:, :, None]], axis=2)
    with np.errstate(invalid="ignore"):
        want_draw = np.sum(np.logical_not(kp3d_n[..., 0] == 0)
                           & (score_n > 0.0), axis=2) > 0
    sub = runs["jrig"].subset([i_cam]).omni()
    want = np.array(omnidir_project(
        jax.tree.map(lambda x: np.asarray(x)[0], sub),
        jnp.asarray(np.nan_to_num(kp3d_n.reshape(-1, 3), nan=1e8)),
    )).reshape(A, T, J + 1, 2)
    want[np.isnan(kp3d_n[..., 0])] = np.nan
    np.testing.assert_array_equal(draw, want_draw)
    _close(proj, want, 1e-6)


def test_a_second_run_skips_every_stage(runs, capsys):
    stamps = {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
              for d, _, fs in os.walk(runs["trd"]) for f in fs
              if f.endswith((".json", ".npy", ".pickle", ".toml"))
              and f != "run_manifest.json"}
    capsys.readouterr()
    run_pipeline(runs["cfg"], runs["rig"], None, render=False, device="cpu",
                 dtype=torch.float64)
    out = capsys.readouterr().out
    assert out.count("skip (exists)") == runs["rig"].n_cam + 3, out
    assert {p: os.stat(p).st_mtime_ns for p in stamps} == stamps


def test_run_pipeline_refuses_a_mesh_and_needs_a_device(tmp_path):
    rig = tsyn.make_test_rig(4)
    cfg = PipelineConfig(data_name="x", results_dir=str(tmp_path / "r"),
                         raw_data_dir=str(tmp_path / "v"))
    with pytest.raises(TypeError, match="core.mesh.Mesh"):
        run_pipeline(cfg, rig, None, mesh=object(), device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_pipeline(cfg, rig, None)
    assert not os.path.exists(tmp_path / "r")


# --------------------------------------------------------- stage timer


def test_stage_times_match_jax(tmp_path, capsys):
    from macaque_tpu.core.trace import StageTimes as JTimes
    from macaque_tpu_torch.core.trace import StageTimes

    out = {}
    for name, cls in (("port", StageTimes), ("jax", JTimes)):
        clock = iter([0.0, 1.23456, 2.0, 2.5, 3.0, 3.000049])
        timer = cls()
        with mock.patch("time.perf_counter", lambda: next(clock)):
            for stage in ("a", "b", "a"):
                with timer.stage(stage):
                    pass
        path = tmp_path / f"{name}.json"
        timer.dump(str(path))
        out[name] = (capsys.readouterr().out, timer.summary(),
                     path.read_bytes())
    assert out["port"] == out["jax"]
    assert out["port"][1] == {"a": {"total_s": 1.2346, "calls": 2},
                              "b": {"total_s": 0.5, "calls": 1}}


def test_torch_profile_writes_a_trace(tmp_path):
    from macaque_tpu_torch.core.trace import torch_profile

    with torch_profile(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


# ------------------------------------------------------- CLI and demo


class _Parser(Exception):
    pass


def _parser_of(main):
    """The ArgumentParser ``main`` builds, caught at ``parse_args``."""
    def grab(self, *a, **k):
        raise _Parser(self)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(_Parser) as got:
            main([])
    return got.value.args[0]


def _surface(parser):
    return [(a.option_strings, a.dest, a.default, a.type, a.choices,
             a.required, a.nargs, a.const) for a in parser._actions]


def _subcommands(parser):
    return next(a for a in parser._actions
                if isinstance(a, argparse._SubParsersAction)).choices


def test_cli_subcommands_are_the_jax_clis():
    from macaque_tpu.__main__ import main as jmain
    from macaque_tpu_torch.__main__ import main

    got, want = _subcommands(_parser_of(main)), _subcommands(_parser_of(jmain))
    assert list(got) == list(PORTED) == list(want) and len(PORTED) == 34
    for name in PORTED:
        surface = _surface(got[name])
        if name in WITH_DEVICE:
            assert surface[-1][:3] == (["--device"], "device", None), name
            surface = surface[:-1]
        assert surface == _surface(want[name]), name


def test_cli_validate_prints_what_jax_prints(tmp_path, capsys):
    from macaque_tpu.__main__ import main as jmain

    rng = np.random.default_rng(1)
    gt = rng.normal(0, 600, (3, 30, 17, 3))
    with open(tmp_path / "kp3d.pickle", "wb") as f:
        pickle.dump({"kp3d": gt + rng.normal(0, 150, gt.shape)}, f)
    with open(tmp_path / "gt.pickle", "wb") as f:
        pickle.dump(gt, f)
    args = ["validate", str(tmp_path / "kp3d.pickle"),
            str(tmp_path / "gt.pickle"), "--threshold", "300"]
    jmain(args)
    want = capsys.readouterr().out
    proc = subprocess.run([sys.executable, "-m", "macaque_tpu_torch"] + args,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == want and "ValidationResult(tp=" in want


def test_cli_convert_weights_without_checkpoints(tmp_path, capsys):
    """No ``.pth`` under ``--weights``: the four ``missing`` lines of the
    JAX CLI's jobs (``macaque_tpu/__main__.py:362-374``), and no cache.
    The JAX CLI itself cannot print them: the ``import os`` of its
    ``pose2d`` branch (:220) makes ``os`` local to ``main``, so every other
    branch that reads ``os`` raises ``UnboundLocalError`` (ROADMAP.md §3)."""
    from macaque_tpu.__main__ import main as jmain
    from macaque_tpu_torch.__main__ import main

    args = ["convert-weights", "--weights", str(tmp_path / "model"),
            "--cache", str(tmp_path / "cache")]
    with pytest.raises(UnboundLocalError):
        jmain(args)
    main(args)
    assert capsys.readouterr().out == "".join(
        f"missing {rel} (skipped)\n" for rel in (
            "detection/detection.pth", "pose/pose.pth",
            "id/id_finetuned.pth", "id/id_mff1y.pth"))
    assert not os.path.exists(tmp_path / "cache")


def test_cli_convert_weights_one_checkpoint(tmp_path, capsys, monkeypatch):
    """One small mmpretrain-named ResNet ``.pth`` (the two-stage ResNet of
    tests/torch_parity.py, with an unconsumed key, in mmengine's
    ``state_dict`` wrapper) as ``id/id_finetuned.pth``: converted into a
    float32 CPU module and cached as ``<cache>/id_finetuned.pt`` with its
    state dict; unconsumed keys reported; a second call loads the cache; a
    checkpoint missing a parameter raises."""
    from macaque_tpu_torch import __main__ as cli
    from macaque_tpu_torch import nn as tnn
    from macaque_tpu_torch.nn.checkpoint import load_params
    from tests.torch_parity import TTinyResNet

    def tiny():
        return tnn.ResNetClassifier(TTinyResNet(), device="cpu")

    jobs = [(rel, tiny if rel.startswith("id/") else make)
            for rel, make in cli.CONVERT_JOBS]
    monkeypatch.setattr(cli, "CONVERT_JOBS", tuple(jobs))
    torch.manual_seed(0)
    sd = tiny().state_dict()
    os.makedirs(tmp_path / "model" / "id")
    torch.save({"state_dict": {**sd, "head.extra.weight": torch.ones(2)}},
               tmp_path / "model" / "id" / "id_finetuned.pth")
    args = ["convert-weights", "--weights", str(tmp_path / "model"),
            "--cache", str(tmp_path / "cache")]
    cli.main(args)
    out = capsys.readouterr().out
    assert "converted id/id_finetuned.pth" in out
    assert "1 checkpoint keys not consumed" in out and "head.extra" in out
    assert out.count("(skipped)") == 3
    cached = load_params(str(tmp_path / "cache" / "id_finetuned.pt"))
    assert list(cached) == list(sd)
    for k in sd:
        assert cached[k].dtype == sd[k].dtype and torch.equal(cached[k], sd[k])
    stamp = os.stat(tmp_path / "cache" / "id_finetuned.pt").st_mtime_ns
    cli.main(args)
    assert "not consumed" not in capsys.readouterr().out      # the cache
    assert os.stat(tmp_path / "cache" / "id_finetuned.pt").st_mtime_ns == stamp
    del sd["head.fc.weight"]
    torch.save(sd, tmp_path / "model" / "id" / "id_mff1y.pth")
    with pytest.raises(KeyError, match="missing"):
        cli.main(args)


def _run_demo_arguments():
    """(flags, default) of every ``add_argument`` in run_demo.py."""
    with open(os.path.join(ROOT, "run_demo.py")) as f:
        tree = ast.parse(f.read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "add_argument":
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if k.arg in ("default", "action")}
            out.append((node.args[0].value, kw.get("default",
                        False if kw.get("action") == "store_true" else None)))
    return out


def test_demo_entry_signatures_match_run_demo():
    """``proc`` keeps the reference-compatible signature and
    ``run_synthetic`` run_demo.py's, with ``device`` last; the argparse
    surface is run_demo.py's and ``--device``
    (tests/test_runner.py::test_demo_entry_signatures_match_reference)."""
    import importlib.util

    from macaque_tpu_torch import demo

    spec = importlib.util.spec_from_file_location(
        "run_demo", os.path.join(ROOT, "run_demo.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for fn in ("proc", "run_synthetic"):
        want = inspect.signature(getattr(ref, fn)).parameters
        got = inspect.signature(getattr(demo, fn)).parameters
        extra = ["device"] if fn == "run_synthetic" else []
        assert list(got) == list(want) + extra, fn
        for k in want:
            assert got[k].default == want[k].default, (fn, k)
    got = [(a.option_strings[0], a.default) for a in demo.parser()._actions
           if a.option_strings and a.dest != "help"]
    assert got == _run_demo_arguments() + [("--device", None)]


def test_demo_runs_the_pipeline_on_the_cpu(tmp_path, capsys):
    from macaque_tpu_torch import demo

    rd = demo.main(["--synthetic", "--root", str(tmp_path), "--frames", "36",
                    "--no-render", "--device", "cpu"])
    out = capsys.readouterr().out
    errs = [float(line.split("error ")[1].split(" mm")[0])
            for line in out.splitlines() if "median 3D error" in line]
    assert len(errs) == 2 and max(errs) < 30.0, out
    assert os.path.exists(os.path.join(rd, "run_manifest.json"))
    assert not os.path.exists(os.path.join(rd, "overlay_10000.mp4"))
