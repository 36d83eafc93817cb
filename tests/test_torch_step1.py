"""Stage 1 end to end: the port's ``process_camera`` with ``TorchPerception``
against the JAX package's with ``FlaxPerception``, on one tiny synthetic
imgstore with the same small-width weights (detector, ViTPose, ResNet),
float32 on the CPU. The ``alldata.json`` rows must agree, at the parity
configuration and in the fast serving tier (serving detector budgets, a
smaller detector input, the int8 pose without the flip test)."""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

from macaque_tpu import nn as jnn
from macaque_tpu.core.config import Step1Config as JStep1Config
from macaque_tpu.nn.quant import quantize_vitpose_params
from macaque_tpu.nn.swin import SwinConfig as JSwinConfig
from macaque_tpu.pipeline.perception import FlaxPerception
from macaque_tpu.pipeline.step1 import process_camera as jax_process_camera
from macaque_tpu.video.imgstore import ImgStoreReader as JReader
from macaque_tpu.video.imgstore import write_imgstore
from macaque_tpu.video.timegrid import make_time_grid
from macaque_tpu_torch import nn as tnn
from macaque_tpu_torch.core.config import Step1Config
from macaque_tpu_torch.nn.convert import (
    resnet_from_jax, swin_maskrcnn_from_jax, vitpose_from_jax)
from macaque_tpu_torch.nn.swin import SwinConfig as TSwinConfig
from macaque_tpu_torch.pipeline.perception import TorchPerception
from macaque_tpu_torch.pipeline.step1 import process_camera, run_step1
from macaque_tpu_torch.pipeline.weights import serving_tier
from macaque_tpu_torch.video.imgstore import ImgStoreReader
from tests.torch_parity import (
    DET, SWIN, JTinyResNet, TTinyResNet, VIT, jax_detector, load,
    random_variables, tiny_perceptions)

H, W, N_FRAMES, MAX_DET = 96, 128, 6, 4


def _frames(seed=0):
    """A textured cage and three bright blobs drifting a few pixels a
    frame (BGR uint8)."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.integers(40, 200, (H // 8, W // 8, 3)),
                   np.ones((8, 8, 1))).astype(np.uint8)
    yy, xx = np.mgrid[0:H, 0:W]
    frames = []
    for t in range(N_FRAMES):
        f = base.copy()
        for k, (cy, cx) in enumerate([(30, 30), (60, 80), (40, 100)]):
            m = ((yy - cy) / 14.0) ** 2 + ((xx - cx - t) / 10.0) ** 2 < 1
            f[m] = (220 - 60 * k, 200, 40 + 60 * k)
        frames.append(f)
    return np.stack(frames)


def _variables():
    """Detector, ViTPose and ResNet variables at small width. Random
    box-head weights score nothing near the 0.85 threshold: a raised
    foreground bias lets detections through, the scores still vary with the
    RoI features (tie-free). Zero box regressions keep the boxes on the
    anchors, so the static scene gives tracks that persist."""
    dvars = random_variables(jax_detector(), jnp.zeros((1, H, W, 3), jnp.float32),
                             seed=10)
    prm = dvars["params"]
    prm["bbox_head"]["cls"]["bias"] = prm["bbox_head"]["cls"]["bias"].at[0].add(6.0)
    for reg in (prm["rpn"]["reg"], prm["bbox_head"]["reg"]):
        for k in reg:
            reg[k] = jnp.zeros_like(reg[k])
    pvars = random_variables(jnn.ViTPose(jnn.VitPoseConfig(**VIT)),
                             jnp.zeros((1, 64, 48, 3), jnp.float32), seed=11)
    ivars = random_variables(jnn.ResNetClassifier(JTinyResNet()),
                             jnp.zeros((1, 224, 224, 3), jnp.float32), seed=12)
    return dvars, pvars, ivars


def _run_both(root, flax, port):
    """process_camera of both packages on one store; their alldata.json rows
    and frame numbers, and the port's stage times."""
    store = write_imgstore(str(root / "demo.cam0"), _frames(), fourcc="FFV1")
    T = make_time_grid(JReader(store).get_frame_metadata()["frame_time"], 24.0)
    jax_process_camera(JReader(store), str(root / "jax"), T, flax,
                       JStep1Config(), chunk=4, prefetch=False)
    stages = process_camera(ImgStoreReader(store), str(root / "torch"), T,
                            port, Step1Config(), chunk=4, prefetch=False)
    out = {}
    for name in ("jax", "torch"):
        with open(root / name / "alldata.json") as f:
            out[name] = (json.load(f), np.load(root / name / "frame_num.npy"))
    return out, stages


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("step1")
    flax, port = tiny_perceptions(*_variables(), max_det=MAX_DET,
                                  det_target=W)
    out, stages = _run_both(root, flax, port)
    return out, stages, port, root


def _assert_rows_equal(out, int8=False):
    """Same frames, same tracks and ID decisions; boxes to float32 noise
    (the tracker's integer boxes); keypoint scores to 1e-4, with the same
    joints below the keypoint threshold (NaN); keypoints to 0.1 px: DARK's
    Newton step divides by the blurred log-heatmap's Hessian, which turns
    float32 noise into ~1e-3 heatmap px where the map is flat, and one
    heatmap px spans several image px (0.04 px seen at most).

    With the int8 pose (``int8``), float32 noise upstream of a layer can
    move an activation across a rounding boundary of its int8 code; the
    flipped code changes its layer's output by one quantization step (up to
    1/127 of the row's maximum), which flips further codes downstream
    (test_torch_int8.py counts them). The heatmaps then differ by up to
    2^-6 of their range, so keypoint scores are held to 2^-6; on these
    random-weight heatmaps, with several near-equal local maxima, a peak can
    move to another maximum, so keypoints are held to 0.5 px (about half a
    heatmap px at these box sizes: the same peak) for at least 90% of the
    visible joints (95% seen; the rest moved up to 3.6 px)."""
    (rows_j, fn_j), (rows_t, fn_t) = out["jax"], out["torch"]
    np.testing.assert_array_equal(fn_t, fn_j)
    assert len(rows_t) == len(rows_j)
    assert sum(len(r) for r in rows_j) > 0          # animals were tracked
    moved = []
    for rt, rj in zip(rows_t, rows_j):
        assert len(rt) == len(rj)
        for et, ej in zip(rt, rj):
            assert et[0] == ej[0] and et[6] == ej[6]        # track id, ID
            np.testing.assert_allclose(et[1:5], ej[1:5], atol=1e-3)
            kt, kj = np.asarray(et[5], float), np.asarray(ej[5], float)
            np.testing.assert_array_equal(np.isnan(kt), np.isnan(kj))
            np.testing.assert_allclose(kt[:, 2], kj[:, 2],
                                       atol=2.0 ** -6 if int8 else 1e-4)
            np.testing.assert_allclose(et[7], ej[7], atol=1e-4)
            seen = ~np.isnan(kt[:, 0])
            if not int8:
                np.testing.assert_allclose(kt[:, :2], kj[:, :2], atol=0.1)
            moved += list(np.abs(kt[seen, :2] - kj[seen, :2]).max(-1))
    if int8:
        assert np.mean(np.asarray(moved) <= 0.5) >= 0.9, sorted(moved)[-10:]


def test_alldata_rows_equal(runs):
    _assert_rows_equal(runs[0])


@pytest.fixture(scope="module")
def fast_runs(tmp_path_factory):
    """The fast serving tier on both sides: the serving detector budgets
    (512 proposals, 128 RoIs in 64-RoI chunks) at 0.8 of the parity input
    target (640 against 800 at full size), the int8 pose tree of
    ``quantize_vitpose_params``, one pose pass without the flip test."""
    root = tmp_path_factory.mktemp("step1_fast")
    tier = serving_tier(fast=True, det_target=int(0.8 * W))
    assert tier.int8 and tier.serving and not tier.flip_test
    dvars, pvars, ivars = _variables()
    qvars = quantize_vitpose_params(pvars)
    det_kw = dict(fpn_channels=DET["fpn_channels"], rcnn_max=DET["rcnn_max"])
    jdet = jnn.SwinMaskRCNN(jnn.DetectorConfig.serving(
        swin=JSwinConfig(**SWIN), **det_kw))
    flax = FlaxPerception(
        jdet, dvars, jnn.ViTPose(jnn.VitPoseConfig(**VIT, quantize="int8")),
        qvars, jnn.ResNetClassifier(JTinyResNet()), ivars, max_det=MAX_DET,
        flip_test=tier.flip_test, det_target=tier.det_target)
    port = TorchPerception(
        load(tnn.SwinMaskRCNN(tnn.DetectorConfig.serving(
            swin=TSwinConfig(**SWIN), **det_kw), device="cpu"),
            swin_maskrcnn_from_jax(dvars)),
        load(tnn.ViTPose(tnn.VitPoseConfig(**VIT, quantize="int8"),
                         device="cpu"), vitpose_from_jax(qvars)),
        load(tnn.ResNetClassifier(TTinyResNet(), device="cpu"),
             resnet_from_jax(ivars)),
        max_det=MAX_DET, det_target=tier.det_target, device="cpu",
        flip_test=tier.flip_test)
    return _run_both(root, flax, port)[0]


def test_fast_tier_alldata_rows_equal(fast_runs):
    """The fast tier's rows agree: exactly as the parity rows upstream of
    pose, to the int8 tolerances in pose."""
    _assert_rows_equal(fast_runs, int8=True)


def test_stage_times_reported(runs):
    """The record holds the camera loop's five stage seconds, beside the
    spans and counters of the calls inside them."""
    stages = runs[1]
    assert {"decode", "detect", "track", "pose+id", "assemble"} <= set(stages)
    assert {"detector.trunk", "perception.upload_bytes"} <= set(stages)
    assert all(v >= 0 for v in stages.values())


def test_device_tracker_not_ported(runs, tmp_path):
    """The on-device tracker, once refused here, is ported: on the same
    store and perception (its table on the perception's CPU) it writes the
    host tracker's rows, this scene's three static animals tracked alike.
    Its parity with the JAX package's device tracker is in
    test_torch_device_tracker.py."""
    out, _, port, root = runs
    T = make_time_grid(JReader(str(root / "demo.cam0")).get_frame_metadata()[
        "frame_time"], 24.0)
    process_camera(ImgStoreReader(str(root / "demo.cam0")), str(tmp_path), T,
                   port, Step1Config(), chunk=4, prefetch=False,
                   use_device_tracker=True)
    with open(tmp_path / "alldata.json") as f:
        rows = json.load(f)
    np.testing.assert_array_equal(np.load(tmp_path / "frame_num.npy"),
                                  out["torch"][1])
    assert rows == out["torch"][0]


def test_skips_finished_camera(runs, tmp_path):
    out = tmp_path / "cam"
    os.makedirs(out)
    for name in ("alldata.json", "frame_num.npy"):
        (out / name).write_text("")
    assert process_camera(None, str(out), np.zeros(1), None) is None


def test_run_step1_matches_process_camera(runs):
    """The recording-level entry finds the store by name and writes the
    same rows as process_camera did for it."""
    out, _, port, root = runs
    dirs = run_step1("demo", str(root / "results"), str(root), port, chunk=4,
                     prefetch=False)
    assert dirs == [str(root / "results" / "demo" / "cam0")]
    with open(os.path.join(dirs[0], "alldata.json")) as f:
        assert json.load(f) == out["torch"][0]
    with pytest.raises(FileNotFoundError):
        run_step1("absent", str(root / "results"), str(root), port)
