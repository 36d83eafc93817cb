"""The port's networks against the JAX package's, with the same weights
(Flax variables drawn with numpy, carried over by ``nn.convert``) and the
same numpy inputs, float32 on both sides: ViTPose (depth 2, width 64,
4 heads), ResNet, the Swin backbone, and the whole detector."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from macaque_tpu import nn as jnn
from macaque_tpu.nn.detector import detect_frames as jax_detect_frames
from macaque_tpu_torch import nn as tnn
from macaque_tpu_torch.nn.convert import (
    resnet_from_jax, swin_maskrcnn_from_jax, vitpose_from_jax)
from macaque_tpu_torch.nn.detector import detect_frames
from tests.torch_parity import (
    JTinyResNet, TTinyResNet, VIT, jax_detector, load, random_variables,
    torch_detector)


def test_vitpose_matches_jax():
    jm = jnn.ViTPose(jnn.VitPoseConfig(**VIT))
    x = np.random.default_rng(0).normal(size=(3, 64, 48, 3)).astype(np.float32)
    v = random_variables(jm, jnp.asarray(x), seed=0)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = load(tnn.ViTPose(tnn.VitPoseConfig(**VIT), device="cpu"),
              vitpose_from_jax(v))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 16, 12, 17)
    # float32, erf GELU on both sides: summation order only
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_vitpose_loads_checkpoint_with_cls_slot():
    """mmpose checkpoints may carry a cls-token slot in pos_embed; the
    backbone drops it on load, as the JAX converter does."""
    tm = tnn.ViTPose(tnn.VitPoseConfig(**VIT), device="cpu")
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    pos = sd["backbone.pos_embed"]
    sd["backbone.pos_embed"] = torch.cat([torch.full_like(pos[:, :1], 7.0),
                                          pos + 1.0], 1)
    tm.load_state_dict(sd)
    torch.testing.assert_close(tm.backbone.pos_embed, pos + 1.0)


def test_resnet_matches_jax():
    jm = jnn.ResNetClassifier(JTinyResNet())
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(np.float32)
    v = random_variables(jm, jnp.asarray(x), seed=1)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = load(tnn.ResNetClassifier(TTinyResNet(), device="cpu"),
              resnet_from_jax(v))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def detectors():
    """Both detectors with the same weights, on two 128x96 images."""
    img = np.random.default_rng(2).normal(size=(2, 128, 96, 3)).astype(
        np.float32)
    jm = jax_detector()
    v = random_variables(jm, jnp.asarray(img[:1]), seed=2)
    tm = load(torch_detector(), swin_maskrcnn_from_jax(v))
    return jm, v, tm, img


def test_swin_backbone_matches_jax(detectors):
    jm, v, tm, img = detectors
    want = jax.jit(lambda v, x: jm.apply(v, x, method=lambda m, y: m.backbone(y)))(
        v, jnp.asarray(img))
    with torch.no_grad():
        got = tm.backbone(torch.from_numpy(img))
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=1e-4)


def test_detector_trunk_matches_jax(detectors):
    jm, v, tm, img = detectors
    fpn_j, rpn_j = jax.jit(lambda v, x: jm.apply(v, x, method="trunk"))(
        v, jnp.asarray(img))
    with torch.no_grad():
        fpn_t, rpn_t = tm.trunk(torch.from_numpy(img))
    for g, w in zip(fpn_t, fpn_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=1e-4)
    for (gc, gr), (wc, wr) in zip(rpn_t, rpn_j):
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=2e-4)
        np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=2e-4)


def test_detect_frames_matches_jax(detectors):
    """The whole detector, through the bucket-sorted chunked RoIAlign
    (50 RoIs in 16-RoI chunks) on the port's side and the fixed-window
    chunks on the JAX package's: the same detections. Random weights give
    tie-free scores; boxes agree to float32 noise of the image coords."""
    jm, v, tm, img = detectors
    bj, sj, vj = (np.asarray(t) for t in jax_detect_frames(jm, v,
                                                           jnp.asarray(img)))
    with torch.no_grad():
        bt, st, vt = (t.numpy() for t in detect_frames(tm, torch.from_numpy(img)))
    assert vt.shape == (2, 10) and vt.any()
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(st, sj, atol=1e-5)
    np.testing.assert_allclose(bt, bj, atol=5e-3)


def test_detector_single_chunk_path(detectors):
    """With all RoIs in one chunk (one fixed 48 px window call) the port
    gives the same detections as through the bucketed chunks."""
    jm, v, tm, img = detectors
    whole = load(torch_detector(rcnn_roi_chunk=256), tm.state_dict())
    with torch.no_grad():
        b0, s0, v0 = detect_frames(tm, torch.from_numpy(img))
        b1, s1, v1 = detect_frames(whole, torch.from_numpy(img))
    torch.testing.assert_close(v1, v0)
    torch.testing.assert_close(s1, s0, atol=1e-5, rtol=0)
    torch.testing.assert_close(b1, b0, atol=1e-3, rtol=0)
