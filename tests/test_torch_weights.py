"""Checkpoint loading, serving-tier selection and device choice of the
port's entry points."""

import dataclasses
import os

import pytest
import torch

from macaque_tpu_torch import nn as tnn
from macaque_tpu_torch.core.device import resolve_device
from macaque_tpu_torch.nn.convert import (
    swin_backbone_from_jax, swin_maskrcnn_from_jax)
from macaque_tpu_torch.nn.quant import Int8Linear, quantize_dense
from macaque_tpu_torch.nn.swin import SwinBackbone, SwinConfig
from macaque_tpu_torch.pipeline.perception import TorchPerception
from macaque_tpu_torch.pipeline.weights import (
    ServingTier, build_torch_perception, load_checkpoint, serving_tier)
from tests.torch_parity import (
    DET, SWIN, TTinyResNet, VIT, jax_detector, random_variables, torch_detector)

TIER_ENV = ("MACAQUE_TPU_INT8", "MACAQUE_TPU_SERVING", "MACAQUE_TPU_FAST",
            "MACAQUE_TPU_DET_TARGET")


def _pose():
    return tnn.ViTPose(tnn.VitPoseConfig(**VIT), device="cpu")


@pytest.mark.parametrize("wrapped", [False, True])
def test_load_checkpoint_reads_mmengine_and_bare_files(tmp_path, wrapped):
    """A released checkpoint: mmengine's {'state_dict': ...} wrapper or a
    bare dict, buffers the module recomputes, and a cls-token slot in
    pos_embed."""
    src = _pose()
    sd = dict(src.state_dict())
    pos = sd["backbone.pos_embed"]
    sd["backbone.pos_embed"] = torch.cat([torch.zeros_like(pos[:, :1]), pos], 1)
    sd["backbone.layers.0.attn.relative_position_index"] = torch.zeros(3)
    path = tmp_path / "pose.pth"
    torch.save({"state_dict": sd, "meta": {"epoch": 210}} if wrapped else sd,
               path)
    dst = _pose()
    load_checkpoint(dst, str(path))
    for k, v in src.state_dict().items():
        torch.testing.assert_close(dst.state_dict()[k], v, rtol=0, atol=0)


def test_load_checkpoint_refuses_missing_parameters(tmp_path):
    sd = dict(_pose().state_dict())
    del sd["backbone.layers.1.attn.qkv.weight"]
    torch.save(sd, tmp_path / "pose.pth")
    with pytest.raises(KeyError):
        load_checkpoint(_pose(), str(tmp_path / "pose.pth"))


def test_entry_points_need_a_card_unless_told_cpu():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        TorchPerception(None, None, None)


def test_detector_serving_preset():
    d, s = tnn.DetectorConfig(), tnn.DetectorConfig.serving(rcnn_max=50)
    assert d.rcnn_roi_topk >= d.rpn_max          # default: no truncation
    assert (s.rpn_max, s.rcnn_roi_topk, s.rcnn_roi_chunk, s.rcnn_max) == (
        512, 128, 64, 50)


# (environment, keyword arguments) -> tier, as build_flax_perception reads them
TIERS = [
    ({}, {}, ServingTier(False, False, True, 800)),
    ({"MACAQUE_TPU_INT8": "1"}, {}, ServingTier(True, False, True, 800)),
    ({"MACAQUE_TPU_SERVING": "1"}, {}, ServingTier(True, True, True, 800)),
    ({"MACAQUE_TPU_FAST": "1"}, {}, ServingTier(True, True, False, 640)),
    ({"MACAQUE_TPU_FAST": "1", "MACAQUE_TPU_DET_TARGET": "704"}, {},
     ServingTier(True, True, False, 704)),
    ({"MACAQUE_TPU_DET_TARGET": "512"}, {}, ServingTier(False, False, True, 512)),
    ({}, {"int8": True}, ServingTier(True, False, True, 800)),
    ({}, {"fast": True, "det_target": 320}, ServingTier(True, True, False, 320)),
    ({"MACAQUE_TPU_FAST": "1"}, {"fast": False},
     ServingTier(False, False, True, 800)),
    ({"MACAQUE_TPU_SERVING": "1"}, {"serving": False, "int8": False},
     ServingTier(False, False, True, 800)),
]


@pytest.mark.parametrize("env,kw,want", TIERS)
def test_serving_tier_selection(monkeypatch, env, kw, want):
    """The JAX package's switches: serving implies int8, fast implies
    serving and drops the flip test and the detector target to 640; a
    keyword argument overrides its variable."""
    for k in TIER_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert serving_tier(**kw) == want


@pytest.fixture
def small_checkpoints(tmp_path, monkeypatch):
    """Checkpoints of small-width models under the released file names, and
    build_torch_perception's model classes swapped for those widths."""
    real = tnn.SwinMaskRCNN, tnn.ViTPose, tnn.ResNetClassifier
    monkeypatch.setattr(tnn, "SwinMaskRCNN", lambda cfg, device=None: real[0](
        dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, **SWIN),
                            fpn_channels=DET["fpn_channels"]), device=device))
    monkeypatch.setattr(tnn, "ViTPose", lambda cfg, device=None: real[1](
        dataclasses.replace(cfg, **VIT), device=device))
    monkeypatch.setattr(tnn, "ResNetClassifier", lambda cfg, device=None: real[2](
        TTinyResNet(compute_dtype=cfg.compute_dtype), device=device))
    torch.manual_seed(0)
    models = {"detection/detection.pth": tnn.SwinMaskRCNN(tnn.DetectorConfig()),
              "pose/pose.pth": tnn.ViTPose(tnn.VitPoseConfig()),
              "id/id_finetuned.pth": tnn.ResNetClassifier(tnn.ResNetConfig())}
    sds = {}
    for name, m in models.items():
        os.makedirs(tmp_path / os.path.dirname(name), exist_ok=True)
        sds[name] = {k: v.clone() for k, v in m.state_dict().items()}
        torch.save({"state_dict": sds[name]}, tmp_path / name)
    for k in TIER_ENV:
        monkeypatch.delenv(k, raising=False)
    return str(tmp_path), sds["pose/pose.pth"]


def test_build_torch_perception_parity_tier(small_checkpoints):
    root, _ = small_checkpoints
    p = build_torch_perception(root, device="cpu")
    assert p.flip_test and p.det_target == 800
    assert p.detector_model.cfg == tnn.DetectorConfig(
        swin=SwinConfig(**SWIN), fpn_channels=DET["fpn_channels"])
    assert not any(isinstance(m, Int8Linear) for m in p.pose_model.modules())


def test_build_torch_perception_fast_tier(small_checkpoints, monkeypatch):
    """MACAQUE_TPU_FAST=1: serving detector budgets, 640 target, no flip
    test, and every ViT block Dense quantized from the float32 checkpoint
    (not from the model's compute-dtype copy)."""
    root, pose_sd = small_checkpoints
    monkeypatch.setenv("MACAQUE_TPU_FAST", "1")
    p = build_torch_perception(root, device="cpu")
    assert not p.flip_test and p.det_target == 640
    cfg = p.detector_model.cfg
    assert (cfg.rpn_max, cfg.rcnn_roi_topk, cfg.rcnn_roi_chunk) == (512, 128, 64)
    assert p.pose_model.cfg.quantize == "int8"
    layers = {n: m for n, m in p.pose_model.named_modules()
              if isinstance(m, Int8Linear)}
    assert len(layers) == 4 * VIT["depth"]
    for name, m in layers.items():
        wq, ws = quantize_dense(pose_sd[f"{name}.weight"])
        torch.testing.assert_close(m.weight_q, wq, rtol=0, atol=0)
        torch.testing.assert_close(m.wscale, ws, rtol=0, atol=0)
        torch.testing.assert_close(m.bias, pose_sd[f"{name}.bias"], rtol=0, atol=0)


def test_swin_converters_share_the_backbone():
    """The detector converter's backbone keys are the bare-backbone
    converter's under ``backbone.``; each state dict loads strictly into its
    model, and the bare backbone equals the detector's."""
    import jax.numpy as jnp
    import numpy as np

    v = random_variables(jax_detector(), jnp.zeros((1, 128, 96, 3), jnp.float32),
                         seed=8)
    det_sd = swin_maskrcnn_from_jax(v)
    bare_sd = swin_backbone_from_jax(v["params"]["backbone"])
    prefixed = swin_backbone_from_jax(v["params"]["backbone"], "backbone.")
    assert list(det_sd)[:len(prefixed)] == list(prefixed)
    assert list(prefixed) == [f"backbone.{k}" for k in bare_sd]
    for k, t in prefixed.items():
        torch.testing.assert_close(det_sd[k], t, rtol=0, atol=0)
    det = torch_detector()
    det.load_state_dict(det_sd, strict=True)
    bb = SwinBackbone(SwinConfig(**SWIN), device="cpu")
    bb.load_state_dict(bare_sd, strict=True)
    img = torch.from_numpy(np.random.default_rng(8).normal(
        size=(1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        for a, b in zip(bb(img), det.backbone(img)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
