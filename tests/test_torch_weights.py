"""Checkpoint loading and device choice of the port's entry points."""

import pytest
import torch

from macaque_tpu_torch import nn as tnn
from macaque_tpu_torch.core.device import resolve_device
from macaque_tpu_torch.pipeline.perception import TorchPerception
from macaque_tpu_torch.pipeline.weights import load_checkpoint
from tests.torch_parity import VIT


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
