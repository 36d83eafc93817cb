"""Checkpoint loading for the stage-1 perception stack.

``build_torch_perception`` reads the released OpenMMLab checkpoints
(``detection/detection.pth``, ``pose/pose.pth``, ``id/id_finetuned.pth``
under ``weights_dir``) straight into the PyTorch models, whose module
names are mmdet/mmpose/mmpretrain's, and wraps them in a
:class:`~macaque_tpu_torch.pipeline.perception.TorchPerception`. On the
card the models compute in bfloat16 (norm statistics, heads and box
coordinates in float32), on the CPU in float32, as the JAX package does on
its accelerator and on the CPU.
"""

from __future__ import annotations

import os

import torch

from macaque_tpu_torch.core.device import resolve_device

# checkpoint entries no module consumes: recomputed buffers, training-only
# state, heads the bbox-only config leaves out
_IGNORABLE_PATTERNS = (
    "relative_position_index", "attn_mask", "mask_head", "ema_",
    "data_preprocessor",
)


def load_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load a .pth (mmengine's ``{'state_dict': ...}`` wrapper or a bare
    state dict) into ``model``; every parameter must be present."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v for k, v in sd.items()
          if not any(p in k for p in _IGNORABLE_PATTERNS)}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"{path}: {len(missing)} parameters missing, e.g. "
                       f"{missing[:5]}")
    if unexpected:
        print(f"[weights] {path}: {len(unexpected)} checkpoint keys not "
              f"consumed, e.g. {unexpected[:5]}")


def build_torch_perception(weights_dir: str, device=None):
    from macaque_tpu_torch.nn import (
        DetectorConfig, ResNetClassifier, ResNetConfig, SwinMaskRCNN,
        ViTPose, VitPoseConfig)
    from macaque_tpu_torch.nn.swin import SwinConfig
    from macaque_tpu_torch.pipeline.perception import TorchPerception

    device = resolve_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    det = SwinMaskRCNN(DetectorConfig(swin=SwinConfig(compute_dtype=dtype),
                                      compute_dtype=dtype), device=device)
    pose = ViTPose(VitPoseConfig(compute_dtype=dtype), device=device)
    idm = ResNetClassifier(ResNetConfig(compute_dtype=dtype), device=device)
    load_checkpoint(det, os.path.join(weights_dir, "detection/detection.pth"))
    load_checkpoint(pose, os.path.join(weights_dir, "pose/pose.pth"))
    load_checkpoint(idm, os.path.join(weights_dir, "id/id_finetuned.pth"))
    return TorchPerception(det, pose, idm, device=device)
