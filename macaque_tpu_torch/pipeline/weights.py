"""Checkpoint loading for the stage-1 perception stack.

``build_torch_perception`` reads the released OpenMMLab checkpoints
(``detection/detection.pth``, ``pose/pose.pth``, ``id/id_finetuned.pth``
under ``weights_dir``) straight into the PyTorch models, whose module
names are mmdet/mmpose/mmpretrain's, and wraps them in a
:class:`~macaque_tpu_torch.pipeline.perception.TorchPerception`. On the
card the models compute in bfloat16 (norm statistics, heads and box
coordinates in float32), on the CPU in float32, as the JAX package does on
its accelerator and on the CPU.

Serving tiers (``macaque_tpu/pipeline/weights.py``; default = exact mmdet
parity), from keyword arguments or, where those are left None, the same
environment variables as the JAX package:
  * ``int8`` / ``MACAQUE_TPU_INT8=1``: int8 ViT pose blocks (``nn/quant.py``);
  * ``serving`` / ``MACAQUE_TPU_SERVING=1``: the 512/128 RPN-RoI detector
    budgets (``DetectorConfig.serving()``) and int8 pose;
  * ``fast`` / ``MACAQUE_TPU_FAST=1``: the serving detector at a 640 input
    target and a single-pass (no flip test) int8 pose;
  * ``det_target`` / ``MACAQUE_TPU_DET_TARGET``: the detector's keep-ratio
    input target (800, or 640 in the fast tier).
The int8 pose is quantized from the float32 checkpoint (``quantize_vitpose_``),
as the JAX package quantizes its float32 parameters.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from macaque_tpu_torch.core.device import resolve_device

# checkpoint entries no module consumes: recomputed buffers, training-only
# state, heads the bbox-only config leaves out
_IGNORABLE_PATTERNS = (
    "relative_position_index", "attn_mask", "mask_head", "ema_",
    "data_preprocessor",
)


def load_checkpoint(model: torch.nn.Module, path: str, ckpt=None) -> dict:
    """Load a .pth (mmengine's ``{'state_dict': ...}`` wrapper or a bare
    state dict) into ``model``; every parameter must be present, and the
    checkpoint keys no parameter consumed are reported. ``ckpt``, if given,
    is the file's contents already read. Returns the state dict that was
    loaded."""
    if ckpt is None:
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
    return sd


@dataclass(frozen=True)
class ServingTier:
    int8: bool
    serving: bool
    flip_test: bool
    det_target: int


def serving_tier(int8=None, serving=None, fast=None,
                 det_target=None) -> ServingTier:
    """The tier the arguments select; an argument left None reads its
    environment variable, as ``build_flax_perception`` reads them."""
    def env(name):
        return os.environ.get(name, "0") == "1"

    fast = env("MACAQUE_TPU_FAST") if fast is None else fast
    serving = (env("MACAQUE_TPU_SERVING") if serving is None else serving) or fast
    int8 = (env("MACAQUE_TPU_INT8") if int8 is None else int8) or serving
    if det_target is None:
        det_target = int(os.environ.get("MACAQUE_TPU_DET_TARGET",
                                        640 if fast else 800))
    return ServingTier(int8, serving, not fast, det_target)


def build_detector(kind: str = "swin", device=None, dtype=None, *,
                   serving: bool = False, config=None, vit=None):
    """The detector ``kind`` in inference mode on ``device``: "swin", the
    reference's Swin-S Mask R-CNN, or "vitdet", ViTDet-H
    (``nn/vitdet.py``, K7 for its attention on the card). ``dtype``
    defaults to bf16 on the card and float32 on the CPU; ``config`` (a
    ``DetectorConfig``: budgets, head widths, a Swin backbone) defaults to
    mmdet's test budgets, or the serving tier's with ``serving``; ``vit``
    (a ``ViTDetConfig``) to ViTDet-H's widths."""
    from macaque_tpu_torch.nn import DetectorConfig, SwinMaskRCNN
    from macaque_tpu_torch.nn.swin import SwinConfig
    from macaque_tpu_torch.nn.vitdet import ViTDetConfig, ViTDetMaskRCNN

    if kind not in ("swin", "vitdet"):
        raise ValueError(f"no detector {kind!r}; 'swin' or 'vitdet'")
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if config is None:
        kw = dict(swin=SwinConfig(compute_dtype=dtype), compute_dtype=dtype)
        config = DetectorConfig.serving(**kw) if serving else DetectorConfig(**kw)
    if kind == "swin":
        return SwinMaskRCNN(config, device=device)
    if vit is None:
        vit = ViTDetConfig(compute_dtype=dtype, use_pallas_attention=device.type == "cuda")
    return ViTDetMaskRCNN(config, vit, device=device)


def build_torch_perception(weights_dir: str, device=None, *, int8=None,
                           serving=None, fast=None, det_target=None):
    """The three models from their checkpoints, in the serving tier the
    arguments (or the environment) select, wrapped in a TorchPerception."""
    from macaque_tpu_torch.nn import (
        ResNetClassifier, ResNetConfig, ViTPose, VitPoseConfig)
    from macaque_tpu_torch.nn.quant import quantize_vitpose_
    from macaque_tpu_torch.pipeline.perception import TorchPerception

    device = resolve_device(device)
    tier = serving_tier(int8, serving, fast, det_target)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    det = build_detector("swin", device, dtype, serving=tier.serving)
    # the packed attention kernel on the card, as the JAX package sets its
    # Pallas kernel on the TPU
    pose = ViTPose(VitPoseConfig(compute_dtype=dtype,
                                 use_pallas_attention=device.type == "cuda"),
                   device=device)
    idm = ResNetClassifier(ResNetConfig(compute_dtype=dtype), device=device)
    load_checkpoint(det, os.path.join(weights_dir, "detection/detection.pth"))
    pose_sd = load_checkpoint(pose, os.path.join(weights_dir, "pose/pose.pth"))
    if tier.int8:
        quantize_vitpose_(pose, pose_sd)
    load_checkpoint(idm, os.path.join(weights_dir, "id/id_finetuned.pth"))
    return TorchPerception(det, pose, idm, det_target=tier.det_target,
                           device=device, flip_test=tier.flip_test)
