"""PyTorch models of stage 1: Swin-S Mask R-CNN, ViTPose, ResNet-152; their
training mode (``layers.make_trainable``), trainers (``train``, with the
optax chains of ``optim``) and checkpoints (``checkpoint``)."""

from macaque_tpu_torch.nn.checkpoint import (
    convert_and_cache, load_params, save_params)
from macaque_tpu_torch.nn.detector import DetectorConfig, SwinMaskRCNN
from macaque_tpu_torch.nn.layers import make_trainable
from macaque_tpu_torch.nn.resnet import ResNetClassifier, ResNetConfig
from macaque_tpu_torch.nn.vit import ViTPose, VitPoseConfig

__all__ = ["DetectorConfig", "SwinMaskRCNN", "ResNetClassifier",
           "ResNetConfig", "ViTPose", "VitPoseConfig", "make_trainable",
           "save_params", "load_params", "convert_and_cache"]
