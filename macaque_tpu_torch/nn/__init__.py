"""PyTorch models of stage 1: Swin-S Mask R-CNN, ViTPose, ResNet-152."""

from macaque_tpu_torch.nn.detector import DetectorConfig, SwinMaskRCNN
from macaque_tpu_torch.nn.resnet import ResNetClassifier, ResNetConfig
from macaque_tpu_torch.nn.vit import ViTPose, VitPoseConfig

__all__ = ["DetectorConfig", "SwinMaskRCNN", "ResNetClassifier",
           "ResNetConfig", "ViTPose", "VitPoseConfig"]
