"""ResNet classifier (collar-colour ID) in PyTorch.

The mmpretrain ImageClassifier of ``macaque_tpu/nn/resnet.py``: ResNet-152
(pytorch-style bottleneck, stride on the 3x3 conv), GAP neck, 6-way linear
head. Module names follow mmpretrain (``backbone.layer3.35.conv2``,
``head.fc``). Input (B, 224, 224, 3) normalized, channels-last.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from macaque_tpu_torch.nn.layers import BatchNorm2d, Conv2d, Linear


@dataclass(frozen=True)
class ResNetConfig:
    depth: int = 152
    num_classes: int = 6
    compute_dtype: Any = torch.float32

    @property
    def stage_blocks(self) -> Tuple[int, ...]:
        return {50: (3, 4, 6, 3), 101: (3, 4, 23, 3),
                152: (3, 8, 36, 3)}[self.depth]


class Bottleneck(nn.Module):
    def __init__(self, cin, channels, stride, downsample, dtype, device):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.conv1 = Conv2d(cin, channels, 1, **kw)
        self.bn1 = BatchNorm2d(channels, device=device)
        self.conv2 = Conv2d(channels, channels, 3, stride, 1, **kw)
        self.bn2 = BatchNorm2d(channels, device=device)
        self.conv3 = Conv2d(channels, channels * 4, 1, **kw)
        self.bn3 = BatchNorm2d(channels * 4, device=device)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                Conv2d(cin, channels * 4, 1, stride, **kw),
                BatchNorm2d(channels * 4, device=device))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + identity)


class ResNetBackbone(nn.Module):
    def __init__(self, cfg: ResNetConfig, device=None):
        super().__init__()
        dt = cfg.compute_dtype
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False, device=device, dtype=dt)
        self.bn1 = BatchNorm2d(64, device=device)
        cin, ch = 64, 64
        self.stages = len(cfg.stage_blocks)
        for s, blocks in enumerate(cfg.stage_blocks):
            layer = []
            for b in range(blocks):
                stride = 2 if (s > 0 and b == 0) else 1
                layer.append(Bottleneck(cin, ch, stride, b == 0, dt, device))
                cin = ch * 4
            setattr(self, f"layer{s + 1}", nn.Sequential(*layer))
            ch *= 2
        self.out_channels = cin

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for s in range(self.stages):
            x = getattr(self, f"layer{s + 1}")(x)
        return x


class ClsHead(nn.Module):
    def __init__(self, cin, num_classes, device=None):
        super().__init__()
        self.fc = Linear(cin, num_classes, device=device)

    def forward(self, x):
        return self.fc(x.mean(dim=(2, 3)))     # GAP neck, float32


class ResNetClassifier(nn.Module):
    """(B, 224, 224, 3) normalized -> logits (B, num_classes) float32.
    Built in inference mode; ``nn.layers.make_trainable`` puts it in
    training mode (BatchNorm on batch statistics)."""

    def __init__(self, cfg: ResNetConfig = ResNetConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNetBackbone(cfg, device)
        self.head = ClsHead(self.backbone.out_channels, cfg.num_classes, device)
        self.eval()
        self.requires_grad_(False)

    def forward(self, x):
        return self.head(self.backbone(x.permute(0, 3, 1, 2)))
