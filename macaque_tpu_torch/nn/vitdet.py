"""ViTDet-H (bbox only): a plain ViT-H backbone, a simple feature pyramid
and the two-stage heads, in PyTorch.

Li, Mao, Girshick, He, *Exploring Plain Vision Transformer Backbones for
Object Detection* (ECCV 2022), as detectron2's
``projects/ViTDet/configs/COCO/mask_rcnn_vitdet_h_75ep.py`` builds it, with
mmdet's ``projects/ViTDet`` module names where the port follows mmdet:

* backbone: patch 16 (no padding) on a square 1024 input -> a 64 x 64 map
  of width 1280; an absolute position embedding stored at pretraining size
  (14 x 14 and a cls slot, which is dropped) and resized bicubically to the
  map; 32 blocks of 16 heads of 80, MLP 5120 with the exact GELU, LayerNorm
  eps 1e-6, qkv with bias, decomposed relative position in every block;
  blocks 7, 15, 23 and 31 attend globally, the others in 14 x 14 windows of
  the map zero-padded to 70 x 70 (``nn/vit.py::Block``); no final norm;
* neck (``SimpleFPN``): from the stride-16 map, stride 4 by two 2x2
  transposed convolutions (LayerNorm2d and GELU between), stride 8 by one,
  stride 16 the map itself, stride 32 by a 2x2 max pool; each through a 1x1
  and a 3x3 bias-free convolution, each followed by LayerNorm2d, to 256
  channels; stride 64 a stride-2 pool of the last level;
* heads: an RPN of two 3x3 convolutions, and a Shared4Conv1FC box head
  (four 3x3 convolutions with LayerNorm2d, one FC of 1024) on 7x7 RoIs.

The proposals, RoIAlign (K2), the box decoding and the NMS are the Swin-S
detector's (``nn/detector.py::TwoStageDetector``); ``detect_frames`` runs
either. The block projections run in the compute dtype (bf16 on the card);
norm statistics (one fused pass, ``nn/layers.py::LayerNorm``), the relative
position factors, the RPN and box-head outputs in float32. The attention is ``nn/attention.py::relpos_attention``
(K7 on the card). Spans (``core/trace.py``): ``detector.vit`` (the 32
blocks) and ``detector.pyramid`` inside ``detector.trunk``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from macaque_tpu_torch.core.trace import span
from macaque_tpu_torch.nn.detector import (
    DetectorConfig, RoIHead, RPNHead, NormConvModule, TwoStageDetector)
from macaque_tpu_torch.nn.layers import (
    Conv2d, ConvTranspose2d, LayerNorm, LayerNorm2d, gelu, nhwc_conv)
from macaque_tpu_torch.nn.vit import Block


@dataclass(frozen=True)
class ViTDetConfig:
    """The backbone, pyramid and head depths of ViTDet-H (the defaults)."""
    img_size: int = 1024            # the square input
    patch_size: int = 16
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    window: int = 14
    global_blocks: Tuple[int, ...] = (7, 15, 23, 31)
    pretrain_grid: int = 14         # the stored position embedding's side
    ln_eps: float = 1e-6
    rpn_convs: int = 2              # the RPN's 3x3 convolutions
    box_convs: int = 4              # the box head's shared convolutions
    compute_dtype: Any = torch.float32
    # K7 for the attention (the card); the switch's name in ViTPose's config
    use_pallas_attention: bool = False

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size


class ViTDetBackbone(nn.Module):
    def __init__(self, cfg: ViTDetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        g, D = cfg.grid, cfg.embed_dim
        self.patch_embed = nn.Module()
        self.patch_embed.projection = Conv2d(
            3, D, cfg.patch_size, cfg.patch_size, device=device,
            dtype=cfg.compute_dtype)
        self.pos_embed = nn.Parameter(torch.zeros(
            1, cfg.pretrain_grid ** 2 + 1, D, device=device))
        self.layers = nn.ModuleList([
            Block(cfg, device, *((0, (g, g)) if i in cfg.global_blocks
                                 else (cfg.window, (cfg.window, cfg.window))),
                  norm=LayerNorm)
            for i in range(cfg.depth)])

    def abs_pos(self, h: int, w: int) -> torch.Tensor:
        """The position embedding without its cls slot, resized bicubically
        to (1, h, w, D) (detectron2's ``get_abs_pos``), float32."""
        p, D = self.cfg.pretrain_grid, self.cfg.embed_dim
        pos = self.pos_embed[:, 1:].reshape(1, p, p, D).permute(0, 3, 1, 2)
        if (p, p) != (h, w):
            pos = F.interpolate(pos, size=(h, w), mode="bicubic",
                                align_corners=False)
        return pos.permute(0, 2, 3, 1)

    def forward(self, x):
        """(B, S, S, 3) normalized square inputs -> (B, S/16, S/16, D)."""
        x = nhwc_conv(self.patch_embed.projection, x)
        x = x + self.abs_pos(x.shape[1], x.shape[2]).to(x.dtype)
        for blk in self.layers:
            x = blk(x)
        return x


class SimpleFPN(nn.Module):
    """mmdet's ``SimpleFPN`` on channels-last maps: 5 maps of
    ``fpn_channels``, strides 4 to 64."""

    def __init__(self, D: int, C: int, dtype, device=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fpn1 = nn.Sequential(ConvTranspose2d(D, D // 2, 2, 2, **kw),
                                  LayerNorm2d(D // 2, device=device),
                                  nn.GELU(),
                                  ConvTranspose2d(D // 2, D // 4, 2, 2, **kw))
        self.fpn2 = nn.Sequential(ConvTranspose2d(D, D // 2, 2, 2, **kw))
        chans = (D // 4, D // 2, D, D)
        self.lateral_convs = nn.ModuleList([
            NormConvModule(c, C, 1, dtype, device) for c in chans])
        self.fpn_convs = nn.ModuleList([
            NormConvModule(C, C, 3, dtype, device) for _ in chans])

    def forward(self, x):                       # (B, h, w, D)
        f1 = self.fpn1
        up = nhwc_conv(f1[0], x)
        up = gelu(f1[1](up), approximate=False)
        ins = [nhwc_conv(f1[3], up), nhwc_conv(self.fpn2[0], x), x,
               nhwc_conv(lambda t: F.max_pool2d(t, 2, 2), x)]
        outs = [fc(lat(f)) for lat, fc, f in
                zip(self.lateral_convs, self.fpn_convs, ins)]
        outs.append(nhwc_conv(lambda t: F.max_pool2d(t, 1, 2), outs[-1]))
        return outs


class ViTDetMaskRCNN(TwoStageDetector):
    """ViTDet-H Mask R-CNN, bbox only, built in inference mode: ``cfg``
    holds the detector's budgets and head widths (its ``swin`` is unused),
    ``vit`` the backbone. The trunk runs once a chunk of inputs padded to
    the ``img_size`` square (``square``)."""

    def __init__(self, cfg: DetectorConfig = DetectorConfig(),
                 vit: ViTDetConfig = ViTDetConfig(), device=None):
        super().__init__(cfg)
        self.vit = vit
        self.square = vit.img_size
        self.backbone = ViTDetBackbone(vit, device)
        self.neck = SimpleFPN(vit.embed_dim, cfg.fpn_channels,
                              cfg.compute_dtype, device)
        self.rpn_head = RPNHead(cfg, device, num_convs=vit.rpn_convs)
        self.roi_head = RoIHead(cfg, device, num_convs=vit.box_convs,
                                num_fcs=1)
        self._frozen()

    def trunk(self, images):
        with span("detector.vit"):
            x = self.backbone(images)
        with span("detector.pyramid"):
            fpn_feats = self.neck(x)
        return fpn_feats, self.rpn_head(fpn_feats)
