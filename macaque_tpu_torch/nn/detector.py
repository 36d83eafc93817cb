"""Swin-S + FPN + Mask R-CNN (bbox-only) detector in PyTorch.

The detector of ``macaque_tpu/nn/detector.py`` (the reference detection
config): FPN over the 4 Swin stages (256 ch, 5 outputs with an extra
max-pool level), RPN (3 anchor ratios, scale 8, strides 4..64), aligned
RoIAlign 7x7 into a Shared2FC box head (1024-1024, softmax over
[macaque, background]). Inference follows mmdet's test_cfg: RPN
nms_pre/max 1000 at IoU 0.7 (level-aware NMS), RCNN score_thr 0.05, NMS
0.5, max 100, with fixed output sizes. Module names follow mmdet
(``neck.fpn_convs.0.conv``, ``roi_head.bbox_head.shared_fcs.0``).
The RoIAlign runs ``nn/roialign.py`` (the CUDA kernel on the card).
``TwoStageDetector`` holds what any trunk shares: the proposals, the RoI
features, the box head and its NMS; ``SwinMaskRCNN`` and
``nn/vitdet.py::ViTDetMaskRCNN`` register their own trunk on it. The RPN
head takes a number of convolutions and the box head optional shared
convolutions with LayerNorm2d (mmdet's Shared4Conv1FC).

Spans (``core/trace.py``): ``detector.trunk`` around :func:`detect_frames`'
one trunk call over the chunk, counted as ``detector.trunk_calls``,
``detector.head`` around :meth:`SwinMaskRCNN.head`, which holds
``detector.proposals``, ``detector.roi`` and ``detector.box_head``; the
anchors' copies to the card count as ``host_reads.anchors``, the RoI chunks'
window read as ``host_reads.roi_buckets``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from macaque_tpu_torch.core.trace import count, span
from macaque_tpu_torch.nn.layers import Conv2d, LayerNorm2d, Linear, nhwc_conv
from macaque_tpu_torch.nn.ops import (
    _roi_level_canvas, batched_nms_fixed, delta2bbox, make_anchors, nms_fixed)
from macaque_tpu_torch.nn.roialign import (
    WINDOW_BUCKETS, roi_align_windowed, roi_window_buckets)
from macaque_tpu_torch.nn.swin import SwinBackbone, SwinConfig


@dataclass(frozen=True)
class DetectorConfig:
    swin: SwinConfig = field(default_factory=SwinConfig)
    fpn_channels: int = 256
    num_classes: int = 1
    rpn_nms_pre: int = 1000
    rpn_iou_thr: float = 0.7
    rpn_max: int = 1000
    rcnn_score_thr: float = 0.05
    rcnn_iou_thr: float = 0.5
    rcnn_max: int = 100
    # proposals entering the RoI head (the default feeds all rpn_max, as
    # mmdet does; the serving preset truncates)
    rcnn_roi_topk: int = 1000
    # RoIs per RoIAlign call: above it the RoIs are sorted by their exact
    # window bucket and aligned chunk by chunk, each chunk with the
    # smallest window that is exact for all of its RoIs
    rcnn_roi_chunk: int = 256
    strides: Tuple[int, ...] = (4, 8, 16, 32, 64)
    finest_scale: float = 56.0
    compute_dtype: Any = torch.float32

    @classmethod
    def serving(cls, **overrides) -> "DetectorConfig":
        """Throughput preset: 512 proposals, 128 RoIs in 64-RoI chunks (an
        opt-in trade-off; the default is exact mmdet)."""
        kw: dict = dict(rpn_nms_pre=512, rpn_max=512, rcnn_roi_topk=128,
                        rcnn_roi_chunk=64)
        kw.update(overrides)
        return cls(**kw)


class ConvModule(nn.Module):
    def __init__(self, cin, cout, k, dtype, device=None):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, padding=k // 2, device=device,
                           dtype=dtype)


class FPN(nn.Module):
    def __init__(self, cfg: DetectorConfig, device=None):
        super().__init__()
        C, dt = cfg.fpn_channels, cfg.compute_dtype
        self.lateral_convs = nn.ModuleList([
            ConvModule(c, C, 1, dt, device) for c in cfg.swin.out_channels])
        self.fpn_convs = nn.ModuleList([
            ConvModule(C, C, 3, dt, device) for _ in cfg.swin.out_channels])

    def forward(self, feats):
        """4 channels-last maps -> 5 channels-last maps (the 5th a stride-2
        max pool of the 4th, mmdet's extra level)."""
        lat = [m.conv(f.permute(0, 3, 1, 2))
               for m, f in zip(self.lateral_convs, feats)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + F.interpolate(
                lat[i], size=lat[i - 1].shape[-2:], mode="nearest")
        outs = [m.conv(x) for m, x in zip(self.fpn_convs, lat)]
        outs.append(F.max_pool2d(outs[-1], 1, stride=2))
        return [o.permute(0, 2, 3, 1) for o in outs]


class NormConvModule(nn.Module):
    """mmcv's ConvModule with a norm: a bias-free convolution, LayerNorm2d
    over its channels, then ReLU where ``relu``; on channels-last maps."""

    def __init__(self, cin, cout, k, dtype, device=None, relu=False):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, padding=k // 2, bias=False,
                           device=device, dtype=dtype)
        # mmcv names a norm whose class it cannot place (mmdet's LN2d)
        # ``norm_layer``
        self.norm_layer = LayerNorm2d(cout, device=device)
        self.relu = relu

    def forward(self, x):                       # (B, H, W, C)
        x = self.norm_layer(nhwc_conv(self.conv, x))
        return F.relu(x) if self.relu else x


class RPNHead(nn.Module):
    """mmdet's RPNHead: ``num_convs`` 3x3 convolutions, each followed by a
    ReLU (one: ``rpn_conv``; more: ``rpn_conv.<i>.conv``, mmcv
    ConvModules), then the float32 1x1 class and box outputs."""

    def __init__(self, cfg: DetectorConfig, device=None, num_convs: int = 1):
        super().__init__()
        C, dt = cfg.fpn_channels, cfg.compute_dtype
        if num_convs == 1:
            self.rpn_conv = Conv2d(C, C, 3, padding=1, device=device, dtype=dt)
        else:
            self.rpn_conv = nn.Sequential(*[
                ConvModule(C, C, 3, dt, device) for _ in range(num_convs)])
        self.rpn_cls = Conv2d(C, 3, 1, device=device)
        self.rpn_reg = Conv2d(C, 12, 1, device=device)

    def _convs(self, f):
        if isinstance(self.rpn_conv, nn.Sequential):
            for m in self.rpn_conv:
                f = F.relu(nhwc_conv(m.conv, f))
            return f
        return F.relu(nhwc_conv(self.rpn_conv, f))

    def forward(self, feats):
        outs = []
        for f in feats:
            h = self._convs(f)
            outs.append((nhwc_conv(self.rpn_cls, h), nhwc_conv(self.rpn_reg, h)))
        return outs


class BBoxHead(nn.Module):
    """mmdet's ConvFCBBoxHead on 7x7 RoI features: ``num_convs`` shared 3x3
    convolutions (256 channels, LayerNorm2d, ReLU) and ``num_fcs`` shared
    1024-wide FC layers (ReLU), then the float32 class and box outputs.
    Shared2FC (the Swin-S detector) is (0, 2), Shared4Conv1FC (ViTDet) is
    (4, 1)."""

    def __init__(self, cfg: DetectorConfig, device=None, num_convs: int = 0,
                 num_fcs: int = 2):
        super().__init__()
        kw = dict(device=device, dtype=cfg.compute_dtype)
        C = cfg.fpn_channels
        self.shared_convs = nn.ModuleList([
            NormConvModule(C, C, 3, cfg.compute_dtype, device, relu=True)
            for _ in range(num_convs)])
        self.shared_fcs = nn.ModuleList([
            Linear(C * 49 if i == 0 else 1024, 1024, **kw)
            for i in range(num_fcs)])
        self.fc_cls = Linear(1024, cfg.num_classes + 1, device=device)
        self.fc_reg = Linear(1024, 4 * cfg.num_classes, device=device)

    def forward(self, roi_feats):
        """(R, 7, 7, C) channels-last RoI features, flattened (C, 7, 7) as
        mmdet does -> (cls logits (R, 2), deltas (R, 4)), float32."""
        x = roi_feats
        for m in self.shared_convs:
            x = m(x)
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x)


class RoIHead(nn.Module):
    def __init__(self, cfg, device=None, **bbox_head):
        super().__init__()
        self.bbox_head = BBoxHead(cfg, device, **bbox_head)


class TwoStageDetector(nn.Module):
    """A two-stage detector over a pluggable trunk: a subclass registers
    ``backbone``, ``neck``, ``rpn_head`` and ``roi_head`` and may override
    :meth:`trunk`; the proposals, the RoI features (K2) and the box head
    with its NMS are shared. :func:`detect_frames` runs a batch of padded
    normalized inputs through it. The contract the benchmark's recorder and
    check hold: ``trunk(images) -> (maps, rpn)``, ``head(maps, rpn,
    img_shape)`` and ``_proposals(maps, rpn, img_shape)``."""

    # the side of the square a subclass's input is padded to (ViTDet's
    # 1024), which ``TorchPerception`` reads; None: padded to /32
    square = None

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        self.cfg = cfg

    def _frozen(self):
        self.eval()
        self.requires_grad_(False)

    def trunk(self, images):
        """Backbone + neck + RPN convs on (B, H, W, 3) inputs."""
        fpn_feats = self.neck(self.backbone(images))
        return fpn_feats, self.rpn_head(fpn_feats)

    def _proposals(self, fpn_feats, rpn_outs, img_shape):
        c = self.cfg
        dev = fpn_feats[0].device
        anchors = make_anchors([(f.shape[1], f.shape[2]) for f in fpn_feats],
                               c.strides)
        boxes, scores, ids = [], [], []
        for lvl, ((cls, reg), anc) in enumerate(zip(rpn_outs, anchors)):
            B = cls.shape[0]
            score = torch.sigmoid(cls.reshape(B, -1))
            delta = reg.reshape(B, -1, 4)
            k = min(c.rpn_nms_pre, score.shape[1])
            top_s, top_i = torch.topk(score, k, dim=1)
            count("host_reads.anchors")   # copies that wait on a card
            anc = torch.as_tensor(anc, device=dev)[top_i]
            d = torch.gather(delta, 1, top_i[..., None].expand(-1, -1, 4))
            boxes.append(delta2bbox(anc, d, max_shape=img_shape))
            scores.append(top_s)
            ids.append(torch.full_like(top_i, lvl))
        pb, ps, pi = (torch.cat(t, 1) for t in (boxes, scores, ids))
        keep, valid = batched_nms_fixed(pb, ps, pi, c.rpn_iou_thr, c.rpn_max)
        return torch.gather(pb, 1, keep[..., None].expand(-1, -1, 4)), valid

    def _roi_features(self, feats4, proposals, lvl, prop_valid):
        """RoIAlign of every proposal; beyond one chunk, the RoIs are sorted
        by their exact window bucket (descending, stable: RPN rank kept
        within a bucket) and each chunk runs the smallest exact window.
        Returns the (possibly reordered) proposals, validity and features."""
        c = self.cfg
        canvas = _roi_level_canvas(feats4)
        R = proposals.shape[1]
        Rc = min(c.rcnn_roi_chunk, R)
        if R <= Rc:
            return proposals, prop_valid, roi_align_windowed(
                feats4, proposals, lvl, 7, c.strides, canvas=canvas)
        need = roi_window_buckets(feats4, proposals, lvl, 7, c.strides)
        order = torch.sort(need, dim=1, descending=True, stable=True).indices
        proposals = torch.gather(proposals, 1, order[..., None].expand(-1, -1, 4))
        lvl = torch.gather(lvl, 1, order)
        prop_valid = torch.gather(prop_valid, 1, order)
        need = torch.gather(need, 1, order)
        starts = range(0, R, Rc)
        count("host_reads.roi_buckets")
        windows = [WINDOW_BUCKETS[w] for w in
                   torch.stack([need[:, r0:r0 + Rc].amax() for r0 in starts]).tolist()]
        feats = [roi_align_windowed(feats4, proposals[:, r0:r0 + Rc],
                                    lvl[:, r0:r0 + Rc], 7, c.strides,
                                    window=w, canvas=canvas)
                 for r0, w in zip(starts, windows)]
        return proposals, prop_valid, torch.cat(feats, 1)

    def head(self, fpn_feats, rpn_outs, img_shape=None):
        """Proposals + RoI head on trunk outputs -> (boxes (B, rcnn_max, 4),
        scores (B, rcnn_max), valid (B, rcnn_max))."""
        c = self.cfg
        B = fpn_feats[0].shape[0]
        if img_shape is None:
            img_shape = (fpn_feats[0].shape[1] * c.strides[0],
                         fpn_feats[0].shape[2] * c.strides[0])
        with span("detector.head"):
            with span("detector.proposals"):
                proposals, prop_valid = self._proposals(fpn_feats, rpn_outs,
                                                        img_shape)
            K = min(c.rcnn_roi_topk, proposals.shape[1])
            proposals, prop_valid = proposals[:, :K], prop_valid[:, :K]

            with span("detector.roi"):
                w = (proposals[..., 2] - proposals[..., 0]).clamp_min(0)
                h = (proposals[..., 3] - proposals[..., 1]).clamp_min(0)
                lvl = torch.floor(torch.log2(torch.sqrt(w * h) / c.finest_scale
                                             + 1e-6))
                lvl = lvl.clamp(0, 3).long()
                feats4 = [f.to(c.compute_dtype) for f in fpn_feats[:4]]
                proposals, prop_valid, roi_feats = self._roi_features(
                    feats4, proposals, lvl, prop_valid)
            with span("detector.box_head"):
                return self._box_head(proposals, prop_valid, roi_feats,
                                      img_shape)

    def _box_head(self, proposals, prop_valid, roi_feats, img_shape):
        """The box head and its NMS on the RoI features -> ``head``'s
        outputs."""
        c = self.cfg
        B, R = proposals.shape[:2]
        cls_logits, reg = self.roi_head.bbox_head(
            roi_feats.reshape(B * R, *roi_feats.shape[2:]))
        fg = torch.softmax(cls_logits, -1).reshape(B, R, -1)[..., 0]
        boxes = delta2bbox(proposals, reg.reshape(B, R, 4),
                           stds=(0.1, 0.1, 0.2, 0.2), max_shape=img_shape)
        score = torch.where(prop_valid & (fg > c.rcnn_score_thr), fg,
                            torch.full_like(fg, -math.inf))
        n_out = min(c.rcnn_max, R)
        keep, valid = nms_fixed(boxes, score, c.rcnn_iou_thr, n_out)
        out_b = torch.gather(boxes, 1, keep[..., None].expand(-1, -1, 4))
        out_s = torch.where(valid, torch.gather(fg, 1, keep),
                            torch.zeros_like(valid, dtype=fg.dtype))
        pad = c.rcnn_max - n_out
        if pad:  # keep the (rcnn_max,) output contract when R < rcnn_max
            out_b = F.pad(out_b, (0, 0, 0, pad))
            out_s = F.pad(out_s, (0, pad))
            valid = F.pad(valid, (0, pad))
        return out_b, out_s, valid


class SwinMaskRCNN(TwoStageDetector):
    """The Swin-S detector, built in inference mode. After
    ``nn.layers.make_trainable`` its ``trunk`` and ``roi_head.bbox_head``
    carry gradients (``nn/train.py`` feeds the box head through the plain
    ``roi_align_windowed_reference``: the kernel has no backward)."""

    def __init__(self, cfg: DetectorConfig = DetectorConfig(), device=None):
        super().__init__(cfg)
        self.backbone = SwinBackbone(cfg.swin, device)
        self.neck = FPN(cfg, device)
        self.rpn_head = RPNHead(cfg, device)
        self.roi_head = RoIHead(cfg, device)
        self._frozen()


def detect_frames(model: TwoStageDetector, images, img_shape=None):
    """Chunk inference: the trunk and the proposal/RoI/box head each in one
    call over the whole chunk. The JAX package maps its trunk over the
    images; every layer of the trunk works image by image, so the results
    differ only in the order of float sums. images (B, H, W, 3) normalized
    and padded (to /32, or to the ViTDet detector's square)."""
    with span("detector.trunk"):
        count("detector.trunk_calls")
        fpn_feats, rpn_outs = model.trunk(images)
    return model.head(fpn_feats, rpn_outs, img_shape)
