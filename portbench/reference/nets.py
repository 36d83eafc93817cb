"""The three stage-1 networks in plain float32 PyTorch, as published.

Frozen, independent copies of the published architectures that the
benchmark holds the program against. Nothing here imports the program.
State-dict keys follow mmdet / mmpose / mmpretrain, the names of the
released checkpoints, so one seeded state dict loads into both sides.

* Swin-S Mask R-CNN, bbox only (mmdet ``SWIN-Mask_R-CNN_bbox_only.py``):
  patch 4, embed 96, depths 2/2/18/2, heads 3/6/12/24, window 7 with a
  relative position bias, shifted windows on odd blocks, per-stage output
  norms; FPN with 256 channels and an extra max-pool level; RPN with three
  anchor ratios; Shared2FC box head (1024-1024) over 7x7 RoI features.
* ViTPose-huge (mmpose ``td-hm_ViTPose-huge_8xb64-210e_coco-256x192``):
  width 1280, 32 blocks, 16 heads, MLP 5120, patch 16 with conv padding 2,
  learned position embedding, final LayerNorm, two 4x4 stride-2 deconvs
  (256, BN, ReLU) and a 1x1 conv to 17 heatmaps of 64x48.
* ResNet-152 (mmpretrain): pytorch-style bottlenecks (stride on the 3x3),
  global average pool, a 6-way linear head.

Departures from the published models, each also a departure of the
program: the window attention pads the map to a multiple of 7 as mmdet
does; the box head, RoIAlign and NMS run in ``reference/detect.py``. The
GELU is the exact (erf) form everywhere, as published; the program uses
its tanh form in bfloat16 ViT blocks. The serving tier's int8 pose blocks
are emulated by ``reference/lowp.py``.

Each configuration's network block names the architecture file under
``portbench/archs/`` that builds its reference from these classes; a new
architecture's reference goes into a new file beside this one. A reference
detector keeps the contract that ``check.py`` and ``reference/detect.py``
rely on: ``maps(images)`` from the padded normalized (B, H, W, 3) input to
the pyramid's channels-last maps, the RoI levels first (strides 4 to 32)
and the RPN's extra level last; ``rpn_head(maps)``, one (class, box)
pair of channels-last outputs a level, three anchors a position; and
``roi_head.bbox_head``, which takes (R, 7, 7, C) RoI features to (class
logits, deltas).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# ----------------------------------------------------------------- Swin-S

def _rel_pos_index(window: int) -> torch.Tensor:
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) \
        + (window - 1)
    return torch.as_tensor(rel[..., 0] * (2 * window - 1) + rel[..., 1])


def _shift_mask(H: int, W: int, w: int, shift: int) -> torch.Tensor:
    img = np.zeros((H, W))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(H // w, w, W // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    diff = img[:, :, None] - img[:, None, :]
    return torch.as_tensor(np.where(diff != 0, -100.0, 0.0).astype(np.float32))


class WindowMSA(nn.Module):
    def __init__(self, dim, heads, window):
        super().__init__()
        self.heads, self.window = heads, window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index",
                             _rel_pos_index(window), persistent=False)

    def forward(self, x, mask=None):
        B_, N, C = x.shape
        hd = C // self.heads
        q, k, v = self.qkv(x).reshape(B_, N, 3, self.heads, hd).permute(
            2, 0, 3, 1, 4)
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)].reshape(N, N, -1)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, self.heads, N, N)
                    + mask[None, :, None]).reshape(B_, self.heads, N, N)
        out = torch.softmax(attn, -1) @ v
        return self.proj(out.transpose(1, 2).reshape(B_, N, C))


class _Holder(nn.Module):
    """A bare parent that gives a child the mm checkpoint's key prefix."""


class SwinBlock(nn.Module):
    def __init__(self, dim, heads, window, shift):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = _Holder()
        self.attn.w_msa = WindowMSA(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim)
        self.ffn = _Holder()
        self.ffn.layers = nn.ModuleList([
            nn.Sequential(nn.Linear(dim, 4 * dim)), nn.Linear(4 * dim, dim)])

    def forward(self, x):
        B, H, W, C = x.shape
        w, s = self.window, self.shift
        y = self.norm1(x)
        ph, pw = (w - H % w) % w, (w - W % w) % w
        y = F.pad(y, (0, 0, 0, pw, 0, ph))
        Hp, Wp = H + ph, W + pw
        mask = None
        if s:
            y = torch.roll(y, (-s, -s), (1, 2))
            mask = _shift_mask(Hp, Wp, w, s).to(y.device)
        win = y.reshape(B, Hp // w, w, Wp // w, w, C).permute(
            0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)
        y = self.attn.w_msa(win, mask).reshape(B, Hp // w, Wp // w, w, w, C)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
        if s:
            y = torch.roll(y, (s, s), (1, 2))
        x = x + y[:, :H, :W]
        f = self.ffn.layers
        return x + f[1](F.gelu(f[0](self.norm2(x))))


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        B, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x0 = x[:, 0::2, 0::2]
        x1 = x[:, 1::2, 0::2]
        x2 = x[:, 0::2, 1::2]
        x3 = x[:, 1::2, 1::2]
        return self.reduction(self.norm(torch.cat([x0, x1, x2, x3], -1)))


class SwinBackbone(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        e, w = c["embed_dim"], c["window"]
        self.patch_embed = _Holder()
        self.patch_embed.projection = nn.Conv2d(3, e, c["patch_size"],
                                                c["patch_size"])
        self.patch_embed.norm = nn.LayerNorm(e)
        self.stages = nn.ModuleList()
        for s, (depth, heads) in enumerate(zip(c["depths"], c["num_heads"])):
            dim = e * 2 ** s
            stage = _Holder()
            stage.blocks = nn.ModuleList([
                SwinBlock(dim, heads, w, 0 if b % 2 == 0 else w // 2)
                for b in range(depth)])
            stage.downsample = (PatchMerging(dim) if s < len(c["depths"]) - 1
                                else None)
            self.stages.append(stage)
            setattr(self, f"norm{s}", nn.LayerNorm(dim))

    def forward(self, x):
        """(B, H, W, 3) normalized -> four channels-last maps."""
        x = self.patch_embed.projection(x.permute(0, 3, 1, 2))
        x = self.patch_embed.norm(x.permute(0, 2, 3, 1))
        outs = []
        for s, stage in enumerate(self.stages):
            for blk in stage.blocks:
                x = blk(x)
            outs.append(getattr(self, f"norm{s}")(x))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs


def _conv_module(cin, cout, k):
    m = _Holder()
    m.conv = nn.Conv2d(cin, cout, k, padding=k // 2)
    return m


class FPN(nn.Module):
    def __init__(self, in_channels, C):
        super().__init__()
        self.lateral_convs = nn.ModuleList([_conv_module(c, C, 1)
                                            for c in in_channels])
        self.fpn_convs = nn.ModuleList([_conv_module(C, C, 3)
                                        for _ in in_channels])

    def forward(self, feats):
        lat = [m.conv(f.permute(0, 3, 1, 2))
               for m, f in zip(self.lateral_convs, feats)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + F.interpolate(
                lat[i], size=lat[i - 1].shape[-2:], mode="nearest")
        outs = [m.conv(x) for m, x in zip(self.fpn_convs, lat)]
        outs.append(F.max_pool2d(outs[-1], 1, stride=2))
        return [o.permute(0, 2, 3, 1) for o in outs]


class RPNHead(nn.Module):
    def __init__(self, C, anchors=3):
        super().__init__()
        self.rpn_conv = nn.Conv2d(C, C, 3, padding=1)
        self.rpn_cls = nn.Conv2d(C, anchors, 1)
        self.rpn_reg = nn.Conv2d(C, 4 * anchors, 1)

    def forward(self, feats):
        outs = []
        for f in feats:
            h = F.relu(self.rpn_conv(f.permute(0, 3, 1, 2)))
            outs.append((self.rpn_cls(h).permute(0, 2, 3, 1),
                         self.rpn_reg(h).permute(0, 2, 3, 1)))
        return outs


class BBoxHead(nn.Module):
    def __init__(self, C, classes):
        super().__init__()
        self.shared_fcs = nn.ModuleList([nn.Linear(C * 49, 1024),
                                         nn.Linear(1024, 1024)])
        self.fc_cls = nn.Linear(1024, classes + 1)
        self.fc_reg = nn.Linear(1024, 4 * classes)

    def forward(self, roi_feats):
        """(R, 7, 7, C) -> (class logits (R, classes + 1), deltas (R, 4))."""
        x = roi_feats.permute(0, 3, 1, 2).reshape(roi_feats.shape[0], -1)
        x = F.relu(self.shared_fcs[1](F.relu(self.shared_fcs[0](x))))
        return self.fc_cls(x), self.fc_reg(x)


class Detector(nn.Module):
    """The networks of the detector; ``reference/detect.py`` runs them."""

    def __init__(self, c: dict):
        super().__init__()
        self.cfg = c
        self.backbone = SwinBackbone(c)
        chans = [c["embed_dim"] * 2 ** s for s in range(len(c["depths"]))]
        self.neck = FPN(chans, c["fpn_channels"])
        self.rpn_head = RPNHead(c["fpn_channels"])
        self.roi_head = _Holder()
        self.roi_head.bbox_head = BBoxHead(c["fpn_channels"], c["num_classes"])

    def maps(self, images):
        return self.neck(self.backbone(images))


# ------------------------------------------------------------- ViTPose-H

class ViTBlock(nn.Module):
    def __init__(self, dim, heads, hidden, eps):
        super().__init__()
        self.heads = heads
        self.ln1 = nn.LayerNorm(dim, eps=eps)
        self.attn = _Holder()
        self.attn.qkv = nn.Linear(dim, 3 * dim)
        self.attn.proj = nn.Linear(dim, dim)
        self.ln2 = nn.LayerNorm(dim, eps=eps)
        self.ffn = _Holder()
        self.ffn.layers = nn.ModuleList([
            nn.Sequential(nn.Linear(dim, hidden)), nn.Linear(hidden, dim)])

    def forward(self, x):
        B, N, C = x.shape
        hd = C // self.heads
        q, k, v = self.attn.qkv(self.ln1(x)).reshape(
            B, N, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        a = torch.softmax((q @ k.transpose(-2, -1)) * hd ** -0.5, -1) @ v
        x = x + self.attn.proj(a.transpose(1, 2).reshape(B, N, C))
        f = self.ffn.layers
        return x + f[1](F.gelu(f[0](self.ln2(x))))


class ViTPose(nn.Module):
    """(B, 256, 192, 3) normalized crops -> (B, 64, 48, 17) heatmaps."""

    def __init__(self, c: dict):
        super().__init__()
        self.cfg = c
        D, p, pad = c["embed_dim"], c["patch_size"], c["patch_padding"]
        H, W = c["img_size"]
        self.grid = ((H + 2 * pad - p) // p + 1, (W + 2 * pad - p) // p + 1)
        self.backbone = _Holder()
        bb = self.backbone
        bb.patch_embed = _Holder()
        bb.patch_embed.projection = nn.Conv2d(3, D, p, p, pad)
        bb.pos_embed = nn.Parameter(torch.zeros(
            1, self.grid[0] * self.grid[1], D))
        hidden = int(D * c["mlp_ratio"])
        bb.layers = nn.ModuleList([ViTBlock(D, c["num_heads"], hidden, 1e-6)
                                   for _ in range(c["depth"])])
        bb.ln1 = nn.LayerNorm(D, eps=1e-6)
        layers, cin = [], D
        for ch in c["deconv_channels"]:
            layers += [nn.ConvTranspose2d(cin, ch, 4, 2, 1, bias=False),
                       nn.BatchNorm2d(ch), nn.ReLU()]
            cin = ch
        self.head = _Holder()
        self.head.deconv_layers = nn.Sequential(*layers)
        self.head.final_layer = nn.Conv2d(cin, c["num_keypoints"], 1)

    def forward(self, x):
        bb = self.backbone
        x = bb.patch_embed.projection(x.permute(0, 3, 1, 2))
        B, D, h, w = x.shape
        x = x.flatten(2).transpose(1, 2) + bb.pos_embed
        for blk in bb.layers:
            x = blk(x)
        x = bb.ln1(x).reshape(B, h, w, D).permute(0, 3, 1, 2)
        x = self.head.final_layer(self.head.deconv_layers(x))
        return x.permute(0, 2, 3, 1)


# -------------------------------------------------------------- ResNet-152

_STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class Bottleneck(nn.Module):
    def __init__(self, cin, ch, stride, downsample):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, ch, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(ch)
        self.conv2 = nn.Conv2d(ch, ch, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(ch)
        self.conv3 = nn.Conv2d(ch, 4 * ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(4 * ch)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, 4 * ch, 1, stride, bias=False),
            nn.BatchNorm2d(4 * ch)) if downsample else None)

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + idt)


class ResNetClassifier(nn.Module):
    """(B, 224, 224, 3) normalized -> logits (B, classes)."""

    def __init__(self, c: dict):
        super().__init__()
        self.cfg = c
        self.backbone = _Holder()
        bb = self.backbone
        bb.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        bb.bn1 = nn.BatchNorm2d(64)
        cin, ch = 64, 64
        self.n_stages = len(_STAGES[c["depth"]])
        for s, blocks in enumerate(_STAGES[c["depth"]]):
            setattr(bb, f"layer{s + 1}", nn.Sequential(*[
                Bottleneck(cin if b == 0 else 4 * ch, ch,
                           2 if (s > 0 and b == 0) else 1, b == 0)
                for b in range(blocks)]))
            cin, ch = 4 * ch, 2 * ch
        self.head = _Holder()
        self.head.fc = nn.Linear(cin, c["num_classes"])

    def forward(self, x):
        bb = self.backbone
        x = F.relu(bb.bn1(bb.conv1(x.permute(0, 3, 1, 2))))
        x = F.max_pool2d(x, 3, 2, 1)
        for s in range(self.n_stages):
            x = getattr(bb, f"layer{s + 1}")(x)
        return self.head.fc(x.mean((2, 3)))


def frozen(net: nn.Module) -> nn.Module:
    """``net`` in evaluation mode, without gradients: how the architecture
    files (``portbench/archs/``) hand a reference network over."""
    return net.eval().requires_grad_(False)
