"""ViTDet-H Mask R-CNN, bbox only, in plain float32 PyTorch, as published.

Li, Mao, Girshick, He, *Exploring Plain Vision Transformer Backbones for
Object Detection*, ECCV 2022 (arXiv:2203.16527); detectron2's
``projects/ViTDet/configs/COCO/mask_rcnn_vitdet_h_75ep.py``. A frozen,
independent copy of the published equations that the benchmark holds the
program against; nothing here imports the program. State-dict keys follow
mmdet's ``projects/ViTDet`` (the blocks under ``backbone.layers`` with
mmpose's block names, as the port's ViT), so one seeded state dict loads
into both sides.

* Backbone (detectron2 ``ViT``): patch 16, no padding; the absolute
  position embedding stored at the pretraining grid with a cls slot, the
  slot dropped and the rest resized bicubically to the map
  (``get_abs_pos``); each block ``x + attn(norm1(x))`` then ``x +
  mlp(norm2(x))``, LayerNorm eps 1e-6, the exact GELU; in window blocks the
  normed map is zero-padded at the bottom and right to whole windows,
  attended window by window with the padding unmasked, and cropped back
  (``window_partition`` / ``window_unpartition``); the global blocks attend
  over the whole map. Every block adds the decomposed relative position
  (``add_decomposed_rel_pos``) to the scaled scores:
  ``attn[q, k] += q . Rh[q_h - k_h] + q . Rw[q_w - k_w]``, q unscaled,
  ``Rh[i] = rel_pos_h[i + g - 1]``. No final norm.
* Neck (``SimpleFPN``): stride 4 by ConvT 2x2 (to D/2), LN2d, GELU,
  ConvT 2x2 (to D/4); stride 8 by ConvT 2x2; stride 16 the map; stride 32
  a 2x2 max pool; each through a bias-free 1x1 and 3x3 convolution, each
  followed by LN2d; stride 64 a 1x1 stride-2 max pool of the last level.
* RPN: two 3x3 convolutions with ReLU, three anchors a position.
* Box head (``Shared4Conv1FCBBoxHead``): four bias-free 3x3 convolutions
  with LN2d and ReLU, one FC of 1024 with ReLU, then the class and box
  outputs; the RoIs are aligned and decoded by ``reference/detect.py``.

The attention is computed in blocks of sequences and heads (at most
``ATTN_ELEMS`` scores at once), so that a global block's 4,096 x 4,096
scores fit.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.nets import _Holder

ATTN_ELEMS = 1 << 26


class LN2d(nn.Module):
    """mmdet's ``LN2d`` on (B, C, H, W): normalized over C."""

    def __init__(self, C, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(C))
        self.bias = nn.Parameter(torch.zeros(C))

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


def rel_pos(table: torch.Tensor, size: int) -> torch.Tensor:
    """detectron2's ``get_rel_pos`` with queries and keys on one grid:
    (size, size, d), entry [i, j] = table[i - j + size - 1]."""
    coords = torch.arange(size, device=table.device)
    return table[(coords[:, None] - coords[None, :] + size - 1).long()]


class Attention(nn.Module):
    def __init__(self, dim, heads, grid):
        super().__init__()
        self.heads, self.grid = heads, grid
        hd = dim // heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * grid - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * grid - 1, hd))

    def forward(self, x):
        B, H, W, C = x.shape
        n, hd, T = self.heads, C // self.heads, H * W
        q, k, v = self.qkv(x.reshape(B, T, C)).reshape(
            B, T, 3, n, hd).permute(2, 0, 3, 1, 4)
        Rh, Rw = rel_pos(self.rel_pos_h, H), rel_pos(self.rel_pos_w, W)
        out = torch.empty_like(q)
        step = max(1, ATTN_ELEMS // (T * T))
        pairs = [(b, h) for b in range(B) for h in range(n)]
        for i in range(0, len(pairs), step):
            bs = torch.tensor([p[0] for p in pairs[i:i + step]], device=x.device)
            hs = torch.tensor([p[1] for p in pairs[i:i + step]], device=x.device)
            qq, kk, vv = q[bs, hs], k[bs, hs], v[bs, hs]     # (m, T, hd)
            attn = (qq * hd ** -0.5) @ kk.transpose(-2, -1)
            r_q = qq.reshape(-1, H, W, hd)
            rel_h = torch.einsum("mhwc,hkc->mhwk", r_q, Rh)
            rel_w = torch.einsum("mhwc,wkc->mhwk", r_q, Rw)
            attn = (attn.view(-1, H, W, H, W) + rel_h[:, :, :, :, None]
                    + rel_w[:, :, :, None, :]).view(-1, T, T)
            out[bs, hs] = torch.softmax(attn, -1) @ vv
        return self.proj(out.permute(0, 2, 1, 3).reshape(B, H, W, C))


class Block(nn.Module):
    def __init__(self, dim, heads, hidden, window, grid):
        super().__init__()
        self.window = window
        self.ln1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads, window or grid)
        self.ln2 = nn.LayerNorm(dim, eps=1e-6)
        self.ffn = _Holder()
        self.ffn.layers = nn.ModuleList([
            nn.Sequential(nn.Linear(dim, hidden)), nn.Linear(hidden, dim)])

    def forward(self, x):
        B, H, W, C = x.shape
        y = self.ln1(x)
        w = self.window
        if w:
            ph, pw = (w - H % w) % w, (w - W % w) % w
            y = F.pad(y, (0, 0, 0, pw, 0, ph))
            Hp, Wp = H + ph, W + pw
            y = y.view(B, Hp // w, w, Wp // w, w, C).permute(
                0, 1, 3, 2, 4, 5).reshape(-1, w, w, C)
        y = self.attn(y)
        if w:
            y = y.view(B, Hp // w, Wp // w, w, w, C).permute(
                0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)[:, :H, :W]
        x = x + y
        f = self.ffn.layers
        return x + f[1](F.gelu(f[0](self.ln2(x))))


class ViT(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        D, p = c["embed_dim"], c["patch_size"]
        self.cfg, self.grid = c, c["img_size"] // p
        self.patch_embed = _Holder()
        self.patch_embed.projection = nn.Conv2d(3, D, p, p)
        self.pos_embed = nn.Parameter(torch.zeros(1, c["pretrain_grid"] ** 2 + 1, D))
        hidden = int(D * c["mlp_ratio"])
        self.layers = nn.ModuleList([
            Block(D, c["num_heads"], hidden,
                  0 if i in c["global_blocks"] else c["window"], self.grid)
            for i in range(c["depth"])])

    def forward(self, x):
        """(B, S, S, 3) normalized -> (B, S/16, S/16, D)."""
        x = self.patch_embed.projection(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        B, h, w, D = x.shape
        pos = self.pos_embed[:, 1:]
        size = int(math.sqrt(pos.shape[1]))
        if (size, size) != (h, w):
            pos = F.interpolate(pos.reshape(1, size, size, D).permute(0, 3, 1, 2),
                                size=(h, w), mode="bicubic", align_corners=False)
            pos = pos.permute(0, 2, 3, 1)
        x = x + pos.reshape(1, h, w, D)
        for blk in self.layers:
            x = blk(x)
        return x


def _norm_conv(cin, cout, k):
    m = _Holder()
    m.conv = nn.Conv2d(cin, cout, k, padding=k // 2, bias=False)
    m.norm_layer = LN2d(cout)
    return m


class SimpleFPN(nn.Module):
    def __init__(self, D, C):
        super().__init__()
        self.fpn1 = nn.Sequential(nn.ConvTranspose2d(D, D // 2, 2, 2), LN2d(D // 2),
                                  nn.GELU(), nn.ConvTranspose2d(D // 2, D // 4, 2, 2))
        self.fpn2 = nn.Sequential(nn.ConvTranspose2d(D, D // 2, 2, 2))
        chans = (D // 4, D // 2, D, D)
        self.lateral_convs = nn.ModuleList([_norm_conv(c, C, 1) for c in chans])
        self.fpn_convs = nn.ModuleList([_norm_conv(C, C, 3) for _ in chans])

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        ins = [self.fpn1(x), self.fpn2(x), x, F.max_pool2d(x, 2, 2)]
        outs = []
        for lat, fc, f in zip(self.lateral_convs, self.fpn_convs, ins):
            f = lat.norm_layer(lat.conv(f))
            outs.append(fc.norm_layer(fc.conv(f)))
        outs.append(F.max_pool2d(outs[-1], 1, stride=2))
        return [o.permute(0, 2, 3, 1) for o in outs]


class RPNHead(nn.Module):
    def __init__(self, C, convs=2, anchors=3):
        super().__init__()
        self.rpn_conv = nn.Sequential()
        for i in range(convs):
            m = _Holder()
            m.conv = nn.Conv2d(C, C, 3, padding=1)
            self.rpn_conv.add_module(str(i), m)
        self.rpn_cls = nn.Conv2d(C, anchors, 1)
        self.rpn_reg = nn.Conv2d(C, 4 * anchors, 1)

    def forward(self, feats):
        outs = []
        for f in feats:
            h = f.permute(0, 3, 1, 2)
            for m in self.rpn_conv:
                h = F.relu(m.conv(h))
            outs.append((self.rpn_cls(h).permute(0, 2, 3, 1),
                         self.rpn_reg(h).permute(0, 2, 3, 1)))
        return outs


class BBoxHead(nn.Module):
    def __init__(self, C, classes, convs=4):
        super().__init__()
        self.shared_convs = nn.ModuleList([_norm_conv(C, C, 3) for _ in range(convs)])
        self.shared_fcs = nn.ModuleList([nn.Linear(C * 49, 1024)])
        self.fc_cls = nn.Linear(1024, classes + 1)
        self.fc_reg = nn.Linear(1024, 4 * classes)

    def forward(self, roi_feats):
        """(R, 7, 7, C) -> (class logits (R, classes + 1), deltas (R, 4))."""
        x = roi_feats.permute(0, 3, 1, 2)
        for m in self.shared_convs:
            x = F.relu(m.norm_layer(m.conv(x)))
        x = F.relu(self.shared_fcs[0](x.reshape(x.shape[0], -1)))
        return self.fc_cls(x), self.fc_reg(x)


class Detector(nn.Module):
    """The networks of the detector; ``reference/detect.py`` runs them."""

    def __init__(self, c: dict):
        super().__init__()
        self.cfg = c
        self.backbone = ViT(c)
        self.neck = SimpleFPN(c["embed_dim"], c["fpn_channels"])
        self.rpn_head = RPNHead(c["fpn_channels"], c["rpn_convs"])
        self.roi_head = _Holder()
        self.roi_head.bbox_head = BBoxHead(c["fpn_channels"], c["num_classes"],
                                           c["box_convs"])

    def maps(self, images):
        return self.neck(self.backbone(images))
