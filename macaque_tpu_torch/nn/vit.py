"""ViTPose: plain ViT backbone + deconv heatmap head, in PyTorch.

The architecture of ``macaque_tpu/nn/vit.py`` (the reference's
td-hm_ViTPose-huge config): ViT-huge (depth 32, width 1280, 16 heads,
MLP 5120, patch 16 with conv padding 2, no cls token, learned pos-embed,
final LN) and a HeatmapHead of two 4x4 stride-2 deconvs (256 ch,
BN+ReLU) and a 1x1 conv to 17 heatmaps at 64x48. Module names follow
mmpose, so its ``state_dict`` keys are those of a released checkpoint.
With ``VitPoseConfig(use_pallas_attention=True)`` (what the serving
builders set on the card) the attention runs
``nn/attention.py::packed_attention`` (the CUDA kernel on the card); with
the default ``False`` it runs the plain, differentiable
``packed_attention_reference``, JAX's ``jax.nn.dot_product_attention``
numerics (the path training takes). ``VitPoseConfig(quantize="int8")``
builds the block Dense layers as ``nn/quant.py::Int8Linear`` (the int8
serving tiers). ``Attention`` and ``Block`` take ViTDet's options too
(windowed or global attention on a map, decomposed relative position:
``nn/vitdet.py``); their defaults are the ViTPose path.
Inputs and outputs are channels-last, as in the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from macaque_tpu_torch.core.trace import count
from macaque_tpu_torch.nn.attention import (
    packed_attention, packed_attention_reference, relpos_attention,
    relpos_attention_reference)
from macaque_tpu_torch.nn.layers import (
    BatchNorm2d, Conv2d, ConvTranspose2d, FusedLayerNorm, Linear, gelu)
from macaque_tpu_torch.nn.quant import Int8Linear


@dataclass(frozen=True)
class VitPoseConfig:
    img_size: Tuple[int, int] = (256, 192)  # (H, W)
    patch_size: int = 16
    patch_padding: int = 2
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_keypoints: int = 17
    deconv_channels: Tuple[int, ...] = (256, 256)
    ln_eps: float = 1e-6
    compute_dtype: Any = torch.float32
    use_pallas_attention: bool = False  # the packed attention kernel (K1)
    # "int8": weight + dynamic-activation int8 on the block Dense layers
    # (nn/quant.py; load quantized weights or use quantize_vitpose_). None:
    # the float path.
    quantize: Any = None

    @property
    def _gelu_approx(self) -> bool:
        """tanh-approximated GELU in bf16 and int8, exact erf in f32: the
        JAX package's default (vit.py:58-62)."""
        return self.compute_dtype == torch.bfloat16 or self.quantize == "int8"

    @property
    def grid(self) -> Tuple[int, int]:
        p, pad = self.patch_size, self.patch_padding
        return ((self.img_size[0] + 2 * pad - p) // p + 1,
                (self.img_size[1] + 2 * pad - p) // p + 1)


def _dense(cfg: VitPoseConfig, cin: int, cout: int, device=None):
    """Block Dense layer: the int8 serving layer or the float Linear (a
    config without ``quantize``, as ViTDet's, is float)."""
    if getattr(cfg, "quantize", None) == "int8":
        return Int8Linear(cin, cout, device=device)
    return Linear(cin, cout, device=device, dtype=cfg.compute_dtype)


def _rel_table(table: torch.Tensor, g: int) -> torch.Tensor:
    """(2g - 1, d) table -> (g, g, d): entry [i, j] = table[i - j + g - 1],
    detectron2's ``get_rel_pos`` where queries and keys share one grid."""
    idx = (torch.arange(g, device=table.device)[:, None]
           - torch.arange(g, device=table.device)[None, :] + g - 1)
    return table[idx]


def window_partition(x: torch.Tensor, w: int):
    """(B, H, W, C) -> ((B * nW, w, w, C) windows, (Hp, Wp)): the map
    zero-padded at the bottom and right to whole windows, then cut into
    them row by row (detectron2's ``window_partition``)."""
    B, H, W, C = x.shape
    ph, pw = (w - H % w) % w, (w - W % w) % w
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // w, w, Wp // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w, w, C), (Hp, Wp)


def window_unpartition(x: torch.Tensor, w: int, padded, hw) -> torch.Tensor:
    """The inverse of :func:`window_partition`, cropped back to ``hw``."""
    Hp, Wp = padded
    H, W = hw
    C = x.shape[-1]
    B = x.shape[0] // (Hp // w * (Wp // w))
    x = x.reshape(B, Hp // w, Wp // w, w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, C)[:, :H, :W]


class Attention(nn.Module):
    """Multi-head attention over the packed qkv Dense output. With
    ``rel_pos`` = (gh, gw) the tokens are a gh x gw grid and the scores take
    ViTDet's decomposed relative position (``rel_pos_h``, ``rel_pos_w``):
    the float32 factors ``q . Rh`` and ``q . Rw`` (q unscaled) are one
    product each, and the attention is ``nn/attention.py``'s
    ``relpos_attention`` (K7 on the card) or its plain version."""

    def __init__(self, cfg: VitPoseConfig, device=None, rel_pos=None):
        super().__init__()
        self.heads = cfg.num_heads
        self.use_kernel = cfg.use_pallas_attention
        self.qkv = _dense(cfg, cfg.embed_dim, 3 * cfg.embed_dim, device)
        self.proj = _dense(cfg, cfg.embed_dim, cfg.embed_dim, device)
        self.rel_pos = rel_pos
        if rel_pos is not None:
            hd = cfg.embed_dim // cfg.num_heads
            self.rel_pos_h = nn.Parameter(
                torch.zeros(2 * rel_pos[0] - 1, hd, device=device))
            self.rel_pos_w = nn.Parameter(
                torch.zeros(2 * rel_pos[1] - 1, hd, device=device))

    def forward(self, x):
        if self.rel_pos is not None:
            return self.proj(self._relpos_attention(self.qkv(x)))
        attend = packed_attention if self.use_kernel else \
            packed_attention_reference
        return self.proj(attend(self.qkv(x), self.heads))

    def _relpos_attention(self, qkv):
        B, T, C3 = qkv.shape
        gh, gw = self.rel_pos
        n = self.heads
        q = qkv[..., :C3 // 3].reshape(B, gh, gw, n, -1).to(torch.float32)
        rel_h = torch.einsum("bhwnc,hkc->bnhwk", q,
                             _rel_table(self.rel_pos_h, gh))
        rel_w = torch.einsum("bhwnc,wkc->bnhwk", q,
                             _rel_table(self.rel_pos_w, gw))
        attend = relpos_attention if self.use_kernel else \
            relpos_attention_reference
        return attend(qkv, rel_h.reshape(B, n, T, gh).contiguous(),
                      rel_w.reshape(B, n, T, gw).contiguous(), n)


class FFN(nn.Module):
    def __init__(self, cfg: VitPoseConfig, device=None):
        super().__init__()
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        # the exact GELU for a config without the property (ViTDet's)
        self.approx = getattr(cfg, "_gelu_approx", False)
        self.layers = nn.ModuleList([
            nn.Sequential(_dense(cfg, cfg.embed_dim, hidden, device)),
            _dense(cfg, hidden, cfg.embed_dim, device)])

    def forward(self, x):
        return self.layers[1](gelu(self.layers[0](x), self.approx))


class Block(nn.Module):
    """A pre-norm ViT block. By default (ViTPose) it takes (B, N, C) tokens.
    With ``window`` (a window side) or ``rel_pos`` (the attention grid,
    ``Attention``'s option) it is ViTDet's block on a (B, H, W, C) map: the
    normed map attends in ``window`` x ``window`` windows (zero-padded to
    whole windows, not masked, cropped back before the residual add) or
    globally, each window block counting the tokens its padding adds as
    ``vit.window_pad_tokens``. ``norm`` is the class of its two norms."""

    def __init__(self, cfg: VitPoseConfig, device=None, window: int = 0,
                 rel_pos=None, norm=FusedLayerNorm):
        super().__init__()
        self.ln1 = norm(cfg.embed_dim, cfg.ln_eps, device)
        self.attn = Attention(cfg, device, rel_pos)
        self.ln2 = norm(cfg.embed_dim, cfg.ln_eps, device)
        self.ffn = FFN(cfg, device)
        self.window = window

    def forward(self, x):
        if self.window or self.attn.rel_pos is not None:
            return self._map_forward(x)
        x = x + self.attn(self.ln1(x))
        return x + self.ffn(self.ln2(x))

    def _map_forward(self, x):
        B, H, W, C = x.shape
        y = self.ln1(x)
        if self.window:
            y, padded = window_partition(y, self.window)
            count("vit.window_pad_tokens", B * (padded[0] * padded[1] - H * W))
        n, h, w, _ = y.shape
        y = self.attn(y.reshape(n, h * w, C)).reshape(n, h, w, C)
        if self.window:
            y = window_unpartition(y, self.window, padded, (H, W))
        x = x + y
        return x + self.ffn(self.ln2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: VitPoseConfig, device=None):
        super().__init__()
        self.projection = Conv2d(3, cfg.embed_dim, cfg.patch_size,
                                 cfg.patch_size, cfg.patch_padding,
                                 device=device, dtype=cfg.compute_dtype)

    def forward(self, x):                       # (B, 3, H, W)
        return self.projection(x)


class ViTBackbone(nn.Module):
    def __init__(self, cfg: VitPoseConfig, device=None):
        super().__init__()
        h, w = cfg.grid
        self.patch_embed = PatchEmbed(cfg, device)
        self.pos_embed = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(1, h * w, cfg.embed_dim, device=device), std=0.02))
        self.layers = nn.ModuleList([Block(cfg, device)
                                     for _ in range(cfg.depth)])
        self.ln1 = FusedLayerNorm(cfg.embed_dim, cfg.ln_eps, device)
        self._register_load_state_dict_pre_hook(self._drop_cls_slot)

    def _drop_cls_slot(self, state_dict, prefix, *args):
        # mmpose checkpoints may carry a cls-token slot in pos_embed
        pos = state_dict.get(prefix + "pos_embed")
        if pos is not None and pos.shape[1] == self.pos_embed.shape[1] + 1:
            state_dict[prefix + "pos_embed"] = pos[:, 1:]

    def forward(self, x):
        """x: (B, H, W, 3) normalized images -> (B, h, w, D) features."""
        x = self.patch_embed(x.permute(0, 3, 1, 2))
        B, D, h, w = x.shape
        x = x.flatten(2).transpose(1, 2)
        x = x + self.pos_embed.to(x.dtype)
        for blk in self.layers:
            x = blk(x)
        return self.ln1(x).reshape(B, h, w, D)


class HeatmapHead(nn.Module):
    """mmpose HeatmapHead: (ConvTranspose 4x4 s2 + BN + ReLU) per stage,
    then a float32 1x1 conv."""

    def __init__(self, cfg: VitPoseConfig, device=None):
        super().__init__()
        layers, cin = [], cfg.embed_dim
        for ch in cfg.deconv_channels:
            layers += [ConvTranspose2d(cin, ch, 4, 2, 1, bias=False,
                                       device=device, dtype=cfg.compute_dtype),
                       BatchNorm2d(ch, device=device), nn.ReLU()]
            cin = ch
        self.deconv_layers = nn.Sequential(*layers)
        self.final_layer = Conv2d(cin, cfg.num_keypoints, 1, device=device)

    def forward(self, x):                       # (B, h, w, D)
        x = self.final_layer(self.deconv_layers(x.permute(0, 3, 1, 2)))
        return x.permute(0, 2, 3, 1)


class ViTPose(nn.Module):
    """Top-down 2D pose network: (B, 256, 192, 3) normalized crops ->
    (B, 64, 48, 17) heatmaps. Built in inference mode;
    ``nn.layers.make_trainable`` puts it in training mode."""

    def __init__(self, cfg: VitPoseConfig = VitPoseConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = ViTBackbone(cfg, device)
        self.head = HeatmapHead(cfg, device)
        self.eval()
        self.requires_grad_(False)

    def forward(self, x):
        return self.head(self.backbone(x))
