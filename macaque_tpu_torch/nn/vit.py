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
serving tiers).
Inputs and outputs are channels-last, as in the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch
from torch import nn

from macaque_tpu_torch.nn.attention import (
    packed_attention, packed_attention_reference)
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
    """Block Dense layer: the int8 serving layer or the float Linear."""
    if cfg.quantize == "int8":
        return Int8Linear(cin, cout, device=device)
    return Linear(cin, cout, device=device, dtype=cfg.compute_dtype)


class Attention(nn.Module):
    def __init__(self, cfg: VitPoseConfig, device=None):
        super().__init__()
        self.heads = cfg.num_heads
        self.use_kernel = cfg.use_pallas_attention
        self.qkv = _dense(cfg, cfg.embed_dim, 3 * cfg.embed_dim, device)
        self.proj = _dense(cfg, cfg.embed_dim, cfg.embed_dim, device)

    def forward(self, x):
        attend = packed_attention if self.use_kernel else \
            packed_attention_reference
        return self.proj(attend(self.qkv(x), self.heads))


class FFN(nn.Module):
    def __init__(self, cfg: VitPoseConfig, device=None):
        super().__init__()
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        self.approx = cfg._gelu_approx
        self.layers = nn.ModuleList([
            nn.Sequential(_dense(cfg, cfg.embed_dim, hidden, device)),
            _dense(cfg, hidden, cfg.embed_dim, device)])

    def forward(self, x):
        return self.layers[1](gelu(self.layers[0](x), self.approx))


class Block(nn.Module):
    def __init__(self, cfg: VitPoseConfig, device=None):
        super().__init__()
        self.ln1 = FusedLayerNorm(cfg.embed_dim, cfg.ln_eps, device)
        self.attn = Attention(cfg, device)
        self.ln2 = FusedLayerNorm(cfg.embed_dim, cfg.ln_eps, device)
        self.ffn = FFN(cfg, device)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
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
