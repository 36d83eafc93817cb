"""Swin Transformer backbone (Swin-S) in PyTorch.

The architecture of ``macaque_tpu/nn/swin.py`` (the reference detection
backbone): patch 4 with patch norm, embed 96, depths (2, 2, 18, 2), heads
(3, 6, 12, 24), window 7 with relative position bias, shifted windows on
odd blocks, MLP ratio 4, per-stage output norms, outputs at all 4 stages.
Module names follow mmdet's SwinTransformer
(``stages.2.blocks.5.attn.w_msa.qkv``); tensors are channels-last. The
window attention is plain PyTorch by default, as the JAX package's default
path is plain XLA; ``SwinConfig(use_pallas_attention=True)`` runs
``nn/attention.py::window_attention`` instead (the CUDA kernel on the card),
as the JAX switch runs its Pallas kernel. ``SwinConfig(quantize="int8")``
builds the block Dense layers as ``nn/quant.py::Int8Linear``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from macaque_tpu_torch.nn.attention import window_attention
from macaque_tpu_torch.nn.layers import Conv2d, FusedLayerNorm, Linear, gelu
from macaque_tpu_torch.nn.quant import Int8Linear


@dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: float = 4.0
    patch_size: int = 4
    ln_eps: float = 1e-5
    compute_dtype: Any = torch.float32
    use_pallas_attention: bool = False  # the window attention kernel
    # "int8": the block Dense layers (qkv/proj/fc1/fc2) as Int8Linear; load
    # quantized weights, or quantize a float model with quantize_swin_
    quantize: Any = None

    @property
    def out_channels(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * (2 ** i) for i in range(len(self.depths)))


def _rel_pos_index(window: int) -> np.ndarray:
    """(W^2, W^2) index into the (2W-1)^2 relative bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def _shift_mask(H, W, w, shift) -> np.ndarray:
    """Attention mask for shifted windows (standard Swin construction)."""
    img = np.zeros((H, W))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(H // w, w, W // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    diff = img[:, :, None] - img[:, None, :]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _window_partition(x, w):
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)


def _window_merge(x, w, B, H, W):
    C = x.shape[-1]
    x = x.reshape(B, H // w, W // w, w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def _dense(cfg: SwinConfig, cin: int, cout: int, device=None):
    """Block Dense layer, switchable to the int8 serving layer."""
    if cfg.quantize == "int8":
        return Int8Linear(cin, cout, device=device)
    return Linear(cin, cout, device=device, dtype=cfg.compute_dtype)


class WindowMSA(nn.Module):
    def __init__(self, cfg: SwinConfig, dim: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.use_kernel = cfg.use_pallas_attention
        self.qkv = _dense(cfg, dim, 3 * dim, device)
        self.proj = _dense(cfg, dim, dim, device)
        self.relative_position_bias_table = nn.Parameter(nn.init.trunc_normal_(
            torch.empty((2 * cfg.window - 1) ** 2, heads, device=device),
            std=0.02))
        self.register_buffer(
            "relative_position_index",
            torch.as_tensor(_rel_pos_index(cfg.window), device=device),
            persistent=False)

    def forward(self, x, mask=None):
        """x (B_, N, C), N = window^2; mask (nW, N, N) or None."""
        B_, N, C = x.shape
        hd = C // self.heads
        qkv = self.qkv(x)
        bias = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)].reshape(N, N, -1)
        if self.use_kernel:
            bias = bias.permute(2, 0, 1).to(torch.float32).contiguous()
            out = window_attention(qkv, bias, mask, self.heads)
            return self.proj(out)
        q, k, v = qkv.reshape(B_, N, 3, self.heads, hd).unbind(2)
        attn = torch.einsum("bnhd,bmhd->bhnm", q * hd ** -0.5, k)
        attn = attn + bias.permute(2, 0, 1)[None]          # float32 from here
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, self.heads, N, N)
                    + mask[None, :, None]).reshape(B_, self.heads, N, N)
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", attn.to(v.dtype), v)
        return self.proj(out.reshape(B_, N, C))


class ShiftWindowMSA(nn.Module):
    def __init__(self, cfg, dim, heads, device=None):
        super().__init__()
        self.w_msa = WindowMSA(cfg, dim, heads, device)


class SwinFFN(nn.Module):
    def __init__(self, cfg: SwinConfig, dim: int, hidden: int, device=None):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.Sequential(_dense(cfg, dim, hidden, device)),
            _dense(cfg, hidden, dim, device)])

    def forward(self, x):
        return self.layers[1](gelu(self.layers[0](x), approximate=False))


class SwinBlock(nn.Module):
    def __init__(self, cfg: SwinConfig, dim: int, heads: int, shift: int,
                 device=None):
        super().__init__()
        self.window, self.shift = cfg.window, shift
        self.norm1 = FusedLayerNorm(dim, cfg.ln_eps, device)
        self.attn = ShiftWindowMSA(cfg, dim, heads, device)
        self.norm2 = FusedLayerNorm(dim, cfg.ln_eps, device)
        self.ffn = SwinFFN(cfg, dim, int(dim * cfg.mlp_ratio), device)
        self._masks: dict = {}

    def _mask(self, Hp, Wp, device):
        key = (Hp, Wp, str(device))
        if key not in self._masks:
            self._masks[key] = torch.as_tensor(
                _shift_mask(Hp, Wp, self.window, self.shift), device=device)
        return self._masks[key]

    def forward(self, x):
        B, H, W, C = x.shape
        w, s = self.window, self.shift
        shortcut = x
        x = self.norm1(x)
        pad_h, pad_w = (w - H % w) % w, (w - W % w) % w
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        Hp, Wp = H + pad_h, W + pad_w
        mask = None
        if s > 0:
            x = torch.roll(x, (-s, -s), dims=(1, 2))
            mask = self._mask(Hp, Wp, x.device)
        x = self.attn.w_msa(_window_partition(x, w), mask)
        x = _window_merge(x, w, B, Hp, Wp)
        if s > 0:
            x = torch.roll(x, (s, s), dims=(1, 2))
        x = shortcut + x[:, :H, :W]
        return x + self.ffn(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, cfg: SwinConfig, dim: int, device=None):
        super().__init__()
        self.norm = FusedLayerNorm(4 * dim, cfg.ln_eps, device)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, device=device,
                                dtype=cfg.compute_dtype)

    def forward(self, x):
        B, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        Hp, Wp = x.shape[1], x.shape[2]
        # channel order [(dy, dx)] = (0,0), (1,0), (0,1), (1,1), as the JAX
        # package's merge
        x = x.reshape(B, Hp // 2, 2, Wp // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
        return self.reduction(self.norm(x.reshape(B, Hp // 2, Wp // 2, 4 * C)))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SwinConfig, device=None):
        super().__init__()
        p = cfg.patch_size
        self.projection = Conv2d(3, cfg.embed_dim, p, p, device=device,
                                 dtype=cfg.compute_dtype)
        self.norm = FusedLayerNorm(cfg.embed_dim, cfg.ln_eps, device)

    def forward(self, x):                          # (B, H, W, 3)
        return self.norm(self.projection(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))


class SwinStage(nn.Module):
    def __init__(self, cfg: SwinConfig, stage: int, device=None):
        super().__init__()
        dim = cfg.embed_dim * (2 ** stage)
        self.blocks = nn.ModuleList([
            SwinBlock(cfg, dim, cfg.num_heads[stage],
                      0 if b % 2 == 0 else cfg.window // 2, device)
            for b in range(cfg.depths[stage])])
        self.downsample = (PatchMerging(cfg, dim, device)
                           if stage < len(cfg.depths) - 1 else None)


class SwinBackbone(nn.Module):
    def __init__(self, cfg: SwinConfig = SwinConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg, device)
        self.stages = nn.ModuleList([SwinStage(cfg, s, device)
                                     for s in range(len(cfg.depths))])
        for s, ch in enumerate(cfg.out_channels):
            setattr(self, f"norm{s}", FusedLayerNorm(ch, cfg.ln_eps, device))

    def forward(self, x):
        """x (B, H, W, 3) normalized -> 4 maps at strides 4, 8, 16, 32."""
        x = self.patch_embed(x)
        outs = []
        for s, stage in enumerate(self.stages):
            for blk in stage.blocks:
                x = blk(x)
            outs.append(getattr(self, f"norm{s}")(x))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs
