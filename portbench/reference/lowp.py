"""Quantized arithmetic for the reference: the serving tier's int8 pose
blocks, and the lower-precision control.

Symmetric scaling, as published for int8 serving: weights per output
channel, ``scale = max|w| / qmax`` and codes ``round(w / scale)``;
activations per row (per sample for a convolution), computed on the fly,
``s = max(max|x|, 1e-8) / qmax``. qmax is 127 for int8 and 7 for int4.
fp8 (e4m3) scales the same way to its largest value, 448, and rounds to
its 3 mantissa bits. Everything is computed in float32 on the values the
codes stand for: a product of int8 codes is exact up to float32's
rounding of its sum.

``quantize_pose_blocks_`` gives the ViT blocks' four Linear layers the
serving tier's int8 scheme. ``lower_`` puts a network one precision step
under the one the program states, every Linear and convolution with its
weights and inputs quantized: fp8 for the layers the program runs in
bfloat16 (the nearest format below it), int4 for its int8 layers. It is
the output check's control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

QMAX = {"int8": 127.0, "int4": 7.0}
FP8_MAX = 448.0


def fake_quant(x: torch.Tensor, fmt: str, dims, eps: float = 1e-8):
    """``x`` as the values of its ``fmt`` codes, scaled over ``dims``."""
    amax = x.abs().amax(dims, keepdim=True).clamp_min(eps)
    if fmt == "fp8":
        s = amax / FP8_MAX
        return (x / s).to(torch.float8_e4m3fn).float() * s
    q = QMAX[fmt]
    s = amax / q
    return torch.round(x / s).clamp(-q, q) * s


class QuantLinear(nn.Module):
    def __init__(self, lin: nn.Linear, fmt: str):
        super().__init__()
        self.fmt = fmt
        self.register_buffer("weight", fake_quant(lin.weight.detach().float(),
                                                  fmt, 1, 1e-12))
        self.register_buffer("bias", None if lin.bias is None
                             else lin.bias.detach().float().clone())

    def forward(self, x):
        return F.linear(fake_quant(x, self.fmt, -1), self.weight, self.bias)


def _swap_linears(model: nn.Module, fmt: str) -> None:
    for name, child in list(model.named_children()):
        if isinstance(child, nn.Linear):
            setattr(model, name, QuantLinear(child, fmt))
        else:
            _swap_linears(child, fmt)


def quantize_pose_blocks_(vit: nn.Module, fmt: str = "int8") -> nn.Module:
    """The four Linear layers of every ViT block (qkv, proj, fc1, fc2) as
    ``QuantLinear``, in place: the serving tier's int8 pose."""
    for blk in vit.backbone.layers:
        _swap_linears(blk, fmt)
    return vit


def _conv_input(fmt):
    def hook(mod, args):
        return (fake_quant(args[0], fmt, (1, 2, 3)),)
    return hook


def lower_(model: nn.Module, fmt: str = "fp8") -> nn.Module:
    """Every remaining float Linear and convolution quantized to ``fmt``,
    weights and inputs, in place."""
    _swap_linears(model, fmt)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            out_dim = 1 if isinstance(m, nn.ConvTranspose2d) else 0
            dims = tuple(d for d in range(m.weight.dim()) if d != out_dim)
            m.weight.data = fake_quant(m.weight.data, fmt, dims, 1e-12)
            m.register_forward_pre_hook(_conv_input(fmt))
    return model


def tf32_off():
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
