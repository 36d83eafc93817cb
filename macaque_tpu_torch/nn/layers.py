"""Shared layers.

``Linear``/``Conv2d``/``ConvTranspose2d`` hold their weights in the layer's
compute dtype and cast the input to it, as a Flax ``Dense(dtype=...)`` does
with float32 parameters (same values: the cast happens once, at build or
load time, instead of at every call). ``FusedLayerNorm`` and
``BatchNorm2d`` keep float32 parameters and statistics.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """At least float32: the accumulation type for ``dtype`` inputs."""
    return torch.promote_types(dtype, torch.float32)


class Linear(nn.Linear):
    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x, output_size=None):
        return super().forward(x.to(self.weight.dtype), output_size)


class BatchNorm2d(nn.BatchNorm2d):
    """Inference BatchNorm computed in (at least) float32, float32 output."""

    def forward(self, x):
        return super().forward(x.to(acc_dtype(x.dtype)))


class FusedLayerNorm(nn.Module):
    """LayerNorm over the last axis: float32 statistics (E[x^2] - E[x]^2, as
    the JAX package computes them), float32 parameters, output in the
    input's dtype. State-dict keys ``weight``/``bias`` as ``nn.LayerNorm``."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        x32 = x.to(acc_dtype(x.dtype))
        mean = x32.mean(-1, keepdim=True)
        var = (x32 * x32).mean(-1, keepdim=True) - mean * mean
        inv = torch.rsqrt(var.clamp_min(0.0) + self.eps)
        return ((x32 - mean) * inv * self.weight + self.bias).to(x.dtype)


def nhwc_conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW convolution to a channels-last (B, H, W, C) tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approximate else "none")
