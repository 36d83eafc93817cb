"""Shared layers.

``Linear``/``Conv2d``/``ConvTranspose2d`` hold their weights in the layer's
compute dtype and cast the input to it, as a Flax ``Dense(dtype=...)`` does
with float32 parameters (same values: the cast happens once, at build or
load time, instead of at every call). ``FusedLayerNorm`` and
``BatchNorm2d`` keep float32 parameters and statistics.

:func:`make_trainable` turns a built model into one that trains as Flax
does: float32 parameters cast to each layer's compute dtype at every call
(``param_dtype`` float32), gradients on, and ``BatchNorm2d`` normalizing
with the batch's statistics while it updates its running ones.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from macaque_tpu_torch.nn.quant import Int8Linear


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """At least float32: the accumulation type for ``dtype`` inputs."""
    return torch.promote_types(dtype, torch.float32)


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    # None: the weight's own dtype (inference); set by make_trainable
    compute_dtype = None

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv2d(nn.Conv2d):
    compute_dtype = None

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt))


class ConvTranspose2d(nn.ConvTranspose2d):
    compute_dtype = None

    def forward(self, x, output_size=None):
        dt = self.compute_dtype or self.weight.dtype
        pad = self._output_padding(x, output_size, self.stride, self.padding,
                                   self.kernel_size, 2, self.dilation)
        return F.conv_transpose2d(
            x.to(dt), self.weight.to(dt), _cast(self.bias, dt), self.stride,
            self.padding, pad, self.groups, self.dilation)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm computed in (at least) float32, float32 output. In eval
    mode it normalizes with the running statistics. In training mode it
    follows Flax's ``BatchNorm(momentum=0.9)``: the batch's mean and
    biased variance ``E[x^2] - E[x]^2`` (clamped at 0) normalize the input,
    and the running statistics move by ``0.9 * old + 0.1 * batch``, in
    place. (``nn.BatchNorm2d`` in training would update ``running_var``
    with the unbiased variance.)"""

    def forward(self, x):
        x = x.to(acc_dtype(x.dtype))
        if not self.training:
            return super().forward(x)
        mean = x.mean((0, 2, 3))
        var = ((x * x).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = 1.0 - self.momentum          # Flax's momentum, 0.9
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]


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


class LayerNorm(FusedLayerNorm):
    """:class:`FusedLayerNorm` in one pass: ``F.layer_norm`` of the input in
    its own dtype, which computes the statistics (Welford's, not ``E[x^2] -
    E[x]^2``) and the affine map in float32 and writes the input's dtype.
    The kernel takes the scale and shift in the input's dtype, so they are
    cast to it at each call (the float32 parameters stay as loaded). On a
    bf16 map it reads the input once and writes it once, where the float32
    chain of the parent makes a float32 copy and several float32 passes.
    ViTDet's norms. ViTPose and Swin-S keep the parent: this one moves
    their outputs by float32 rounding (the benchmark pins their check
    numbers bit for bit), and on the card it would round a checkpoint's
    float32 scale and shift to bf16, where the JAX package keeps them
    float32."""

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class LayerNorm2d(LayerNorm):
    """mmdet's ``LN2d`` (detectron2's ``LayerNorm2d``): LayerNorm over the
    channels of a map at each position. On the port's channels-last
    (B, H, W, C) maps the channels are the last axis, so it is
    :class:`LayerNorm` with mmdet's eps of 1e-6."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__(dim, eps, device)


def nhwc_conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW convolution to a channels-last (B, H, W, C) tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approximate else "none")


def make_trainable(model: nn.Module) -> nn.Module:
    """Make a built model train as Flax does, in place, and return it: each
    ``Linear``/``Conv2d``/``ConvTranspose2d`` keeps its dtype as its compute
    dtype and its parameters become float32 (cast at every call), every
    parameter requires grad, and the model goes into training mode
    (``BatchNorm2d`` on batch statistics, with torch's default momentum
    0.1, which is Flax's 0.9).
    Int8 serving layers hold no trainable weights and are refused."""
    for m in model.modules():
        if isinstance(m, Int8Linear):
            raise ValueError("make_trainable: an int8 serving model does not "
                             "train; build the float model")
        if isinstance(m, (Linear, Conv2d, ConvTranspose2d)) \
                and m.compute_dtype is None:
            m.compute_dtype = m.weight.dtype
    for p in model.parameters():
        p.data = p.data.to(torch.float32)
    return model.requires_grad_(True).train()
