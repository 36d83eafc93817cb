"""int8 serving layers: weight and dynamic-activation int8 on the block
Dense layers of ViTPose (and, opt-in, Swin).

The scheme of ``macaque_tpu/nn/quant.py``: weights symmetric per output
channel (``wscale = max(max|w|, 1e-12) / 127``, codes ``round(w / wscale)``),
activations symmetric per row, computed on the fly
(``s = max(max|x|, 1e-8) * (1/127)``), int32 accumulation, dequantization
``(acc * s) * wscale``. Everything else (LayerNorm, attention, patch embed,
heads) stays in the float path.

``Int8Linear`` picks its route from where its input lies and from K:
  * on the CPU it runs ``int8_matmul_reference``, the chain of the JAX
    package's default tier (``Int8Dense`` with ``int8_impl="auto"``, which
    ``vit.py:76`` maps to "xla"): dequantize, cast to the input dtype, then
    add the bias in that dtype;
  * on CUDA it runs the split route where K <= 2048 (K5a, then
    ``torch._int_mm`` and the epilogue: ``nn/int8.py::quant_int8_matmul_split``,
    the JAX package's "pallas" route at these K) and the fused kernel K5b
    above (``nn/int8.py::quant_int8_matmul``). On the H100 the split route
    is the faster of the two at K = 1280 (``chip_smoke.py`` times both).
Both card routes add the bias in float32 before the cast, in one fused
multiply-add with the last scale, as the JAX package's split scheme and its
fused Pallas kernel do (``pallas_int8.py:93-94``). The JAX model never runs
that fused kernel (only ``macaque_tpu/tools/int8_probe.py`` calls it), and
its default tier adds the bias after the cast: the card's int8 layers agree
with it exactly in float32 and can differ from it by one bf16 ulp in
bfloat16.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from macaque_tpu_torch.nn.int8 import (
    dequantize, int_dot_reference, quant_int8_matmul, quant_int8_matmul_split,
    quantize_rows_reference)

SPLIT_MAX_K = 2048        # the split route up to this K on the card


def int8_matmul_reference(x, weight_q, wscale, bias=None) -> torch.Tensor:
    """The JAX package's ``int8_matmul`` chain plus ``Int8Dense``'s bias:
    x (..., K) float -> (..., N) in x.dtype, bias added after the cast."""
    lead, K = x.shape[:-1], x.shape[-1]
    xq, s = quantize_rows_reference(x.reshape(-1, K))
    out = dequantize(int_dot_reference(xq, weight_q), s, wscale, None, x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.reshape(*lead, weight_q.shape[0])


def quantize_dense(weight: torch.Tensor):
    """Linear weight (N, K) -> (weight_q int8 (N, K), wscale f32 (N,)),
    computed from its float32 values."""
    w = weight.detach().to(torch.float32)
    wscale = w.abs().amax(1).clamp_min(1e-12) / 127.0
    weight_q = torch.round(w / wscale[:, None]).clamp(-127, 127).to(torch.int8)
    return weight_q, wscale


class Int8Linear(nn.Module):
    """The counterpart of ``Int8Dense``: buffers ``weight_q`` int8 (N, K),
    ``wscale`` f32 (N,) and ``bias`` f32 (N,) (zeros until loaded); output in
    the input's dtype. ``route`` is what it runs on the card: "split"
    where K <= ``SPLIT_MAX_K``, else "fused"."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.route = "split" if in_features <= SPLIT_MAX_K else "fused"
        self.register_buffer("weight_q", torch.zeros(
            (out_features, in_features), dtype=torch.int8, device=device))
        self.register_buffer("wscale", torch.ones(out_features, device=device))
        self.register_buffer("bias", torch.zeros(out_features, device=device)
                             if bias else None)

    @classmethod
    def from_weights(cls, weight, bias=None):
        """Quantize a float weight (N, K) (and keep a float32 bias)."""
        m = cls(weight.shape[1], weight.shape[0], bias is not None,
                weight.device)
        m.weight_q, m.wscale = quantize_dense(weight)
        if bias is not None:
            m.bias = bias.detach().to(torch.float32).clone()
        return m

    def forward(self, x):
        if x.device.type == "cpu":
            return int8_matmul_reference(x, self.weight_q, self.wscale, self.bias)
        if self.route == "split":
            return quant_int8_matmul_split(x, self.weight_q, self.wscale,
                                           self.bias)
        return quant_int8_matmul(x, self.weight_q, self.wscale, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, bias={self.bias is not None}, "
                f"route={self.route!r}")


def _swap(parent: nn.Module, name: str, key: str, source) -> None:
    """Replace ``parent.<name>`` (a Linear, or a one-Linear Sequential) with
    an Int8Linear quantized from ``source[key + '.weight']`` where given, else
    from the layer's own weight."""
    holder, attr = parent, name
    lin = getattr(parent, name)
    if isinstance(lin, nn.Sequential):
        holder, attr, lin = lin, "0", lin[0]
    weight, bias = lin.weight, lin.bias
    if source is not None:
        weight = source[f"{key}.weight"].to(weight.device)
        bias = source.get(f"{key}.bias", bias)
    if bias is not None:
        bias = bias.to(lin.weight.device)
    setattr(holder, attr, Int8Linear.from_weights(weight, bias))


def quantize_vitpose_(model, source: dict | None = None):
    """Swap every ViTPose block's qkv/proj/fc1/fc2 Linear for an Int8Linear,
    in place, and set the model's config to ``quantize="int8"`` (which also
    switches its GELU to the tanh form, as in the JAX package). ``source``, a
    float state dict (a checkpoint), supplies the float32 weights to
    quantize; without it each layer's own weight is used. Returns the
    model."""
    cfg = dataclasses.replace(model.cfg, quantize="int8")
    for i, blk in enumerate(model.backbone.layers):
        p = f"backbone.layers.{i}"
        _swap(blk.attn, "qkv", f"{p}.attn.qkv", source)
        _swap(blk.attn, "proj", f"{p}.attn.proj", source)
        _swap(blk.ffn.layers, "0", f"{p}.ffn.layers.0.0", source)
        _swap(blk.ffn.layers, "1", f"{p}.ffn.layers.1", source)
        blk.ffn.approx = cfg._gelu_approx
    model.cfg = cfg
    return model


def quantize_swin_(model):
    """Swap the qkv/proj/fc1/fc2 Linear of every Swin block for an
    Int8Linear quantized from its own weight, in place, in a SwinMaskRCNN
    (its ``backbone``) or a bare SwinBackbone, and set the backbone's config
    to ``quantize="int8"``. The patch embedding, patch merging, FPN and
    heads stay in the float path. Returns the model."""
    bb = model.backbone if hasattr(model, "backbone") else model
    for stage in bb.stages:
        for blk in stage.blocks:
            msa = blk.attn.w_msa
            for parent, name in ((msa, "qkv"), (msa, "proj"),
                                 (blk.ffn.layers, "0"), (blk.ffn.layers, "1")):
                _swap(parent, name, None, None)
    bb.cfg = dataclasses.replace(bb.cfg, quantize="int8")
    return model
