"""int8 serving layers: weight and dynamic-activation int8 on the block
Dense layers of ViTPose (and, opt-in, Swin).

The scheme of ``macaque_tpu/nn/quant.py``: weights symmetric per output
channel (``wscale = max(max|w|, 1e-12) / 127``, codes ``round(w / wscale)``),
activations symmetric per row, computed on the fly
(``s = max(max|x|, 1e-8) * (1/127)``), int32 accumulation, dequantization
``(acc * s) * wscale``. Everything else (LayerNorm, attention, patch embed,
heads) stays in the float path.

``Int8Linear`` picks its route from where its input lies:
  * on the CPU it runs ``int8_matmul_reference``, the chain of the JAX
    package's default tier (``Int8Dense`` with ``int8_impl="auto"``, which
    ``vit.py:76`` maps to "xla"): dequantize, cast to the input dtype, then
    add the bias in that dtype;
  * on CUDA it runs K5b at every K (``nn/int8.py::quant_int8_matmul``: the
    row quantizer, then the int8 GEMM). On the H100 K5b is faster than the
    split route (K5a, ``torch._int_mm`` and the epilogue,
    ``nn/int8.py::quant_int8_matmul_split``) at all four ViTPose-huge
    widths, K = 1280 included (``chip_smoke.py`` times both).
On the card K5b computes the same chain, ``(acc * s) * wscale`` cast to
the input dtype and then the bias added in that dtype (its ``out_bias``
epilogue), so the card and the CPU give the same bits.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from macaque_tpu_torch.nn.int8 import (
    quant_int8_matmul, quant_int8_matmul_reference)


def int8_matmul_reference(x, weight_q, wscale, bias=None) -> torch.Tensor:
    """The JAX package's ``int8_matmul`` chain plus ``Int8Dense``'s bias:
    x (..., K) float -> (..., N) in x.dtype, bias added after the cast."""
    return quant_int8_matmul_reference(x, weight_q, wscale, None, bias)


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
    the input's dtype. On the card it runs K5b (``quant_int8_matmul``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
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
        # K5b on the card, int8_matmul_reference's chain on the CPU
        return quant_int8_matmul(x, self.weight_q, self.wscale, None,
                                 self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, bias={self.bias is not None}")


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


def _quantize_layers_(layers, source, what: str) -> None:
    """Swap each (parent, name, key) layer. The codes come from float32
    weights, as the JAX quantizers read them: from ``source`` where given,
    else from the layers' own weights, which must then be float32 (a bf16
    model's weights are already rounded)."""
    if source is None:
        for parent, name, _ in layers:
            lin = getattr(parent, name)
            w = (lin[0] if isinstance(lin, nn.Sequential) else lin).weight
            if w.dtype != torch.float32:
                raise ValueError(
                    f"{what}: the model's weights are {w.dtype}; pass the "
                    "float32 state dict as source")
    for parent, name, key in layers:
        _swap(parent, name, key, source)


def quantize_vitpose_(model, source: dict | None = None):
    """Swap every ViTPose block's qkv/proj/fc1/fc2 Linear for an Int8Linear,
    in place, and set the model's config to ``quantize="int8"`` (which also
    switches its GELU to the tanh form, as in the JAX package). ``source``, a
    float state dict (a checkpoint), supplies the float32 weights to
    quantize; without it each layer's own weight is used, and a model whose
    weights are not float32 is refused. Returns the model."""
    cfg = dataclasses.replace(model.cfg, quantize="int8")
    layers = []
    for i, blk in enumerate(model.backbone.layers):
        p = f"backbone.layers.{i}"
        layers += [(blk.attn, "qkv", f"{p}.attn.qkv"),
                   (blk.attn, "proj", f"{p}.attn.proj"),
                   (blk.ffn.layers, "0", f"{p}.ffn.layers.0.0"),
                   (blk.ffn.layers, "1", f"{p}.ffn.layers.1")]
    _quantize_layers_(layers, source, "quantize_vitpose_")
    for blk in model.backbone.layers:
        blk.ffn.approx = cfg._gelu_approx
    model.cfg = cfg
    return model


def quantize_swin_(model, source: dict | None = None):
    """Swap the qkv/proj/fc1/fc2 Linear of every Swin block for an
    Int8Linear, in place, in a SwinMaskRCNN (its ``backbone``) or a bare
    SwinBackbone, and set the backbone's config to ``quantize="int8"``.
    ``source``, the model's float state dict (a checkpoint: keys
    ``backbone.stages...`` for a SwinMaskRCNN, ``stages...`` for a bare
    backbone), supplies the float32 weights to quantize; without it each
    layer's own weight is used, and a model whose weights are not float32 is
    refused. The patch embedding, patch merging, FPN and heads stay in the
    float path. Returns the model."""
    bb, prefix = ((model.backbone, "backbone.") if hasattr(model, "backbone")
                  else (model, ""))
    layers = []
    for s, stage in enumerate(bb.stages):
        for b, blk in enumerate(stage.blocks):
            msa, p = blk.attn.w_msa, f"{prefix}stages.{s}.blocks.{b}"
            layers += [(msa, "qkv", f"{p}.attn.w_msa.qkv"),
                       (msa, "proj", f"{p}.attn.w_msa.proj"),
                       (blk.ffn.layers, "0", f"{p}.ffn.layers.0.0"),
                       (blk.ffn.layers, "1", f"{p}.ffn.layers.1")]
    _quantize_layers_(layers, source, "quantize_swin_")
    bb.cfg = dataclasses.replace(bb.cfg, quantize="int8")
    return model
