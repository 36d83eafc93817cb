"""Weights carried across from the JAX package.

Each ``*_from_jax`` turns a Flax variable tree of ``macaque_tpu.nn`` (as
numpy-convertible arrays) into a ``state_dict`` of this package's model,
inverting the layout changes of ``macaque_tpu/nn/convert.py``:
  * Dense kernel (in, out) -> Linear weight (out, in); an int8 Dense
    subtree {kernel_q (in, out), wscale, bias} (``quantize_vitpose_params``,
    ``quantize_swin_params``) -> Int8Linear weight_q (out, in), wscale, bias;
  * Conv kernel (kh, kw, in, out) -> Conv2d weight (out, in, kh, kw);
  * ConvTranspose kernel (kh, kw, in, out), spatially flipped ->
    ConvTranspose2d weight (in, out, kh, kw);
  * BatchNorm {scale, bias} + {mean, var} -> weight, bias, running stats.
The keys are mmdet/mmpose/mmpretrain's, so the same dict layout is what a
released checkpoint holds.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _linear(sd, key, p):
    if "kernel_q" in p:
        sd[f"{key}.weight_q"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(p["kernel_q"], np.int8).T))
        sd[f"{key}.wscale"] = _t(p["wscale"])
        if "bias" in p:
            sd[f"{key}.bias"] = _t(p["bias"])
        return
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _conv(sd, key, p):
    sd[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _deconv(sd, key, p):
    w = np.transpose(np.asarray(p["kernel"]), (2, 3, 0, 1))[:, :, ::-1, ::-1]
    sd[f"{key}.weight"] = _t(w)


def _ln(sd, key, p):
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _bn(sd, key, p, s):
    _ln(sd, key, p)
    sd[f"{key}.running_mean"] = _t(s["mean"])
    sd[f"{key}.running_var"] = _t(s["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0)


def vitpose_from_jax(variables) -> dict:
    """``macaque_tpu.nn.vit.ViTPose`` variables -> ``nn.vit.ViTPose``
    state_dict."""
    prm, st = variables["params"], variables["batch_stats"]
    bb, hd, hs = prm["backbone"], prm["head"], st["head"]
    sd: dict = {}
    _conv(sd, "backbone.patch_embed.projection", bb["patch_embed"])
    sd["backbone.pos_embed"] = _t(bb["pos_embed"])
    depth = sum(k.startswith("block") for k in bb)
    for i in range(depth):
        b, p = bb[f"block{i}"], f"backbone.layers.{i}"
        _ln(sd, f"{p}.ln1", b["ln1"])
        _linear(sd, f"{p}.attn.qkv", b["attn"]["qkv"])
        _linear(sd, f"{p}.attn.proj", b["attn"]["proj"])
        _ln(sd, f"{p}.ln2", b["ln2"])
        _linear(sd, f"{p}.ffn.layers.0.0", b["fc1"])
        _linear(sd, f"{p}.ffn.layers.1", b["fc2"])
    _ln(sd, "backbone.ln1", bb["ln_final"])
    n_deconv = sum(k.startswith("deconv") for k in hd)
    for j in range(n_deconv):
        _deconv(sd, f"head.deconv_layers.{3 * j}", hd[f"deconv{j}"])
        _bn(sd, f"head.deconv_layers.{3 * j + 1}", hd[f"bn{j}"], hs[f"bn{j}"])
    _conv(sd, "head.final_layer", hd["final"])
    return sd


def resnet_from_jax(variables) -> dict:
    """``macaque_tpu.nn.resnet.ResNetClassifier`` variables ->
    ``nn.resnet.ResNetClassifier`` state_dict."""
    prm, st = variables["params"], variables["batch_stats"]
    sd: dict = {}
    _conv(sd, "backbone.conv1", prm["stem_conv"])
    _bn(sd, "backbone.bn1", prm["stem_bn"], st["stem_bn"])
    for name, layer in prm.items():
        if not name.startswith("layer"):
            continue
        stage, b = name[len("layer"):].split("_")
        p, ls = f"backbone.layer{stage}.{b}", st[name]
        for c in (1, 2, 3):
            _conv(sd, f"{p}.conv{c}", layer[f"conv{c}"])
            _bn(sd, f"{p}.bn{c}", layer[f"bn{c}"], ls[f"bn{c}"])
        if "ds_conv" in layer:
            _conv(sd, f"{p}.downsample.0", layer["ds_conv"])
            _bn(sd, f"{p}.downsample.1", layer["ds_bn"], ls["ds_bn"])
    _linear(sd, "head.fc", prm["fc"])
    return sd


def swin_maskrcnn_from_jax(variables) -> dict:
    """``macaque_tpu.nn.detector.SwinMaskRCNN`` variables ->
    ``nn.detector.SwinMaskRCNN`` state_dict."""
    prm = variables["params"]
    bb = prm["backbone"]
    sd: dict = {}
    _conv(sd, "backbone.patch_embed.projection", bb["patch_embed"])
    _ln(sd, "backbone.patch_embed.norm", bb["patch_norm"])
    for name, blk in bb.items():
        if "_block" not in name:
            continue
        s, b = name[len("stage"):].split("_block")
        p = f"backbone.stages.{s}.blocks.{b}"
        _ln(sd, f"{p}.norm1", blk["ln1"])
        _linear(sd, f"{p}.attn.w_msa.qkv", blk["attn"]["qkv"])
        _linear(sd, f"{p}.attn.w_msa.proj", blk["attn"]["proj"])
        sd[f"{p}.attn.w_msa.relative_position_bias_table"] = _t(
            blk["attn"]["rel_bias"])
        _ln(sd, f"{p}.norm2", blk["ln2"])
        _linear(sd, f"{p}.ffn.layers.0.0", blk["fc1"])
        _linear(sd, f"{p}.ffn.layers.1", blk["fc2"])
    for name, m in bb.items():
        if name.startswith("merge"):
            s = name[len("merge"):]
            _ln(sd, f"backbone.stages.{s}.downsample.norm", m["ln"])
            _linear(sd, f"backbone.stages.{s}.downsample.reduction",
                    m["reduction"])
        elif name.startswith("out_norm"):
            _ln(sd, f"backbone.norm{name[len('out_norm'):]}", m)
    for name, m in prm["fpn"].items():
        kind, i = (("lateral_convs", name[len("lateral"):])
                   if name.startswith("lateral")
                   else ("fpn_convs", name[len("fpn_conv"):]))
        _conv(sd, f"neck.{kind}.{i}.conv", m)
    rpn = prm["rpn"]
    _conv(sd, "rpn_head.rpn_conv", rpn["conv"])
    _conv(sd, "rpn_head.rpn_cls", rpn["cls"])
    _conv(sd, "rpn_head.rpn_reg", rpn["reg"])
    bh = prm["bbox_head"]
    # fc1 reads RoI features flattened (7, 7, C) in the JAX package and
    # (C, 7, 7) in mmdet: permute its input dimension back
    k = np.asarray(bh["fc1"]["kernel"])                  # (49 C, 1024)
    C = k.shape[0] // 49
    w = k.T.reshape(-1, 7, 7, C).transpose(0, 3, 1, 2).reshape(k.shape[1], -1)
    sd["roi_head.bbox_head.shared_fcs.0.weight"] = _t(w)
    sd["roi_head.bbox_head.shared_fcs.0.bias"] = _t(bh["fc1"]["bias"])
    _linear(sd, "roi_head.bbox_head.shared_fcs.1", bh["fc2"])
    _linear(sd, "roi_head.bbox_head.fc_cls", bh["cls"])
    _linear(sd, "roi_head.bbox_head.fc_reg", bh["reg"])
    return sd
