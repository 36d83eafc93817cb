"""A whole Swin block as one kernel (K6), and the Swin backbone driven with it.

The counterpart of ``macaque_tpu/nn/pallas_swin_block.py``. One block:

    LN1 -> qkv Dense -> per-window attention (relative bias, shift mask)
        -> proj Dense -> + residual -> LN2 -> fc1 Dense -> GELU -> fc2 Dense
        -> + residual

``fused_swin_block`` runs it on windows ``(nW, 49, C)``: on a CUDA tensor it
launches the kernel in ``csrc/swin_block.cu`` (bf16, head width 32,
C a multiple of 96 up to 768: every Swin-S stage) or raises; on a CPU tensor
it runs ``fused_swin_block_reference``. ``swin_backbone_apply_fused`` runs a
whole ``nn.swin.SwinBackbone`` with every block as one such call, as the JAX
package's ``swin_backbone_apply_fused`` does; patch embedding, patch merging
and the output norms stay plain PyTorch there, as in JAX.

Block parameters are a flat dict in the port's layouts: ``ln1.weight``,
``ln1.bias``, ``ln2.weight``, ``ln2.bias`` (C,) float32; ``qkv.weight``
(3C, C), ``proj.weight`` (C, C), ``fc1.weight`` (4C, C), ``fc2.weight``
(C, 4C) with their ``.bias``, in the input dtype (``block_params`` reads
them off a ``SwinBlock``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from macaque_tpu_torch import kernels
from macaque_tpu_torch.nn.layers import acc_dtype
from macaque_tpu_torch.nn.swin import _window_merge, _window_partition

TOKENS = 49            # a 7 x 7 window
HEAD_DIM = 32          # every Swin-S stage
_ERF_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
_ERF_P = 0.3275911
_INV_SQRT2 = float(np.float32(1 / np.sqrt(2)))


def _param_shapes(C: int) -> dict:
    """The block parameters' shapes, in the kernel's argument order."""
    return {"ln1.weight": (C,), "ln1.bias": (C,),
            "qkv.weight": (3 * C, C), "qkv.bias": (3 * C,),
            "proj.weight": (C, C), "proj.bias": (C,),
            "ln2.weight": (C,), "ln2.bias": (C,),
            "fc1.weight": (4 * C, C), "fc1.bias": (4 * C,),
            "fc2.weight": (C, 4 * C), "fc2.bias": (C,)}


def _ln(x, weight, bias, eps):
    """``_ln`` of the Pallas kernel: f32 statistics E[x^2] - E[x]^2,
    ``1 / sqrt(var + eps)`` (a reciprocal of a square root, not rsqrt),
    output in x's dtype."""
    acc = acc_dtype(x.dtype)
    xf = x.to(acc)
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    inv = torch.reciprocal(torch.sqrt(var.clamp_min(0.0) + eps))
    return ((xf - mu) * inv * weight.to(acc) + bias.to(acc)).to(x.dtype)


def _erf_poly(x):
    """Abramowitz & Stegun 7.1.26 (|err| < 1.5e-7), the kernel's erf."""
    a = _ERF_A
    ax = x.abs()
    t = 1.0 / (1.0 + _ERF_P * ax)
    poly = t * (a[0] + t * (a[1] + t * (a[2] + t * (a[3] + t * a[4]))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def _gelu_poly(x):
    xf = x.to(acc_dtype(x.dtype))
    return (0.5 * xf * (1.0 + _erf_poly(xf * _INV_SQRT2))).to(x.dtype)


def _dense(x, weight, bias):
    """A dot accumulated in (at least) f32, cast to x's dtype, then the bias
    added in that dtype."""
    acc = acc_dtype(x.dtype)
    return (x.to(acc) @ weight.to(acc).T).to(x.dtype) + bias.to(x.dtype)


def fused_swin_block_reference(x_win, tok_valid, params, bias_hnm, mask,
                               heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of the kernel, operation for operation as
    ``_swin_block_kernel``: x_win (nW, 49, C) (the residual stream, windows
    laid out image-major), tok_valid (nW, 49) bool (False: a spatial-pad
    token, zeroed after LN1), bias_hnm (heads, 49, 49), mask (nM, 49, 49) or
    None, window w masked by ``mask[w % nM]`` -> (nW, 49, C) in x's dtype.
    Scores ``(Q K^T) * scale + bias + mask`` and the softmax in f32, P rounded
    to the input dtype before P V. The TPU kernel pads windows to 56 tokens
    with -1e9 on the pad columns; exp of that is exactly 0 in f32, so the
    real tokens' values are those of the 49 tokens taken directly, as here."""
    p = params
    nW, N, C = x_win.shape
    D = C // heads
    dt, acc = x_win.dtype, acc_dtype(x_win.dtype)
    h = _ln(x_win, p["ln1.weight"], p["ln1.bias"], eps)
    h = torch.where(tok_valid[..., None], h, torch.zeros_like(h))
    qkv = _dense(h, p["qkv.weight"], p["qkv.bias"])
    q, k, v = qkv.reshape(nW, N, 3, heads, D).to(acc).permute(2, 0, 3, 1, 4)
    s = (q @ k.transpose(-1, -2)) * (D ** -0.5) + bias_hnm.to(acc)
    if mask is not None:
        nM = mask.shape[0]
        s = (s.reshape(nW // nM, nM, heads, N, N)
             + mask.to(acc)[None, :, None]).reshape(nW, heads, N, N)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    pr = (e / e.sum(-1, keepdim=True)).to(dt).to(acc)
    attn = (pr @ v).to(dt).transpose(1, 2).reshape(nW, N, C)
    r1 = x_win + _dense(attn, p["proj.weight"], p["proj.bias"])
    f1 = _gelu_poly(_dense(_ln(r1, p["ln2.weight"], p["ln2.bias"], eps),
                           p["fc1.weight"], p["fc1.bias"]))
    return r1 + _dense(f1, p["fc2.weight"], p["fc2.bias"])


def _check(x_win, tok_valid, params, bias_hnm, mask, heads):
    """The kernel's argument checks, as ``window_attention``'s."""
    name = "fused_swin_block"
    if x_win.dim() != 3 or x_win.shape[1] != TOKENS or x_win.shape[2] != heads * HEAD_DIM:
        raise ValueError(f"{name}: x_win must be (nW, {TOKENS}, {heads * HEAD_DIM})"
                         f" for {heads} heads of {HEAD_DIM}, got {tuple(x_win.shape)}")
    nW, _, C = x_win.shape
    if x_win.dtype != torch.bfloat16:
        raise TypeError(f"{name}: kernel takes bfloat16, got {x_win.dtype}")
    if C % 96 or C > 768:
        raise ValueError(f"{name}: kernel built for C a multiple of 96 up to 768, "
                         f"got C={C}")
    dev = x_win.device
    if not x_win.is_contiguous() or x_win.data_ptr() % 16:
        raise ValueError(f"{name}: x_win must be contiguous and 16-byte aligned")
    if (tok_valid.dtype != torch.bool or tuple(tok_valid.shape) != (nW, TOKENS)
            or tok_valid.device != dev):
        raise ValueError(f"{name}: tok_valid must be bool ({nW}, {TOKENS}) on {dev}")
    if (bias_hnm.dtype != torch.float32
            or tuple(bias_hnm.shape) != (heads, TOKENS, TOKENS)
            or not bias_hnm.is_contiguous() or bias_hnm.device != dev):
        raise ValueError(f"{name}: bias_hnm must be contiguous float32 "
                         f"({heads}, {TOKENS}, {TOKENS}) on {dev}")
    if mask is not None:
        nM = mask.shape[0]
        if (mask.dtype != torch.float32 or tuple(mask.shape) != (nM, TOKENS, TOKENS)
                or not mask.is_contiguous() or mask.device != dev or nM == 0
                or nW % nM):
            raise ValueError(f"{name}: mask must be contiguous float32 "
                             f"(nM, {TOKENS}, {TOKENS}) with nM dividing {nW}")
    for key, shape in _param_shapes(C).items():
        t = params[key]
        want = torch.float32 if key.startswith("ln") else torch.bfloat16
        if (t.dtype != want or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: {key} must be contiguous, 16-byte aligned "
                             f"{want} {shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)}")


# csrc/swin_block.cu's scratch region: a 3-stage ring of (192 x 40) bf16
# weight slabs beside (64 x 40) activation slabs, or two heads' Q, K, V^T,
# whichever is larger
_SCRATCH_BYTES = 3 * (192 + 64) * 40 * 2


def block_layout(C: int) -> dict:
    """K6's layout at width C, as ``csrc/swin_block.cu`` computes it (and
    ``macaque_swin_block_layout`` reports): the rows a block holds (one
    window of 49 tokens padded to 64), its shared-memory bytes (one
    64 x (C + 8) bf16 panel and the scratch region) and the (rows, columns)
    bf16 shape of the workspace slot each resident block owns (the GELU
    activation, 4C columns, and r1, C)."""
    return {"rows": 64, "smem_bytes": 64 * (C + 8) * 2 + _SCRATCH_BYTES,
            "slot": (64, 5 * C)}


def _workspace_slots(C: int, device) -> int:
    """Blocks the kernel keeps resident on ``device`` at width C (its grid
    when there are more windows): each owns one ``block_layout(C)["slot"]``
    of the workspace."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        kernels.check(kernels.library().macaque_swin_block_slots(
            C, ctypes.byref(n)), "fused_swin_block")
    return n.value


def fused_swin_block(x_win, tok_valid, params, bias_hnm, mask, heads: int,
                     eps: float = 1e-5) -> torch.Tensor:
    """One Swin block on windows (nW, 49, C) -> (nW, 49, C): the K6 kernel on
    CUDA, the plain version on the CPU."""
    if x_win.device.type == "cpu":
        return fused_swin_block_reference(x_win, tok_valid, params, bias_hnm,
                                          mask, heads, eps)
    if x_win.device.type != "cuda":
        raise ValueError(f"fused_swin_block: unsupported device {x_win.device}")
    kernels.refuse_grad("fused_swin_block", x_win, bias_hnm, mask,
                        *params.values())
    _check(x_win, tok_valid, params, bias_hnm, mask, heads)
    nW, _, C = x_win.shape
    out = torch.empty_like(x_win)
    if nW:
        slots = min(nW, _workspace_slots(C, x_win.device))
        work = torch.empty((slots, *block_layout(C)["slot"]),
                           dtype=x_win.dtype, device=x_win.device)
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        tv = tok_valid.to(torch.uint8).contiguous()
        err = kernels.library().macaque_swin_block(
            ptr(x_win), ptr(tv), ptr(bias_hnm),
            ctypes.c_void_p(mask.data_ptr() if mask is not None else 0),
            *(ptr(params[k]) for k in _param_shapes(C)),
            ptr(out), ptr(work), nW, C, heads,
            mask.shape[0] if mask is not None else 0, slots, float(eps),
            kernels.current_stream(x_win.device))
        kernels.check(err, "fused_swin_block")
        kernels.LAUNCHES["swin_block"] += 1
    return out


def block_params(blk) -> dict:
    """A ``nn.swin.SwinBlock``'s parameters as the kernel takes them."""
    msa, ffn = blk.attn.w_msa, blk.ffn.layers
    layers = {"qkv": msa.qkv, "proj": msa.proj, "fc1": ffn[0][0], "fc2": ffn[1]}
    p = {f"ln{i}.{w}": getattr(getattr(blk, f"norm{i}"), w).detach()
         for i in (1, 2) for w in ("weight", "bias")}
    for name, lin in layers.items():
        p[f"{name}.weight"] = lin.weight.detach()
        p[f"{name}.bias"] = lin.bias.detach()
    return p


def block_inputs(blk, x, heads: int):
    """``fused_swin_block``'s arguments for ``nn.swin.SwinBlock`` ``blk`` on
    x (B, H, W, C), as the JAX package's fused backbone forms them: x padded
    with zeros to whole windows and rolled by the block's shift, its
    windows image-major, the pad tokens marked invalid, the relative bias
    gathered to (heads, 49, 49) float32 and the (nW, 49, 49) shift mask of
    one image. Returns (args, padded grid (Hp, Wp))."""
    B, H, W, C = x.shape
    w, s = blk.window, blk.shift
    pad_h, pad_w = (w - H % w) % w, (w - W % w) % w
    xp = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    valid = F.pad(torch.ones((1, H, W, 1), device=x.device), (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    mask = None
    if s > 0:
        xp = torch.roll(xp, (-s, -s), dims=(1, 2))
        valid = torch.roll(valid, (-s, -s), dims=(1, 2))
        mask = blk._mask(Hp, Wp, x.device)
    msa = blk.attn.w_msa
    N = w * w
    bias = msa.relative_position_bias_table[
        msa.relative_position_index.reshape(-1)].reshape(N, N, heads)
    bias = bias.permute(2, 0, 1).to(torch.float32).contiguous()
    tok_valid = (_window_partition(valid, w)[..., 0] > 0).repeat(B, 1)
    args = (_window_partition(xp, w).contiguous(), tok_valid, block_params(blk),
            bias, mask, heads)
    return args, (Hp, Wp)


def _apply_block(blk, x, heads: int, eps: float):
    """One block on (B, H, W, C) through ``fused_swin_block``, and back."""
    B, H, W, _ = x.shape
    args, (Hp, Wp) = block_inputs(blk, x, heads)
    y = _window_merge(fused_swin_block(*args, eps), blk.window, B, Hp, Wp)
    if blk.shift > 0:
        y = torch.roll(y, (blk.shift, blk.shift), dims=(1, 2))
    return y[:, :H, :W]


def swin_backbone_apply_fused(backbone, x):
    """``nn.swin.SwinBackbone`` forward with every block as one
    ``fused_swin_block`` call (24 for Swin-S, whatever the batch): x
    (B, H, W, 3) normalized -> the 4 stage maps, as ``backbone(x)``. The
    block Dense layers must be float (the JAX function reads float kernels
    only)."""
    cfg = backbone.cfg
    if cfg.quantize == "int8":
        raise ValueError("swin_backbone_apply_fused: the fused block takes "
                         "float Dense weights, not an int8 backbone")
    with torch.no_grad():
        x = backbone.patch_embed(x)
        outs = []
        for s, stage in enumerate(backbone.stages):
            for blk in stage.blocks:
                x = _apply_block(blk, x, cfg.num_heads[s], cfg.ln_eps)
            outs.append(getattr(backbone, f"norm{s}")(x))
            if stage.downsample is not None:
                x = stage.downsample(x)
    return outs
