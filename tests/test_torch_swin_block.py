"""The port's fused Swin block (``macaque_tpu_torch.nn.swin_block``) against
the JAX package's Pallas kernel (interpret mode), and the port's fused
backbone against the JAX fused backbone and the port's ``SwinBackbone``, on
the same numpy inputs and weights. The CUDA kernel is held against its plain
version on a card in test_torch_cuda.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from macaque_tpu.nn.pallas_swin_block import (
    fused_swin_block as jax_fused_swin_block,
    swin_backbone_apply_fused as jax_backbone_apply_fused)
from macaque_tpu.nn.swin import SwinBackbone as JSwinBackbone
from macaque_tpu.nn.swin import SwinConfig as JSwinConfig
from macaque_tpu_torch import kernels
from macaque_tpu_torch.nn.convert import swin_backbone_from_jax
from macaque_tpu_torch.nn.swin import SwinBackbone, SwinConfig, _shift_mask
from macaque_tpu_torch.nn.swin_block import (
    fused_swin_block, fused_swin_block_reference, swin_backbone_apply_fused)
from tests.torch_parity import random_variables

T = 49
# the small Swin of tests/test_pallas_swin_block.py
SMALL = dict(embed_dim=16, depths=(2, 2), num_heads=(1, 2))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _block_inputs(seed, images=2, heads=2, C=16):
    """Windows of ``images`` 28 x 14 images (8 windows each), a tok_valid with
    spatial-pad tokens, the relative bias, the shift mask of one image, and
    block parameters: JAX's tree (kernels (in, out)) and the port's dict
    (weights (out, in))."""
    rng = np.random.default_rng(seed)
    nW = images * 8
    x = rng.normal(size=(nW, T, C)).astype(np.float32)
    tok_valid = np.ones((nW, T), bool)
    tok_valid[3, 40:] = False
    tok_valid[nW - 1, ::3] = False
    bias = rng.normal(0, 0.5, (heads, T, T)).astype(np.float32)
    mask = _shift_mask(28, 14, 7, 3)
    f = lambda *s: rng.normal(0, 1 / np.sqrt(s[0]), s).astype(np.float32)  # noqa: E731
    b = lambda n: rng.normal(0, 0.1, n).astype(np.float32)  # noqa: E731
    dense = {"qkv": (f(C, 3 * C), b(3 * C)), "proj": (f(C, C), b(C)),
             "fc1": (f(C, 4 * C), b(4 * C)), "fc2": (f(4 * C, C), b(C))}
    ln = {n: (1 + rng.normal(0, 0.1, C).astype(np.float32), b(C))
          for n in ("ln1", "ln2")}
    jp = {n: {"kernel": k, "bias": v} for n, (k, v) in dense.items()}
    jp.update({n: {"scale": s, "bias": v} for n, (s, v) in ln.items()})
    tp = {f"{n}.weight": np.ascontiguousarray(k.T) for n, (k, _) in dense.items()}
    tp.update({f"{n}.bias": v for n, (_, v) in dense.items()})
    tp.update({f"{n}.{w}": a for n, (s, v) in ln.items()
               for w, a in (("weight", s), ("bias", v))})
    return x, tok_valid, bias, mask, jp, tp


def _run_block(dtype, masked, seed):
    jdt, tdt = DTYPES[dtype]
    x, tv, bias, mask, jp, tp = _block_inputs(seed)
    heads, images = 2, 2
    # the JAX kernel takes Dense parameters in the compute dtype and the
    # LayerNorm's in float32 (as swin_backbone_apply_fused hands them over)
    jp = {n: {k: jnp.asarray(v, jnp.float32 if n.startswith("ln") else jdt)
              for k, v in d.items()} for n, d in jp.items()}
    want = np.asarray(jax_fused_swin_block(
        jnp.asarray(x, jdt), jnp.asarray(tv), jp, jnp.asarray(bias),
        jnp.asarray(np.tile(mask, (images, 1, 1))) if masked else None, heads,
        block_windows=4, interpret=True).astype(jnp.float32))
    tp = {k: torch.from_numpy(v).to(torch.float32 if k.startswith("ln") else tdt)
          for k, v in tp.items()}
    got = fused_swin_block_reference(
        torch.from_numpy(x).to(tdt), torch.from_numpy(tv), tp,
        torch.from_numpy(bias), torch.from_numpy(mask) if masked else None, heads)
    assert got.dtype == tdt and got.shape == want.shape
    return got.float().numpy(), want


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "shifted"])
def test_reference_matches_pallas_kernel_f32(masked):
    """float32 both sides, spatial-pad tokens included: summation order only
    (the Pallas kernel pads windows to 56 tokens; the port takes the 49
    directly)."""
    got, want = _run_block("float32", masked, 0)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "shifted"])
def test_reference_matches_pallas_kernel_bf16(masked):
    """bf16 activations and Dense weights: both round at the same places, so
    they differ where a reordered f32 sum lands on the other side of a bf16
    rounding boundary; one such flip moves the output by one bf16 ulp of its
    magnitude, and a flip in an intermediate by at most a few: held to 2^-5
    of the largest output (4 ulps at the top of the range)."""
    got, want = _run_block("bfloat16", masked, 1)
    np.testing.assert_allclose(got, want, atol=2.0 ** -5 * np.abs(want).max())


def test_spatial_pad_tokens_do_not_reach_real_tokens():
    """A spatial-pad token is zeroed after LN1: changing its input changes
    no other token's output."""
    x, tv, bias, mask, _, tp = _block_inputs(2)
    tp = {k: torch.from_numpy(v) for k, v in tp.items()}
    args = (torch.from_numpy(tv), tp, torch.from_numpy(bias),
            torch.from_numpy(mask), 2)
    a = fused_swin_block_reference(torch.from_numpy(x), *args)
    x2 = x.copy()
    x2[~tv] += 5.0
    b = fused_swin_block_reference(torch.from_numpy(x2), *args)
    keep = torch.from_numpy(tv)
    torch.testing.assert_close(a[keep], b[keep], rtol=0, atol=0)


def test_wrapper_runs_plain_version_on_cpu():
    x, tv, bias, mask, _, tp = _block_inputs(3)
    args = (torch.from_numpy(x), torch.from_numpy(tv),
            {k: torch.from_numpy(v) for k, v in tp.items()},
            torch.from_numpy(bias), torch.from_numpy(mask), 2)
    before = dict(kernels.LAUNCHES)
    torch.testing.assert_close(fused_swin_block(*args),
                               fused_swin_block_reference(*args), rtol=0, atol=0)
    assert kernels.LAUNCHES == before     # the CPU path launches nothing


def test_wrapper_refuses_other_devices():
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    with pytest.raises(ValueError):
        fused_swin_block(meta(8, T, 96), meta(8, T).bool(), {}, meta(3, T, T),
                         None, 3)


def _backbones(seed, shape, dtype):
    """JAX SwinBackbone variables drawn with numpy, the port's backbone
    loaded from them, and one input."""
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jcfg = JSwinConfig(**SMALL, compute_dtype=jdt)
    v = random_variables(JSwinBackbone(jcfg), jnp.asarray(x), seed=seed)
    tm = SwinBackbone(SwinConfig(**SMALL, compute_dtype=tdt), device="cpu")
    tm.load_state_dict(swin_backbone_from_jax(v["params"]), strict=True)
    return v, jcfg, tm, x


# 60 x 44: 15 x 11 tokens, spatially padded to 21 x 14 in stage 0 and the
# shifted second block of each stage; 56 x 56 at batch 2: whole windows
SHAPES = [(1, 60, 44, 3), (2, 56, 56, 3)]


@pytest.mark.parametrize("shape", SHAPES, ids=["60x44", "2x56x56"])
def test_fused_backbone_matches_jax_and_swin_backbone_f32(shape):
    v, jcfg, tm, x = _backbones(4, shape, "float32")
    want = jax_backbone_apply_fused(v["params"], jnp.asarray(x), jcfg,
                                    block_windows=4, interpret=True)
    before = dict(kernels.LAUNCHES)
    got = swin_backbone_apply_fused(tm, torch.from_numpy(x))
    assert kernels.LAUNCHES == before
    with torch.no_grad():
        plain = tm(torch.from_numpy(x))
    assert len(got) == len(want) == len(plain) == 2
    for g, w, p in zip(got, want, plain):
        assert g.shape == p.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=2e-5, rtol=1e-5)


def test_fused_backbone_matches_jax_bf16():
    """bf16 through 4 blocks, patch embedding and merging: a bf16 ulp flip
    (see the block test) in one block is carried by the residual stream into
    the next, and the output norms rescale it: held to 2^-4 of each map's
    range."""
    v, jcfg, tm, x = _backbones(5, SHAPES[0], "bfloat16")
    want = jax_backbone_apply_fused(v["params"], jnp.asarray(x), jcfg,
                                    block_windows=4, interpret=True)
    got = swin_backbone_apply_fused(tm, torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w,
                                   atol=2.0 ** -4 * np.ptp(w))


def test_fused_backbone_refuses_int8():
    tm = SwinBackbone(SwinConfig(**SMALL, quantize="int8"), device="cpu")
    with pytest.raises(ValueError):
        swin_backbone_apply_fused(tm, torch.zeros((1, 56, 56, 3)))
