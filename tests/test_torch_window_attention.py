"""The port's Swin window attention (``macaque_tpu_torch.nn.attention
.window_attention``) against the JAX package's two Pallas window kernels
(interpret mode), masked and unmasked, and a small Swin with the kernel
switch on against the JAX backbone with the same switch, on the same numpy
inputs. The CUDA kernel is held against its plain version on a card in
test_torch_cuda.py."""

from functools import partial

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from macaque_tpu import nn as jnn
from macaque_tpu.nn import pallas_attention as pa
from macaque_tpu.nn.swin import SwinConfig as JSwinConfig
from macaque_tpu_torch import kernels
from macaque_tpu_torch import nn as tnn
from macaque_tpu_torch.nn.attention import (
    window_attention, window_attention_reference)
from macaque_tpu_torch.nn.convert import swin_maskrcnn_from_jax
from macaque_tpu_torch.nn.swin import SwinConfig, _shift_mask
from tests.torch_parity import DET, SWIN, jax_detector, load, random_variables

T = 49


def _inputs(seed, images, n_windows, heads, d=32):
    """qkv (images * nW, 49, 3C), bias (heads, 49, 49), the shift mask of a
    28 x 14 image (nW = 8 windows of 7 x 7)."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(images * n_windows, T, 3 * heads * d)).astype(np.float32)
    bias = rng.normal(0, 0.5, (heads, T, T)).astype(np.float32)
    mask = _shift_mask(28, 14, 7, 3)
    assert mask.shape == (n_windows, T, T)
    return qkv, bias, mask


KERNELS = {"unblocked": (pa.fused_window_attention, False),
           "blocked": (pa.fused_window_attention_blocked, True)}


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("variant", KERNELS)
def test_reference_matches_pallas_kernels_f32(variant, masked):
    """float32 both sides: summation order only (<= ~1e-6 observed)."""
    fn, blocked = KERNELS[variant]
    qkv, bias, mask = _inputs(0, 2, 8, 3)
    tiled = np.tile(mask, (2, 1, 1)) if masked else None  # the JAX caller tiles
    want = np.asarray(fn(jnp.asarray(qkv), jnp.asarray(bias),
                         None if tiled is None else jnp.asarray(tiled),
                         heads=3, interpret=True))
    got = window_attention_reference(
        torch.from_numpy(qkv), torch.from_numpy(bias),
        torch.from_numpy(mask) if masked else None, 3, blocked).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("variant", KERNELS)
def test_reference_matches_pallas_kernels_bf16(variant, masked):
    """bf16 in and out, with each variant's own rounding of the
    probabilities: agreement to one bf16 ulp of the output (2^-7 of the
    largest value)."""
    fn, blocked = KERNELS[variant]
    qkv, bias, mask = _inputs(1, 2, 8, 6)
    tiled = np.tile(mask, (2, 1, 1)) if masked else None
    want = np.asarray(fn(jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(bias),
                         None if tiled is None else jnp.asarray(tiled),
                         heads=6, interpret=True), np.float32)
    got = window_attention_reference(
        torch.from_numpy(qkv).to(torch.bfloat16), torch.from_numpy(bias),
        torch.from_numpy(mask) if masked else None, 6, blocked)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2.0 ** -7 * np.abs(want).max())


def test_mask_indexed_by_window_equals_tiled_mask():
    """The (nW, T, T) mask read at w % nW is the JAX path's tiled mask."""
    qkv, bias, mask = _inputs(2, 3, 8, 3)
    args = torch.from_numpy(qkv), torch.from_numpy(bias)
    once = window_attention_reference(*args, torch.from_numpy(mask), 3)
    tiled = window_attention_reference(
        *args, torch.from_numpy(np.tile(mask, (3, 1, 1))), 3)
    torch.testing.assert_close(once, tiled, rtol=0, atol=0)


def test_wrapper_runs_plain_version_on_cpu():
    qkv, bias, mask = _inputs(3, 1, 8, 3)
    args = (torch.from_numpy(qkv), torch.from_numpy(bias),
            torch.from_numpy(mask), 3)
    before = dict(kernels.LAUNCHES)
    torch.testing.assert_close(window_attention(*args),
                               window_attention_reference(*args), rtol=0, atol=0)
    assert kernels.LAUNCHES == before     # the CPU path launches nothing


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        window_attention(torch.empty((1, T, 288), device="meta"),
                         torch.empty((3, T, T), device="meta"), None, 3)


def test_swin_with_kernel_switch_matches_jax(monkeypatch):
    """SwinBackbone(use_pallas_attention=True), 8 blocks, window 7 (shifted
    masks on odd blocks), float32, against the JAX backbone with the same
    switch running its blocked Pallas kernel in interpret mode: float32
    noise over 8 blocks, held to 2e-4 as the port's Swin maps are."""
    img = np.random.default_rng(5).normal(size=(1, 128, 96, 3)).astype(np.float32)
    v = random_variables(jax_detector(), jnp.asarray(img), seed=5)
    monkeypatch.setattr(pa, "fused_window_attention_blocked", partial(
        pa.fused_window_attention_blocked, interpret=True))
    jm = jnn.SwinMaskRCNN(jnn.DetectorConfig(
        swin=JSwinConfig(**SWIN, use_pallas_attention=True), **DET))
    want = jm.apply(v, jnp.asarray(img), method=lambda m, y: m.backbone(y))
    tm = load(tnn.SwinMaskRCNN(tnn.DetectorConfig(
        swin=SwinConfig(**SWIN, use_pallas_attention=True), **DET),
        device="cpu"), swin_maskrcnn_from_jax(v))
    assert all(b.attn.w_msa.use_kernel for s in tm.backbone.stages
               for b in s.blocks)
    with torch.no_grad():
        got = tm.backbone(torch.from_numpy(img))
        plain = load(tnn.SwinMaskRCNN(tnn.DetectorConfig(
            swin=SwinConfig(**SWIN), **DET), device="cpu"),
            swin_maskrcnn_from_jax(v)).backbone(torch.from_numpy(img))
    assert len(got) == 4
    for g, w, p in zip(got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=0)
        # the einsum path scales q before the dot: the same function
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=2e-4, rtol=0)
