"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``cuda`` marker and skips without a CUDA
device. The file imports neither JAX nor the JAX package, so it also runs
on a machine that has only torch (``tests/conftest.py`` imports jax; skip
it there): ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from macaque_tpu_torch import kernels
from macaque_tpu_torch.nn.attention import (
    packed_attention, packed_attention_reference, window_attention,
    window_attention_reference)
from macaque_tpu_torch.nn.int8 import (
    quant_int8_matmul, quant_int8_matmul_reference, quant_int8_matmul_split,
    quantize_rows, quantize_rows_reference)
from macaque_tpu_torch.nn.roialign import (
    WINDOW_BUCKETS, roi_align_windows, roi_align_windows_reference,
    window_inputs)

pytestmark = pytest.mark.cuda
STRIDES = (4, 8, 16, 32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want):
    """One bf16 ulp of the largest output (2^-7 relative) plus f32
    reordering noise."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 2.0 ** -6 * want.abs().max().item()


def test_packed_attention_kernel(card):
    x = np.random.default_rng(0).normal(size=(8, 192, 3 * 1280))
    x = torch.from_numpy(x).to(card, torch.bfloat16)
    n = kernels.LAUNCHES["packed_attention"]
    _close(packed_attention(x, 16), packed_attention_reference(x, 16))
    assert kernels.LAUNCHES["packed_attention"] == n + 1


def test_packed_attention_refuses_what_it_was_not_built_for(card):
    x = torch.zeros((2, 192, 3840), device=card)
    with pytest.raises(TypeError):
        packed_attention(x, 16)                       # float32
    with pytest.raises(ValueError):
        packed_attention(x.to(torch.bfloat16)[:, :64].contiguous(), 16)
    wide = torch.zeros((2, 192, 7680), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        packed_attention(wide[:, :, :3840], 16)        # not contiguous


@pytest.mark.parametrize("window", WINDOW_BUCKETS)
def test_roi_align_kernel(card, window):
    rng = np.random.default_rng(1)
    B, R, C = 2, 64, 256
    feats = [torch.from_numpy(rng.normal(size=(B, 152 >> l, 200 >> l, C)))
             .to(card, torch.bfloat16) for l in range(4)]
    xy = rng.uniform(0, 560, (B, R, 2))
    wh = np.exp(rng.uniform(np.log(8), np.log(400), (B, R, 2)))
    rois = torch.from_numpy(np.concatenate([xy, xy + wh], -1)).to(card).float()
    area = (rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1])
    lvl = torch.floor(torch.log2(area.sqrt() / 56 + 1e-6)).clamp(0, 3).long()
    args = window_inputs(feats, rois, lvl, 7, STRIDES, window=window)
    n = kernels.LAUNCHES["roi_align_windowed"]
    _close(roi_align_windows(*args), roi_align_windows_reference(*args))
    assert kernels.LAUNCHES["roi_align_windowed"] == n + 1


def _int8_inputs(card, M, K, N, seed=2):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(M, K))).to(card, torch.bfloat16)
    wq = torch.from_numpy(rng.integers(-127, 128, (N, K), dtype=np.int8)).to(card)
    ws = torch.from_numpy(rng.uniform(1e-3, 1e-2, N).astype(np.float32)).to(card)
    b = torch.from_numpy(rng.normal(0, 0.1, N).astype(np.float32)).to(card)
    return x, wq, ws, b


@pytest.mark.parametrize("M,K", [(300, 1280), (1000, 5120), (77, 96)])
def test_quantize_rows_kernel_is_exact(card, M, K):
    x, *_ = _int8_inputs(card, M, K, 8)
    n = kernels.LAUNCHES["quantize_rows"]
    q, s = quantize_rows(x)
    rq, rs = quantize_rows_reference(x)
    assert kernels.LAUNCHES["quantize_rows"] == n + 1
    assert torch.equal(q, rq) and torch.equal(s, rs)


# ViT-huge qkv and fc2, a ragged Swin shape (M, N not multiples of the tile,
# K = 96 not a multiple of the 64-deep step)
@pytest.mark.parametrize("M,K,N", [(384, 1280, 3840), (200, 5120, 1280),
                                   (333, 96, 288)])
@pytest.mark.parametrize("bias", [False, True])
def test_quant_int8_matmul_kernel_is_exact(card, M, K, N, bias):
    x, wq, ws, b = _int8_inputs(card, M, K, N)
    b = b if bias else None
    n = kernels.LAUNCHES["quant_int8_matmul"]
    got = quant_int8_matmul(x, wq, ws, b)
    assert kernels.LAUNCHES["quant_int8_matmul"] == n + 1
    assert torch.equal(got, quant_int8_matmul_reference(x, wq, ws, b))
    assert torch.equal(quant_int8_matmul_split(x, wq, ws, b), got)


def test_int8_kernels_refuse_what_they_were_not_built_for(card):
    x, wq, ws, b = _int8_inputs(card, 64, 1280, 256)
    with pytest.raises(TypeError):
        quantize_rows(x.float())
    with pytest.raises(TypeError):
        quant_int8_matmul(x.float(), wq, ws, b)
    with pytest.raises(ValueError):
        quantize_rows(x[:, :1000].contiguous())                 # K % 32
    with pytest.raises(ValueError):
        quant_int8_matmul(x, wq[:250].contiguous(), ws[:250], b[:250])  # N % 8
    with pytest.raises(ValueError):
        quant_int8_matmul(x[:, ::2], wq[:, :640].contiguous(), ws, b)   # strided
    with pytest.raises(ValueError):
        quant_int8_matmul(x, wq.cpu(), ws, b)                   # weights on the CPU


@pytest.mark.parametrize("K, kernel", [(1280, "quantize_rows"),
                                       (5120, "quant_int8_matmul")])
def test_int8_linear_takes_its_route_on_the_card(card, K, kernel):
    """Int8Linear picks its kernel from K: the split route (K5a, then
    torch._int_mm) up to K = 2048, the fused kernel K5b above."""
    from macaque_tpu_torch.nn.quant import Int8Linear

    x, wq, ws, b = _int8_inputs(card, 384, K, 256, 3)
    m = Int8Linear(K, 256, device=card)
    m.load_state_dict({"weight_q": wq, "wscale": ws, "bias": b})
    before = dict(kernels.LAUNCHES)
    got = m(x)
    launched = {k for k, v in kernels.LAUNCHES.items() if v != before[k]}
    assert launched == {kernel}
    assert torch.equal(got, quant_int8_matmul_reference(x, wq, ws, b))


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_window_attention_kernel(card, dtype, masked, blocked):
    rng = np.random.default_rng(3)
    nW, heads = 16, 6
    qkv = torch.from_numpy(rng.normal(size=(2 * nW, 49, 3 * heads * 32))).to(
        card, dtype)
    bias = torch.from_numpy(rng.normal(0, 0.5, (heads, 49, 49))).to(
        card, torch.float32)
    mask = (torch.from_numpy(np.where(rng.random((nW, 49, 49)) < 0.3, -100.0,
                                      0.0)).to(card, torch.float32)
            if masked else None)
    n = kernels.LAUNCHES["window_attention"]
    got = window_attention(qkv, bias, mask, heads, blocked)
    assert kernels.LAUNCHES["window_attention"] == n + 1
    _close(got, window_attention_reference(qkv, bias, mask, heads, blocked))


def test_window_attention_refuses_what_it_was_not_built_for(card):
    bias = torch.zeros((3, 49, 49), device=card)
    with pytest.raises(TypeError):
        window_attention(torch.zeros((4, 49, 288), device=card,
                                     dtype=torch.float16), bias, None, 3)
    with pytest.raises(ValueError):                             # d = 16
        window_attention(torch.zeros((4, 49, 144), device=card), bias, None, 3)
    with pytest.raises(ValueError):                             # 3 masks for 4
        window_attention(torch.zeros((4, 49, 288), device=card), bias,
                         torch.zeros((3, 49, 49), device=card), 3)
