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
    attention, attention_reference, fused_attention, fused_attention_blocked,
    packed_attention, packed_attention_reference, window_attention,
    window_attention_reference)
from macaque_tpu_torch.nn.int8 import (
    quant_int8_matmul, quant_int8_matmul_reference, quant_int8_matmul_split,
    quantize_rows, quantize_rows_reference)
from macaque_tpu_torch.nn.quant import Int8Linear, int8_matmul_reference
from macaque_tpu_torch.nn.roialign import (
    WINDOW_BUCKETS, roi_align_windows, roi_align_windows_reference,
    window_inputs)

from attention_cases import cancelling_qkv
from roialign_cases import edge_rois
from window_attention_cases import cancelling_window_qkv

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


# one sequence, and an odd count (48 blocks of 16 heads): K1 at both ends
@pytest.mark.parametrize("B", [1, 3])
def test_packed_attention_kernel_batch_sizes(card, B):
    x = np.random.default_rng(10 + B).normal(size=(B, 192, 3 * 1280))
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


def _roi_feats(card, rng, B, C, h0=152, w0=200):
    return [torch.from_numpy(rng.normal(size=(B, h0 >> l, w0 >> l, C)))
            .to(card, torch.bfloat16) for l in range(4)]


# RoIs at the borders, wholly outside (a zero output), with bins under a
# pixel, degenerate, large and ordinary (tests/roialign_cases.py), on square
# 608-pixel frames
@pytest.mark.parametrize("window", WINDOW_BUCKETS)
def test_roi_align_kernel_at_the_edges(card, window):
    rng = np.random.default_rng(30)
    B, R, C = 2, 70, 256
    feats = _roi_feats(card, rng, B, C, 152, 152)
    boxes, lvl = edge_rois(31, B, R, 608)
    rois = torch.from_numpy(boxes).to(card).float()
    args = window_inputs(feats, rois, torch.from_numpy(lvl).to(card).long(), 7,
                         STRIDES, window=window)
    n = kernels.LAUNCHES["roi_align_windowed"]
    got = roi_align_windows(*args)
    assert kernels.LAUNCHES["roi_align_windowed"] == n + 1
    want = roi_align_windows_reference(*args)
    _close(got, want)
    outside = torch.arange(B * R, device=card) % R % 7 == 3
    assert (want[outside] == 0).all() and (got[outside] == 0).all()


# one RoI, and the parity tier's 4,096-RoI call (16 frames x 256)
@pytest.mark.parametrize("B, R", [(1, 1), (16, 256)])
def test_roi_align_kernel_roi_counts(card, B, R):
    rng = np.random.default_rng(32)
    feats = _roi_feats(card, rng, B, 256)
    xy = rng.uniform(0, 560, (B, R, 2))
    wh = np.exp(rng.uniform(np.log(8), np.log(400), (B, R, 2)))
    rois = torch.from_numpy(np.concatenate([xy, xy + wh], -1)).to(card).float()
    area = (rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1])
    lvl = torch.floor(torch.log2(area.sqrt() / 56 + 1e-6)).clamp(0, 3).long()
    args = window_inputs(feats, rois, lvl, 7, STRIDES, window=48)
    assert args[4].shape[0] == B * R
    _close(roi_align_windows(*args), roi_align_windows_reference(*args))


def test_roi_align_refuses_a_channel_count_it_does_not_tile(card):
    """32 channels a warp: C = 48 is refused before any launch."""
    rng = np.random.default_rng(33)
    feats = _roi_feats(card, rng, 1, 48)
    rois = torch.tensor([[[10.0, 10.0, 90.0, 70.0]]], device=card)
    args = window_inputs(feats, rois, torch.zeros((1, 1), dtype=torch.long,
                                                  device=card), 7, STRIDES,
                         window=16)
    n = kernels.LAUNCHES["roi_align_windowed"]
    with pytest.raises(ValueError):
        roi_align_windows(*args)
    assert kernels.LAUNCHES["roi_align_windowed"] == n


def test_roi_align_refuses_a_ky_that_is_not_bf16(card):
    """Ky meets the bf16 tensor cores unrounded: an entry that is not a bf16
    value is refused before any launch."""
    rng = np.random.default_rng(34)
    feats = _roi_feats(card, rng, 1, 256)
    rois = torch.tensor([[[10.0, 10.0, 90.0, 70.0]]], device=card)
    args = list(window_inputs(feats, rois, torch.zeros(
        (1, 1), dtype=torch.long, device=card), 7, STRIDES, window=16))
    nz = args[4].nonzero()[0].tolist()
    args[4] = args[4].clone()
    args[4][tuple(nz)] += 2.0 ** -20
    n = kernels.LAUNCHES["roi_align_windowed"]
    with pytest.raises(ValueError):
        roi_align_windows(*args)
    assert kernels.LAUNCHES["roi_align_windowed"] == n


# 44.7 KB of shared memory and at most 96 registers a thread: 5 blocks of 4
# warps an SM (csrc/roi_align_windowed.cu)
def test_roi_align_keeps_five_blocks_per_sm(card):
    assert kernels.resident_blocks("roi_align_windowed") >= 5


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


# K5b's ragged edges: one row, rows that leave the 128-row tile part full,
# N = 136 (a 128-column tile and 8 columns of the next), K = 32 and 96
# (half of and one and a half 64-byte slabs: the ring zero-fills the rest)
@pytest.mark.parametrize("M,K,N", [(1, 1280, 256), (17, 1280, 256),
                                   (129, 1280, 256), (200, 1280, 136),
                                   (150, 32, 264), (150, 96, 264)])
def test_quant_int8_matmul_ragged_shapes_are_exact(card, M, K, N):
    x, wq, ws, b = _int8_inputs(card, M, K, N, 5)
    n = kernels.LAUNCHES["quant_int8_matmul"]
    # no bias, the bias before the cast (the TPU kernel's), after it (the
    # int8 layers')
    for bias, out_bias in ((None, None), (b, None), (None, b)):
        assert torch.equal(quant_int8_matmul(x, wq, ws, bias, out_bias),
                           quant_int8_matmul_reference(x, wq, ws, bias, out_bias))
    assert kernels.LAUNCHES["quant_int8_matmul"] == n + 3


def test_quant_int8_matmul_rounds_half_way_codes_to_even(card):
    """Rows whose maximum is 127 have the scale 1.0 exactly, so the values
    k + 0.5 land half way between two codes: rint rounds them to the even
    one, as the plain version's torch.round does."""
    rng = np.random.default_rng(6)
    M, K, N = 256, 1280, 256
    x = rng.integers(-127, 127, (M, K)) + 0.5
    x[:, 7] = 127.0
    x = torch.from_numpy(x).to(card, torch.bfloat16)
    _, wq, ws, b = _int8_inputs(card, M, K, N, 6)
    q, s = quantize_rows_reference(x)
    assert torch.equal(s, torch.ones_like(s))
    assert (q[:, :7].float() != x[:, :7].float()).all()       # every one a tie
    assert torch.equal(quant_int8_matmul(x, wq, ws, b),
                       quant_int8_matmul_reference(x, wq, ws, b))


# 80 KB of shared memory and at most 128 registers a thread: 2 blocks of 8
# warps on an SM (csrc/int8_matmul.cu)
def test_quant_int8_matmul_keeps_two_blocks_per_sm(card):
    assert kernels.resident_blocks("quant_int8_matmul") >= 2


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


@pytest.mark.parametrize("K, kernel", [(1280, "quant_int8_matmul"),
                                       (5120, "quant_int8_matmul")])
def test_int8_linear_takes_its_route_on_the_card(card, K, kernel):
    """Int8Linear runs K5b at every K (one count: its quantize pass is part
    of the call) and computes the JAX default tier's chain, bias added
    after the cast."""
    x, wq, ws, b = _int8_inputs(card, 384, K, 256, 3)
    m = Int8Linear(K, 256, device=card)
    m.load_state_dict({"weight_q": wq, "wscale": ws, "bias": b})
    before = dict(kernels.LAUNCHES)
    got = m(x)
    launched = {k for k, v in kernels.LAUNCHES.items() if v != before[k]}
    assert launched == {kernel}
    assert torch.equal(got, int8_matmul_reference(x, wq, ws, b))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("M,K", [(300, 1280), (77, 5120), (333, 96)])
def test_int8_linear_equals_the_jax_default_chain(card, M, K, bias):
    """The card route (K5b, the bias in its out_bias epilogue), with and
    without a bias, bit for bit against int8_matmul_reference, the chain the
    layer runs on the CPU."""
    x, wq, ws, b = _int8_inputs(card, M, K, 264, 4)
    m = Int8Linear(K, 264, bias=bias, device=card)
    m.weight_q, m.wscale = wq, ws
    if bias:
        m.bias = b
    assert torch.equal(m(x), int8_matmul_reference(x, wq, ws, m.bias))


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


# Swin-S's four widths with the parity frame's window counts (a 608 x 800
# input: 22 x 29, 11 x 15, 6 x 8 and 3 x 4 windows), and one window
SWIN_S = [(3, (22, 29)), (6, (11, 15)), (12, (6, 8)), (24, (3, 4))]


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("one", [True, False], ids=["one-window", "stage"])
@pytest.mark.parametrize("heads, grid", SWIN_S, ids=["C96", "C192", "C384", "C768"])
def test_window_attention_kernel_at_each_swin_s_width(card, heads, grid, one,
                                                      dtype, masked, blocked):
    from macaque_tpu_torch.nn.swin import _shift_mask

    rng = np.random.default_rng(heads)
    mask = torch.as_tensor(_shift_mask(7 * grid[0], 7 * grid[1], 7, 3),
                           device=card)
    if one:
        mask = mask[-1:].contiguous()        # the corner window: masked keys
    qkv = torch.from_numpy(rng.normal(size=(mask.shape[0], 49, 96 * heads))).to(
        card, dtype)
    bias = torch.from_numpy(rng.normal(0, 0.5, (heads, 49, 49))).to(
        card, torch.float32)
    m = mask if masked else None
    n = kernels.LAUNCHES["window_attention"]
    got = window_attention(qkv, bias, m, heads, blocked)
    assert kernels.LAUNCHES["window_attention"] == n + 1
    _close(got, window_attention_reference(qkv, bias, m, heads, blocked))


def test_window_attention_unblocked_keeps_p_in_f32(card):
    """Value rows that cancel (tests/window_attention_cases.py): P rounded
    once to bf16, as the blocked variant rounds it, lands outside 2^-6 of
    the largest output of the unblocked plain version (P in f32); the
    unblocked kernel's hi + lo split of P holds it there."""
    qkv, bias = cancelling_window_qkv(9, 24, 12)
    qkv = torch.from_numpy(qkv).to(card, torch.bfloat16)
    bias = torch.from_numpy(bias).to(card)
    want = window_attention_reference(qkv, bias, None, 12, False)
    single = window_attention_reference(qkv, bias, None, 12, True)
    top = want.float().abs().max().item()
    assert (single.float() - want.float()).abs().max().item() > 2.0 ** -6 * top
    _close(window_attention(qkv, bias, None, 12, False), want)


# 34.6 KB of shared memory and at most 80 registers a thread: 6 blocks of 4
# warps an SM, so a stage-3 call (576 blocks) runs in one wave on 132 SMs
@pytest.mark.parametrize("blocked", [0, 1])
def test_window_attention_keeps_six_blocks_per_sm(card, blocked):
    assert kernels.resident_blocks("window_attention", 1, blocked) >= 6


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


def test_window_attention_refuses_a_misaligned_bf16_qkv(card):
    """The bf16 kernel stages qkv by 16-byte copies: a contiguous view at
    an odd bf16 element offset is refused with the wrapper's ValueError
    before any launch, not a CUDA error code."""
    bias = torch.zeros((3, 49, 49), device=card)
    buf = torch.zeros(4 * 49 * 288 + 1, device=card, dtype=torch.bfloat16)
    qkv = buf[1:].view(4, 49, 288)
    assert qkv.is_contiguous() and qkv.data_ptr() % 16
    n = kernels.LAUNCHES["window_attention"]
    with pytest.raises(ValueError, match="16-byte"):
        window_attention(qkv, bias, None, 3)
    assert kernels.LAUNCHES["window_attention"] == n


def _bf16(card, rng, *shape, scale=1.0):
    return (torch.from_numpy(rng.normal(size=shape) * scale)
            .to(card, torch.bfloat16))


@pytest.mark.parametrize("fn, name", [(fused_attention, "per head"),
                                      (fused_attention_blocked, "blocked"),
                                      (attention, "dispatcher")])
def test_attention_kernel(card, fn, name):
    rng = np.random.default_rng(6)
    q, k, v = (_bf16(card, rng, 4, 192, 16, 80) for _ in range(3))
    n = kernels.LAUNCHES["attention"]
    _close(fn(q, k, v), attention_reference(q, k, v))
    assert kernels.LAUNCHES["attention"] == n + 1


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("fn", [fused_attention, fused_attention_blocked,
                                attention])
def test_attention_kernel_batch_sizes(card, fn, B):
    rng = np.random.default_rng(20 + B)
    q, k, v = (_bf16(card, rng, B, 192, 16, 80) for _ in range(3))
    n = kernels.LAUNCHES["attention"]
    _close(fn(q, k, v), attention_reference(q, k, v))
    assert kernels.LAUNCHES["attention"] == n + 1


@pytest.mark.parametrize("fn", [fused_attention, fused_attention_blocked,
                                attention])
def test_attention_kernel_keeps_p_in_f32(card, fn):
    """Value rows that cancel (max |v| some 50-110 times the output,
    tests/attention_cases.py): P rounded once to bf16, as K1 and the
    packed plain version round it, lands outside 2^-6 of the largest
    output; K4's hi + lo split of P holds attention_reference to it."""
    B, N, H, D = 3, 192, 16, 80
    q, k, v = (torch.from_numpy(t).to(card, torch.bfloat16)
               for t in cancelling_qkv(8, B, N, H, D))
    want = attention_reference(q, k, v)
    top = want.float().abs().max().item()
    packed = torch.cat([t.reshape(B, N, H * D) for t in (q, k, v)], -1)
    single = packed_attention_reference(packed, H).reshape(B, N, H, D)
    assert (single.float() - want.float()).abs().max().item() > 2.0 ** -6 * top
    _close(fn(q, k, v), want)


# 67.6 KB of shared memory and at most 168 registers a thread: 3 blocks of
# 4 warps on an SM (csrc/attention_core.cuh)
@pytest.mark.parametrize("name", ["attention", "packed_attention"])
def test_attention_kernels_keep_three_blocks_per_sm(card, name):
    assert kernels.resident_blocks(name) >= 3


def test_attention_refuses_what_it_was_not_built_for(card):
    t = torch.zeros((2, 192, 16, 80), device=card)
    with pytest.raises(TypeError):
        attention(t, t, t)                                      # float32
    t = t.to(torch.bfloat16)
    with pytest.raises(ValueError):
        attention(t[:, :64].contiguous(), t[:, :64].contiguous(),
                  t[:, :64].contiguous())                       # N = 64
    with pytest.raises(ValueError):
        attention(t, t, t[:1])                                  # shapes differ


def _swin_block_case(card, seed, C, images, grid, masked):
    """Windows of ``images`` images of ``grid`` (rows, cols) windows, a few
    spatial-pad tokens, the relative bias, a shift-like mask and block
    parameters near a trained block's scale."""
    from macaque_tpu_torch.nn.swin import _shift_mask

    rng = np.random.default_rng(seed)
    heads, nW = C // 32, images * grid[0] * grid[1]
    x = _bf16(card, rng, nW, 49, C)
    tv = torch.ones((nW, 49), dtype=torch.bool, device=card)
    tv[-1, 30:] = False
    bias = torch.from_numpy(rng.normal(0, 0.5, (heads, 49, 49))).to(card, torch.float32)
    mask = (torch.as_tensor(_shift_mask(7 * grid[0], 7 * grid[1], 7, 3), device=card)
            if masked else None)
    p = {}
    for name, (n, k) in {"qkv": (3 * C, C), "proj": (C, C), "fc1": (4 * C, C),
                         "fc2": (C, 4 * C)}.items():
        p[f"{name}.weight"] = _bf16(card, rng, n, k, scale=k ** -0.5)
        p[f"{name}.bias"] = _bf16(card, rng, n, scale=0.1)
    for name in ("ln1", "ln2"):
        p[f"{name}.weight"] = torch.from_numpy(1 + rng.normal(0, 0.1, C)).to(card, torch.float32)
        p[f"{name}.bias"] = torch.from_numpy(rng.normal(0, 0.1, C)).to(card, torch.float32)
    return x, tv, p, bias, mask, heads


# the four Swin-S widths; more windows than the card keeps resident at 96
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("C, images, grid", [(96, 6, (22, 29)), (192, 2, (11, 15)),
                                             (384, 2, (6, 8)), (768, 2, (3, 4))])
def test_swin_block_kernel(card, C, images, grid, masked):
    from macaque_tpu_torch.nn.swin_block import (
        fused_swin_block, fused_swin_block_reference)

    args = _swin_block_case(card, 7, C, images, grid, masked)
    n = kernels.LAUNCHES["swin_block"]
    got = fused_swin_block(*args)
    assert kernels.LAUNCHES["swin_block"] == n + 1
    want = fused_swin_block_reference(*args)
    torch.cuda.synchronize()
    # bf16 ulp flips of the intermediates (see chip_smoke.py): 2^-5 of the
    # block's largest contribution out - x
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -5 * (want.float() - args[0].float()).abs().max().item()


# more windows than the card keeps blocks at C = 384 and 768: every block
# takes a second window into the slot the first one used
@pytest.mark.parametrize("C, images, grid", [(384, 6, (6, 8)), (768, 12, (3, 4))])
def test_swin_block_kernel_reuses_its_slots(card, C, images, grid):
    from macaque_tpu_torch.nn.swin_block import (
        _workspace_slots, fused_swin_block, fused_swin_block_reference)

    args = _swin_block_case(card, 8, C, images, grid, True)
    assert args[0].shape[0] > _workspace_slots(C, card)
    got = fused_swin_block(*args)
    want = fused_swin_block_reference(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -5 * (want.float() - args[0].float()).abs().max().item()


# one 64 x (C + 8) panel and a 61,440-byte scratch region a block, at most
# 128 registers a thread: two blocks an SM up to C = 384, one at 768
# (csrc/swin_block.cu); the layout as nn/swin_block.py mirrors it
@pytest.mark.parametrize("C, per_sm", [(96, 2), (192, 2), (384, 2), (768, 1)])
def test_swin_block_keeps_its_blocks_per_sm(card, C, per_sm):
    import ctypes

    from macaque_tpu_torch.nn.swin_block import _workspace_slots, block_layout

    smem, slot = ctypes.c_int(0), ctypes.c_int(0)
    kernels.check(kernels.library().macaque_swin_block_layout(
        C, ctypes.byref(smem), ctypes.byref(slot)), "layout")
    lay = block_layout(C)
    assert (smem.value, slot.value) == (lay["smem_bytes"], 64 * 5 * C)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert _workspace_slots(C, card) >= per_sm * sms


def test_fused_swin_s_trunk(card):
    """Swin-S at full width on two 224 x 160 frames: 24 launches, the four
    maps within 2^-5 of each map's range of SwinBackbone's (bf16 rounding
    at other places, carried through 24 blocks; see chip_smoke.py)."""
    from macaque_tpu_torch.nn.swin import SwinBackbone, SwinConfig
    from macaque_tpu_torch.nn.swin_block import swin_backbone_apply_fused

    torch.manual_seed(0)
    bb = SwinBackbone(SwinConfig(compute_dtype=torch.bfloat16), device=card)
    x = torch.randn((2, 224, 160, 3), device=card)
    n = kernels.LAUNCHES["swin_block"]
    got = swin_backbone_apply_fused(bb, x)
    assert kernels.LAUNCHES["swin_block"] == n + 24
    with torch.no_grad():
        want = bb(x)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g.float()).all()
        span = (w.float().max() - w.float().min()).item()
        assert (g.float() - w.float()).abs().max().item() <= 2.0 ** -5 * span


# ---------------------------------------------------------------- step 2
# Step 2 runs no hand-written kernel: plain PyTorch on CUDA tensors, held
# here against the CPU on the port's synthetic scene (8 cameras x 6 slots:
# M = 48).

def _step2_scene(tmp_path, n_frame=120):
    from macaque_tpu_torch.pipeline.artifacts import write_alldata
    from macaque_tpu_torch.tools.synthetic import (
        make_test_rig, simulate_scene, synthesize_alldata)

    rig = make_test_rig(8)
    kp3d = simulate_scene(4, n_frame, seed=0)
    for cam_id, rows in zip(rig.camera_ids, synthesize_alldata(rig, kp3d)):
        write_alldata(str(tmp_path / "scene" / cam_id), rows,
                      np.arange(n_frame, dtype=np.int32))
    return rig, str(tmp_path / "scene")


def _step2(rig, root, out, **kw):
    import shutil

    from macaque_tpu_torch.pipeline.artifacts import read_pickle
    from macaque_tpu_torch.pipeline.step2 import run_step2

    shutil.copytree(root, out)
    return read_pickle(run_step2(out, rig, **kw))


def test_step2_affinity_and_svt_on_the_card_match_the_cpu(card, tmp_path):
    """geometry_affinity and match_svt at M = 48: in float64 the card
    equals the CPU to 1e-9 and in its match matrices; in float32 the
    affinity stays within 1e-3 of the CPU's float64."""
    from macaque_tpu_torch.association import geometry_affinity, match_svt
    from macaque_tpu_torch.cameras.omnidir import omnidir_undistort
    from macaque_tpu_torch.core.config import CrossViewConfig
    from macaque_tpu_torch.pipeline.step2 import load_keyframes

    rig, root = _step2_scene(tmp_path)
    _, packed = load_keyframes(root, rig, CrossViewConfig(), 6)
    same = packed["cam_idx"][:, None] == packed["cam_idx"][None, :]
    out = {}
    for dev, dt in (("cpu", torch.float64), (card, torch.float64),
                    (card, torch.float32)):
        cam = rig.omni(dev, dt)
        idx = torch.as_tensor(packed["cam_idx"], device=dev)
        pose = torch.as_tensor(packed["pose"], dtype=dt, device=dev)
        valid = torch.as_tensor(packed["valid"], device=dev)
        und = omnidir_undistort(cam.__class__(*[f[idx] for f in cam]),
                                pose[..., :2])
        geo = geometry_affinity(cam, torch.nan_to_num(und),
                                torch.nan_to_num(pose[..., 2]), idx, valid)
        match = match_svt(geo, torch.as_tensor(same, device=dev), valid=valid,
                          block_size=6)
        out[(str(dev), dt)] = (geo.cpu().double().numpy(), match.cpu().numpy())
    geo64, match64 = out[("cpu", torch.float64)]
    geo_c, match_c = out[(str(card), torch.float64)]
    assert geo64.shape == (9, 48, 48)
    assert np.abs(geo_c - geo64).max() <= 1e-9
    np.testing.assert_array_equal(match_c, match64)
    assert np.abs(out[(str(card), torch.float32)][0] - geo64).max() <= 1e-3


def test_run_step2_does_not_follow_allow_tf32(card, tmp_path):
    """run_step2 in float32 gives the same persons with TF32 matmuls
    allowed as without: its products are elementwise sums or run under
    a local full-float32 guard."""
    rig, root = _step2_scene(tmp_path)
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        got = {}
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            got[tf32] = _step2(rig, root, str(tmp_path / f"tf32_{tf32}"),
                               device=card)
            assert torch.backends.cuda.matmul.allow_tf32 == tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    for a, b in zip(got[False], got[True]):
        assert [x.tolist() for x in a["bcomb"]] == [x.tolist() for x in b["bcomb"]]
        for p, q in zip(a["pose3d"], b["pose3d"]):
            np.testing.assert_array_equal(p, q)


def test_run_step2_runs_on_the_card_by_default(card, tmp_path):
    """With no device, run_step2 computes on the card (its CUDA memory
    peak grows) in float32, and writes what device='cuda' writes; the
    float64 CPU run finds the same persons."""
    rig, root = _step2_scene(tmp_path)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.max_memory_allocated()
    got = _step2(rig, root, str(tmp_path / "default"))
    assert torch.cuda.max_memory_allocated() > base
    want = _step2(rig, root, str(tmp_path / "cuda"), device="cuda")
    cpu = _step2(rig, root, str(tmp_path / "cpu"), device="cpu",
                 dtype=torch.float64)
    for a, b, c in zip(got, want, cpu):
        assert [x.tolist() for x in a["bcomb"]] == [x.tolist() for x in b["bcomb"]]
        assert {tuple(x) for x in a["bcomb"]} == {tuple(x) for x in c["bcomb"]}
        for p, q in zip(a["pose3d"], b["pose3d"]):
            assert p.dtype == np.float32
            np.testing.assert_array_equal(p, q)


# ----------------------------------------------------------- steps 3-4
# Steps 3 and 4 run no hand-written kernel either: the Viterbi batch, the
# LM-CGLS solver and both entry points on CUDA tensors, held against the
# CPU. The refinement is held on fifteen LM iterations of two CG sweeps:
# past about ten sweeps CGLS amplifies rounding about fourfold a sweep
# (in the JAX package too), so two devices agree to rounding only there.

BOUNDED = {"lm_iters": 15, "cg_iters": 2}


def _steps_scene(tmp_path, n_frame=120):
    """Step 2 of the synthetic scene on the CPU in float64, the input of
    steps 3 and 4."""
    rig, root = _step2_scene(tmp_path, n_frame)
    _step2(rig, root, str(tmp_path / "s2"), device="cpu", dtype=torch.float64)
    return rig, str(tmp_path / "s2")


def _copy(src, dst):
    import shutil

    shutil.copytree(src, dst)
    return dst


def test_viterbi_batch_on_the_card_matches_the_cpu(card):
    from macaque_tpu_torch.filters.viterbi import viterbi_filter_joints

    rng = np.random.default_rng(0)
    truth = np.cumsum(rng.normal(0, 4, (64, 200, 17, 1, 2)), axis=1) + 300
    pts = truth + rng.normal(0, 1, truth.shape)
    scs = rng.uniform(0.1, 1.0, pts.shape[:-1])
    pts[rng.random(scs.shape) < 0.1] = np.nan
    out = {}
    for dev, dt in (("cpu", torch.float64), (card, torch.float64),
                    (card, torch.float32)):
        p, s = viterbi_filter_joints(torch.as_tensor(pts, dtype=dt, device=dev),
                                     torch.as_tensor(scs, dtype=dt, device=dev))
        out[(str(dev), dt)] = (p.cpu().double().numpy(),
                               s.cpu().double().numpy())
    want = out[("cpu", torch.float64)]
    for dt, tol in ((torch.float64, 1e-9), (torch.float32, 1e-2)):
        got = out[(str(card), dt)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            assert np.nanmax(np.abs(g - w)) <= tol


def test_lm_solve_on_the_card_matches_the_cpu(card):
    from macaque_tpu_torch.geometry.lm import LMConfig, lm_solve

    rng = np.random.default_rng(1)
    A, y = rng.normal(size=(4, 40, 8)), rng.normal(size=(4, 40))
    x0 = rng.normal(size=(4, 8))
    got = {}
    for dev in ("cpu", card):
        At, yt = (torch.as_tensor(v, device=dev) for v in (A, y))

        def resid(x):
            z = (At * x[:, None, :]).sum(-1)
            return torch.tanh(z) * 2 + 0.1 * z ** 2 - yt

        x, info = lm_solve(resid, torch.as_tensor(x0, device=dev),
                           LMConfig(lm_iters=40, cg_iters=30, ftol=1e-9,
                                    cg_rtol=1e-6), return_info=True)
        got[str(dev)] = (x.cpu().numpy(), info["lm_iters"].tolist(),
                         info["cg_iters"].tolist())
    (xc, lc, cc), (xg, lg, cg) = got["cpu"], got[str(card)]
    assert (lg, cg) == (lc, cc)
    assert np.abs(xg - xc).max() <= 1e-9


def test_run_step3_on_the_card_matches_the_cpu(card, tmp_path):
    from macaque_tpu_torch.pipeline.artifacts import read_pickle
    from macaque_tpu_torch.pipeline.step3 import run_step3

    rig, s2 = _steps_scene(tmp_path)
    got = {}
    for dev in ("cpu", card):
        d = _copy(s2, str(tmp_path / f"s3_{dev}"))
        times = {}
        run_step3(d, rig, device=dev, dtype=torch.float64, times=times)
        got[str(dev)] = [read_pickle(f"{d}/{f}") for f in (
            "track.pickle", "collar_id.pickle", "kp2d.pickle")]
    (tc, cc, kc), (tg, cg, kg) = got["cpu"], got[str(card)]
    assert list(tg) == list(tc) and list(cg) == list(cc) and len(tc) >= 4
    for k in tc:
        np.testing.assert_array_equal(tg[k], tc[k])
        np.testing.assert_array_equal(cg[k], cc[k])
    np.testing.assert_array_equal(kg, kc)


def _step4_on(rig, s3, out, **kw):
    from macaque_tpu_torch.pipeline.artifacts import read_pickle
    from macaque_tpu_torch.pipeline.step4 import run_step4

    d = _copy(s3, out)
    times = {}
    res = read_pickle(run_step4(d, rig, times=times, **kw))
    return read_pickle(f"{d}/kp2d_f.pickle"), res, times


@pytest.fixture
def step3_out(tmp_path):
    from macaque_tpu_torch.pipeline.step3 import run_step3

    rig, s2 = _steps_scene(tmp_path)
    run_step3(s2, rig, device="cpu", dtype=torch.float64)
    return rig, s2


def test_run_step4_on_the_card_matches_the_cpu(card, tmp_path, step3_out):
    """float64: kp2d_f equal to 1e-9, and over the held refinement budget
    equal LM iterations and CG sweeps and kp3d within 1e-6 mm."""
    rig, s3 = step3_out
    got = {dev: _step4_on(rig, s3, str(tmp_path / f"s4_{dev}"), device=dev,
                          dtype=torch.float64, refine_overrides=BOUNDED)
           for dev in ("cpu", "cuda")}
    (fc, oc, tc), (fg, og, tg) = got["cpu"], got["cuda"]
    np.testing.assert_array_equal(np.isnan(fg), np.isnan(fc))
    assert np.nanmax(np.abs(fg - fc)) <= 1e-9
    assert (tg["lm_iters"], tg["cg_iters"]) == (tc["lm_iters"], tc["cg_iters"])
    for k in ("kp3d", "kp3d_score", "kp3d_err"):
        np.testing.assert_array_equal(np.isnan(og[k]), np.isnan(oc[k]))
        assert np.nanmax(np.abs(og[k] - oc[k])) <= 1e-6


def test_run_step4_does_not_follow_allow_tf32(card, tmp_path, step3_out):
    """float32 on the card at the production budget: kp3d is the same
    with TF32 matmuls allowed (no product of step 4 is a matmul)."""
    rig, s3 = step3_out
    flag = torch.backends.cuda.matmul.allow_tf32
    got = {}
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            got[tf32] = _step4_on(rig, s3, str(tmp_path / f"tf32_{tf32}"),
                                  device=card)[1]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    np.testing.assert_array_equal(got[True]["kp3d"], got[False]["kp3d"])


def test_steps_3_and_4_run_on_the_card_by_default(card, tmp_path):
    """With no device, run_step3 and run_step4 compute on the card in
    float32 and write what device='cuda' writes."""
    from macaque_tpu_torch.pipeline.artifacts import read_pickle
    from macaque_tpu_torch.pipeline.step3 import run_step3

    rig, s2 = _steps_scene(tmp_path)
    out = {}
    for name, kw in (("default", {}), ("cuda", {"device": "cuda"})):
        d = _copy(s2, str(tmp_path / name))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.max_memory_allocated()
        run_step3(d, rig, **kw)
        f, res, _ = _step4_on(rig, d, str(tmp_path / f"{name}_4"),
                              refine_overrides=BOUNDED, **kw)
        assert torch.cuda.max_memory_allocated() > base
        out[name] = (read_pickle(f"{d}/track.pickle"), f, res)
    (ta, fa, ra), (tb, fb, rb) = out["default"], out["cuda"]
    assert list(ta) == list(tb)
    assert fa.dtype == np.float32
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(ra["kp3d"], rb["kp3d"])


# ---------------------------------------------------------- the pipeline
# run_pipeline end to end, the RGBA imgstore reader and the overlay's
# reprojection on the card's machine, which has neither cv2 nor PyYAML.


def _pipeline_scene(tmp_path, n_frame=48):
    from macaque_tpu_torch.tools import synthetic as s

    rig = s.make_test_rig(4)
    truth = s.simulate_scene(2, n_frame, seed=1)
    proj = s.project_scene(rig, truth)
    s.render_stores(str(tmp_path / "videos"), "synth", rig, proj,
                    fourcc="RGBA", chunksize=20)
    return rig, truth, proj


def test_run_pipeline_runs_on_the_card_by_default(card, tmp_path):
    """With no device, steps 2-4 compute on the card (its CUDA memory peak
    grows) in float32, from RGBA stores read without cv2, and each animal
    comes out within 30 mm."""
    from macaque_tpu_torch.core.config import PipelineConfig
    from macaque_tpu_torch.pipeline.artifacts import read_pickle
    from macaque_tpu_torch.pipeline.runner import run_pipeline
    from macaque_tpu_torch.tools.synthetic import SyntheticPerception

    rig, truth, proj = _pipeline_scene(tmp_path)
    cfg = PipelineConfig(data_name="synth", results_dir=str(tmp_path / "r"),
                         raw_data_dir=str(tmp_path / "videos"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.max_memory_allocated()
    rd = run_pipeline(cfg, rig, lambda c: SyntheticPerception(
        rig.camera_ids.index(c), proj), render=False)
    assert torch.cuda.max_memory_allocated() > base
    out = read_pickle(f"{rd}/kp3d.pickle")
    assert read_pickle(f"{rd}/kp2d_f.pickle").dtype == np.float32
    T = out["kp3d"].shape[1]
    for a in range(2):
        e = np.linalg.norm(out["kp3d"][a] - truth[a, :T], axis=-1)
        assert np.nanmedian(e) < 30.0


def test_device_tracker_on_a_camera_thread_pool(card, tmp_path):
    """``run_step1`` with the device tracker on the card, its cameras on a
    pool of 2 threads, writes what the sequential loop writes."""
    from macaque_tpu_torch.pipeline.artifacts import read_alldata
    from macaque_tpu_torch.pipeline.step1 import run_step1
    from macaque_tpu_torch.tools.synthetic import SyntheticPerception

    rig, _, proj = _pipeline_scene(tmp_path)
    rows = {}
    for workers in (1, 2):
        dirs = run_step1("synth", str(tmp_path / f"r{workers}"),
                         str(tmp_path / "videos"),
                         lambda c: SyntheticPerception(
                             rig.camera_ids.index(c), proj, device="cuda"),
                         use_device_tracker=True, parallel_cameras=workers)
        assert len(dirs) == rig.n_cam
        rows[workers] = [read_alldata(d)[0] for d in dirs]
    assert rows[2] == rows[1] and any(any(r) for r in rows[1][0])


def test_rgba_reader_gives_the_drawn_frames_on_the_cards_machine(card,
                                                                tmp_path):
    from macaque_tpu_torch.tools.synthetic import draw_frames
    from macaque_tpu_torch.video.imgstore import ImgStoreReader

    rig, _, proj = _pipeline_scene(tmp_path, 30)
    for c, cam in enumerate(rig.camera_ids):
        r = ImgStoreReader(str(tmp_path / "videos" / f"synth.{cam}"))
        drawn = draw_frames(proj, c)
        for t in list(range(len(drawn))) + [29, 0, 21, 19]:
            img, (fn, _) = r.get_image(frame_index=t)
            assert fn == t
            np.testing.assert_array_equal(img, drawn[t])
        r.close()


def test_overlay_points_on_the_card_match_the_cpu(card):
    from macaque_tpu_torch.tools.synthetic import make_test_rig, simulate_scene
    from macaque_tpu_torch.tools.visualize import overlay_points

    rig = make_test_rig(8)
    kp3d = simulate_scene(4, 60, seed=2)
    kp3d[1, 10:20] = np.nan
    kp3d[2, 5, 3] = np.nan
    score = np.random.default_rng(0).uniform(0, 1, kp3d.shape[:3])
    data = {"kp3d": kp3d, "kp3d_score": np.where(score < 0.2, 0.0, score)}
    for c in range(rig.n_cam):
        want, mw = overlay_points(data, rig, c, device="cpu")
        got, mg = overlay_points(data, rig, c, device="cuda")
        default, md = overlay_points(data, rig, c)
        np.testing.assert_array_equal(mg, mw)
        np.testing.assert_array_equal(md, mw)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(default, got)


# ------------------------------------------- kernels refuse autograd inputs

def _grad_cases(card):
    """(name, kernels.LAUNCHES key, call(requires_grad) -> output) for each
    wrapper that launches a kernel, at a shape it was built for."""
    from macaque_tpu_torch.nn.swin_block import fused_swin_block

    rng = np.random.default_rng(30)

    def leaf(t, rg):
        return t.detach().requires_grad_(rg)

    qkv = _bf16(card, rng, 2, 192, 3 * 1280)
    win = _bf16(card, rng, 8, 49, 3 * 96)
    wbias = torch.zeros((3, 49, 49), device=card)
    q, k, v = (_bf16(card, rng, 1, 192, 16, 80) for _ in range(3))
    feats = _roi_feats(card, rng, 1, 256)
    rois = torch.tensor([[[8.0, 8, 120, 100], [200, 150, 260, 300]]],
                        device=card)
    roi_args = window_inputs(feats, rois, torch.tensor([[1, 2]], device=card),
                             7, STRIDES)
    x, wq, ws, b = _int8_inputs(card, 64, 1280, 256)
    lin = Int8Linear(1280, 256, device=card)
    lin.load_state_dict({"weight_q": wq, "wscale": ws, "bias": b})
    sw = _swin_block_case(card, 31, 96, 1, (2, 2), False)
    return [
        ("packed_attention", "packed_attention",
         lambda rg: packed_attention(leaf(qkv, rg), 16)),
        ("window_attention", "window_attention",
         lambda rg: window_attention(leaf(win, rg), wbias, None, 3)),
        ("fused_attention", "attention",
         lambda rg: fused_attention(leaf(q, rg), k, v)),
        ("roi_align_windows", "roi_align_windowed",
         lambda rg: roi_align_windows(leaf(roi_args[0], rg), *roi_args[1:])),
        ("quantize_rows", "quantize_rows",
         lambda rg: quantize_rows(leaf(x, rg))[1]),
        ("quant_int8_matmul", "quant_int8_matmul",
         lambda rg: quant_int8_matmul(leaf(x, rg), wq, ws, b)),
        ("quant_int8_matmul_split", "quantize_rows",
         lambda rg: quant_int8_matmul_split(leaf(x, rg), wq, ws, b)),
        ("Int8Linear", "quant_int8_matmul", lambda rg: lin(leaf(x, rg))),
        ("fused_swin_block", "swin_block",
         lambda rg: fused_swin_block(leaf(sw[0], rg), *sw[1:])),
    ]


def test_kernel_wrappers_refuse_inputs_that_require_grad(card):
    """A kernel's output has no grad_fn: with grad enabled and an input that
    requires grad, every wrapper raises before it launches (the count does
    not move); under no_grad, or without such an input, it launches."""
    for name, key, call in _grad_cases(card):
        n = kernels.LAUNCHES[key]
        with pytest.raises(RuntimeError, match="no backward"):
            call(True)
        assert kernels.LAUNCHES[key] == n, name
        with torch.no_grad():
            assert not call(True).requires_grad
        call(False)
        assert kernels.LAUNCHES[key] == n + 2, name


def test_training_takes_no_kernel_and_the_serving_vit_refuses_to_train(card):
    from macaque_tpu_torch.nn import ViTPose, VitPoseConfig
    from macaque_tpu_torch.nn import train as ttrain

    def step(use_kernel):
        torch.manual_seed(0)
        m = ViTPose(VitPoseConfig(compute_dtype=torch.bfloat16,
                                  use_pallas_attention=use_kernel, depth=2),
                    device=card)
        p, s = ttrain.train_state(m)
        opt = ttrain.make_pose_optimizer(p, num_layers=2)
        rng = np.random.default_rng(0)
        crops = torch.from_numpy(rng.normal(0, 1, (2, 256, 192, 3))
                                 .astype(np.float32)).to(card)
        kps = torch.from_numpy(rng.uniform(8, 180, (2, 17, 2))
                               .astype(np.float32)).to(card)
        return ttrain.make_pose_train_step(m, opt)(
            p, s, opt.init(p), crops, kps, torch.ones(2, 17, device=card))

    before = dict(kernels.LAUNCHES)
    loss = step(False)[3]
    assert torch.isfinite(loss) and kernels.LAUNCHES == before
    with pytest.raises(RuntimeError, match="no backward"):
        step(True)


def test_pose_train_step_on_the_card_matches_the_cpu(card):
    """Two small-width float32 pose steps: loss and parameters within 1e-4
    relative of the CPU's (TF32 off for the convolutions)."""
    from macaque_tpu_torch.nn import ViTPose, VitPoseConfig
    from macaque_tpu_torch.nn import train as ttrain

    cfg = VitPoseConfig(img_size=(64, 48), embed_dim=64, depth=2, num_heads=4,
                        deconv_channels=(32, 32))
    torch.manual_seed(0)
    sd = ViTPose(cfg, device="cpu").state_dict()
    rng = np.random.default_rng(1)
    batch = (rng.normal(0, 1, (4, 64, 48, 3)).astype(np.float32),
             rng.uniform(8, 40, (4, 17, 2)).astype(np.float32),
             np.ones((4, 17), np.float32))
    out = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", card):
            m = ViTPose(cfg, device=dev)
            m.load_state_dict(sd)
            p, s = ttrain.train_state(m)
            opt = ttrain.make_pose_optimizer(
                p, schedule=ttrain.pose_lr_schedule(2e-3, warmup_steps=5),
                num_layers=2)
            st, step = opt.init(p), ttrain.make_pose_train_step(m, opt)
            losses = []
            for _ in range(2):
                p, s, st, loss = step(p, s, st, *(torch.from_numpy(a).to(dev)
                                                  for a in batch))
                losses.append(float(loss))
            out[str(dev)] = losses, {k: v.cpu() for k, v in {**p, **s}.items()}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (lc, pc), (lg, pg) = out["cpu"], out[str(card)]
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    for k, v in pc.items():
        np.testing.assert_allclose(pg[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-4 * v.abs().max().item(), err_msg=k)


@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-3),
                                         (torch.float64, 1e-9)])
def test_device_tracker_on_the_card_matches_the_cpu(card, dtype, atol):
    from macaque_tpu_torch.tracking import make_table, track_chunk_device

    rng = np.random.default_rng(4)
    T, D = 48, 8
    c0 = rng.uniform(200, 1800, (5, 2))
    boxes = np.zeros((T, D, 4))
    scores = np.zeros((T, D))
    for t in range(T):
        for a in range(5):
            if rng.uniform() < 0.1:
                continue
            c = c0[a] + 3 * t + rng.normal(0, 1.5, 2)
            boxes[t, a] = [c[0] - 60, c[1] - 90, c[0] + 60, c[1] + 90]
            scores[t, a] = rng.uniform(0.3, 0.99)
    _, bc, tc = track_chunk_device(make_table(16, "cpu", torch.float64),
                                   boxes, scores)
    table = make_table(16, card, dtype)
    assert table.mean.device.type == "cuda"
    outs = [track_chunk_device(table, boxes[:24], scores[:24])]
    outs.append(track_chunk_device(outs[0][0], boxes[24:], scores[24:]))
    tg = torch.cat([o[2] for o in outs]).cpu()
    bg = torch.cat([o[1] for o in outs]).cpu().double()
    assert torch.equal(tg, tc) and (tc >= 0).sum() > 50
    np.testing.assert_array_equal(torch.isnan(bg).numpy(), torch.isnan(bc).numpy())
    np.testing.assert_allclose(bg.numpy(), bc.numpy(), rtol=0, atol=atol)


# ------------------------------------------------------------ calibration

CALIB_SOLVERS = ("calibrate_intrinsics_omnidir", "calibrate_intrinsics_fisheye",
                 "bundle_adjust_extrinsics", "bundle_adjust_fisheye",
                 "bundle_adjust_full")


def _calib_case(fn):
    import calib_cases as cc

    if fn == "calibrate_intrinsics_omnidir":
        obj, img, kw = cc.intrinsic_scene()
        return (obj, img), kw
    if fn == "calibrate_intrinsics_fisheye":
        obj, img, kw = cc.fisheye_intrinsic_scene()
        return (obj, img), kw
    scene = {"bundle_adjust_extrinsics": cc.extrinsic_scene,
             "bundle_adjust_fisheye": cc.fisheye_ba_scene,
             "bundle_adjust_full": cc.full_scene}[fn]
    return scene()[0], {}


@pytest.mark.parametrize("fn", CALIB_SOLVERS)
def test_calibration_solver_on_the_card_matches_the_cpu(card, fn):
    """Each solver runs on the card when given no device, and agrees with
    the CPU at the tier-1 tests' short budget (15 LM iterations of 2 CG
    sweeps), float64: equal counts, outputs within 1e-8 of their largest
    value (the card's reductions sum in another order: the noise-free full
    BA's distortion parted by 1.07e-9 in the first card run)."""
    from macaque_tpu_torch.calib import bundle
    from macaque_tpu_torch.geometry.lm import LMConfig

    args, kw = _calib_case(fn)
    cfg = LMConfig(lm_iters=15, cg_iters=2, ftol=1e-12)
    got = {}
    for dev in (None, "cpu"):
        info = {}
        on = {} if dev is None else {"device": dev}
        out = getattr(bundle, fn)(*args, **kw, cfg=cfg, dtype=torch.float64,
                                  info=info, **on)
        got[dev] = (out, info)
    (og, ig), (oc, ic) = got[None], got["cpu"]
    assert (ig["lm_iters"], ig["cg_iters"]) == (ic["lm_iters"], ic["cg_iters"])
    for g, c in zip(og, oc):
        g, c = np.asarray(g, float), np.asarray(c, float)
        assert np.abs(g - c).max() <= 1e-8 * max(np.abs(c).max(), 1e-30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_omnidir_intrinsics_default_budget_on_the_card(card, dtype):
    """The omnidir fit of tests/test_calib.py's 12-view board at its
    default budget (300 LM iterations of up to 150 CG sweeps, ~45,000
    sweeps), on the card in each precision: the JAX test's bound (rms
    < 0.1 px, twice the noise). Neither package converges within the
    budget, so the CPU parity test holds a 40-iteration budget
    (tests/test_torch_calib_intrinsics.py)."""
    from macaque_tpu_torch.calib import bundle

    (obj, img), kw = _calib_case("calibrate_intrinsics_omnidir")
    info = {}
    out = bundle.calibrate_intrinsics_omnidir(obj, img, **kw, dtype=dtype,
                                              info=info)
    assert info["lm_iters"] == 300
    assert out[-1] < 0.1, out[-1]


def _eager_lm_solve(resid_fn, x0, cfg=None, return_info=False):
    """``lm_solve`` with its loop eager on the card (the solver's private
    ``_lm_solve_batch`` without graphs), for the graph-replay tests."""
    from macaque_tpu_torch.geometry import lm

    x, info = lm._lm_solve_batch(resid_fn, x0, cfg or lm.LMConfig())
    return (x, info) if return_info else x


def test_lm_solve_graph_replays_equal_eager(card, monkeypatch):
    """``lm_solve`` on the card replays the CGLS sweeps and the Hutchinson
    probes from CUDA graphs: the same kernels on the same buffers, so the
    same bits as the eager loop, and the same counts."""
    from macaque_tpu_torch.calib import bundle
    from macaque_tpu_torch.geometry import lm

    args, kw = _calib_case("bundle_adjust_full")
    got = []
    for eager in (True, False):
        with monkeypatch.context() as m:
            if eager:
                m.setattr(bundle, "lm_solve", _eager_lm_solve)
            info = {}
            out = bundle.bundle_adjust_full(
                *args, cfg=lm.LMConfig(lm_iters=8, cg_iters=40, ftol=1e-12),
                device=card, dtype=torch.float32, info=info)
        got.append((out, info))
    (oe, ie), (og, ig) = got
    assert {k: ie[k] for k in ("lm_steps", "cg_sweeps", "host_reads")} == \
        {k: ig[k] for k in ("lm_steps", "cg_sweeps", "host_reads")}
    for e, g in zip(oe, og):
        np.testing.assert_array_equal(np.asarray(e), np.asarray(g))


def _refine_case(card, n_animal=2, n_frame=48, seed=4):
    """A step-4-like refinement on the card, float32: the synthetic rig's
    4 cameras, 2 px of keypoint noise with 10 % missing, the truth moved
    by 20 mm as the start, the macaque skeleton's strong constraints."""
    from macaque_tpu_torch.cameras.dispatch import project_points
    from macaque_tpu_torch.core.config import (
        MACAQUE_CONSTRAINTS, constraint_indices)
    from macaque_tpu_torch.tools.synthetic import (
        make_test_rig, simulate_scene)

    rng = np.random.default_rng(seed)
    rig = make_test_rig(4, seed)
    kp3d = simulate_scene(n_animal, n_frame, seed=seed)
    A, F, J, _ = kp3d.shape
    cam = rig.camera(card, torch.float32)
    pts = torch.as_tensor(kp3d.reshape(A, 1, F * J, 3), device=card,
                          dtype=torch.float32)
    pix = project_points(cam, pts).reshape(A, rig.n_cam, F, J, 2)
    pix = pix + torch.as_tensor(rng.normal(0, 2.0, tuple(pix.shape)),
                                device=card, dtype=torch.float32)
    miss = torch.as_tensor(rng.uniform(size=tuple(pix.shape[:-1])) < 0.1,
                           device=card)
    pix = torch.where(miss[..., None], torch.nan, pix)
    init = torch.as_tensor(kp3d + rng.normal(0, 20.0, kp3d.shape),
                           device=card, dtype=torch.float32)
    return cam, pix, init, constraint_indices(MACAQUE_CONSTRAINTS)


def test_refine_graph_replays_equal_eager(card, monkeypatch):
    """Step 4's batched refinement replays its sweeps from CUDA graphs on
    the card too: bit for bit the eager loop's points and lengths, with
    the same counts, on a two-animal scene at its production budget."""
    from macaque_tpu_torch.geometry import refine3d

    cam, p2d, p3d, cons = _refine_case(card)
    got = []
    for eager in (True, False):
        with monkeypatch.context() as m:
            if eager:
                m.setattr(refine3d, "lm_solve", _eager_lm_solve)
            got.append(refine3d.refine_points_3d_batch(
                cam, p2d, p3d, cons, (), refine3d.RefineConfig(),
                return_info=True))
    (pe, je, ie), (pg, jg, ig) = got
    for k in ("lm_steps", "cg_sweeps", "host_reads"):
        assert ie[k] == ig[k], k
    assert torch.equal(pe, pg) and torch.equal(je, jg)


def test_camera_group_bundle_adjust_stays_on_the_card(card, monkeypatch):
    """``CameraGroup(rig)`` (no device) works on the card: its cameras and
    every solve of ``bundle_adjust`` live there."""
    import calib_cases as cc

    from macaque_tpu_torch.calib import bundle
    from macaque_tpu_torch.cameras.rig import CameraRig
    from macaque_tpu_torch.compat.aniposelib import CameraGroup

    K, xi, D, rvec, tvec = cc.make_rig(3, seed=0)
    g = CameraGroup(CameraRig(camera_ids=["0", "1", "2"], K=K, xi=xi, D=D,
                              rvec=rvec, tvec=tvec, size=(2048, 1536)))
    assert g.device.type == "cuda" and g._cam().K.is_cuda
    rng = np.random.default_rng(3)
    p2d = g.project(rng.normal(0, 220, (120, 3)))
    g.cameras[1].set_rotation(g.cameras[1].get_rotation() + 0.01)
    seen = []
    solve = bundle.lm_solve

    def spy(resid, x0, *a, **k):
        seen.append(x0.device)
        return solve(resid, x0, *a, **k)

    monkeypatch.setattr(bundle, "lm_solve", spy)
    err = g.bundle_adjust(p2d, verbose=False)
    assert seen and all(d.type == "cuda" for d in seen)
    assert err < 1.0 and g._cam().K.is_cuda


def _session_case(tmp_path, n_frame=48, seed=2):
    """One animal's 17 joints in the synthetic rig's 4 cameras: 0.5 px of
    noise, 10 % of the detections dropped, and an autoencoder trained on
    the CPU (float64) for the filter chain."""
    from macaque_tpu_torch.cameras.omnidir import omnidir_project
    from macaque_tpu_torch.filters.autoencoder import (
        save_autoencoder, train_autoencoder)
    from macaque_tpu_torch.tools.synthetic import (
        make_test_rig, simulate_scene)

    rng = np.random.default_rng(seed)
    rig = make_test_rig(4, seed)
    kp3d = simulate_scene(1, n_frame, seed=seed)[0]
    F, J, _ = kp3d.shape
    pix = omnidir_project(rig.omni("cpu", torch.float64),
                          torch.as_tensor(kp3d.reshape(-1, 3))).numpy()
    pix = pix.reshape(rig.n_cam, F, J, 2) + rng.normal(0, 0.5, (4, F, J, 2))
    scores = rng.uniform(0.6, 1.0, (4, F, J))
    drop = rng.uniform(size=scores.shape) < 0.1
    pix[drop], scores[drop] = np.nan, 0.02
    path = str(tmp_path / "ae.npz")
    save_autoencoder(train_autoencoder(scores.reshape(-1, J), 0.05,
                                       epochs=50, device="cpu",
                                       dtype=torch.float64), path)
    fcfg = {"type": ["medfilt", "viterbi", "autoencoder"], "medfilt": 7,
            "n_back": 3, "autoencoder_path": path}
    tri = {"ransac": True, "optim": True, "score_threshold": 0.5,
           "scale_smooth": 3.0, "scale_length": 5.0, "scale_length_weak": 2.0,
           "reproj_error_threshold": 3.0, "n_deriv_smooth": 2}
    return rig, kp3d, pix, scores, fcfg, tri


def _session_core(rig, pix, scores, fcfg, tri, device, dtype):
    """``filter_pose_2d_arrays`` on each camera, then ``triangulate_arrays``
    with the refinement at the tests' short budget (15 LM iterations of 2
    CG sweeps), the macaque constraints."""
    from macaque_tpu_torch.compat.aniposelib import CameraGroup
    from macaque_tpu_torch.core.config import (
        MACAQUE_CONSTRAINTS, constraint_indices)
    from macaque_tpu_torch.tools.session import (
        filter_pose_2d_arrays, triangulate_arrays)

    class Short(CameraGroup):
        def _refine_config(self, kwargs):
            return super()._refine_config(kwargs)._replace(lm_iters=15,
                                                           cg_iters=2)

    filt = [filter_pose_2d_arrays(fcfg, p, s, device, dtype)
            for p, s in zip(pix, scores)]
    pts = np.stack([p for p, _ in filt])
    scs = np.stack([s for _, s in filt])
    out = triangulate_arrays(Short(rig, device, dtype), pts, scs, tri,
                             constraint_indices(MACAQUE_CONSTRAINTS))
    return pts, scs, out


def test_session_array_core_on_the_card_matches_the_cpu(card, tmp_path):
    """The session tools' array core (``chip_smoke.py``'s ``session``
    phase at 48 frames of 4 cameras), card against CPU in float64: the
    filter chain's points equal (the Viterbi picks), its scores and the
    triangulation's points, errors, ncams and scores within 1e-8 of their
    largest value, NaNs in the same places."""
    rig, kp3d, pix, scores, fcfg, tri = _session_case(tmp_path)
    got = _session_core(rig, pix, scores, fcfg, tri, card, torch.float64)
    want = _session_core(rig, pix, scores, fcfg, tri, "cpu", torch.float64)
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip([got[1], *got[2]], [want[1], *want[2]]):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        scale = np.nanmax(np.abs(b))
        assert np.nanmax(np.abs(a - b)) <= 1e-8 * scale
    err = np.nanmedian(np.linalg.norm(got[2][0] - kp3d, axis=-1))
    assert err < 30.0, err


def test_session_array_core_runs_on_the_card_by_default(card, tmp_path,
                                                        monkeypatch):
    """Given no device, the filter chain's Viterbi pass and the
    triangulation's group run on the card (float32)."""
    from macaque_tpu_torch.compat.aniposelib import CameraGroup
    from macaque_tpu_torch.filters import viterbi
    from macaque_tpu_torch.tools.session import (
        filter_pose_2d_arrays, triangulate_arrays)

    rig, kp3d, pix, scores, fcfg, tri = _session_case(tmp_path)
    seen = []
    run = viterbi.viterbi_filter_joints

    def spy(points, *a, **k):
        seen.append(points.device)
        return run(points, *a, **k)

    monkeypatch.setattr(viterbi, "viterbi_filter_joints", spy)
    pts, scs = filter_pose_2d_arrays(fcfg, pix[0], scores[0])
    assert seen and seen[0].type == "cuda"
    assert pts.shape == pix[0].shape and scs.shape == scores[0].shape
    group = CameraGroup(rig)
    assert group.device.type == "cuda"
    p3d, err, ncams, sc3d = triangulate_arrays(
        group, pix, scores, dict(tri, optim=False))
    assert p3d.shape == kp3d.shape and np.isfinite(p3d).mean() > 0.9


def _small_perception(device):
    """A small-width TorchPerception (the widths of tests/torch_parity.py,
    built without JAX), weights from seed 0, the box head's foreground bias
    raised so that boxes pass the threshold. On the card the detector
    computes in bf16 (K2 takes only a bf16 canvas), the pose and ID models
    in float32; on the CPU all in float32."""
    from macaque_tpu_torch.nn import (
        DetectorConfig, ResNetClassifier, ResNetConfig, SwinMaskRCNN,
        ViTPose, VitPoseConfig)
    from macaque_tpu_torch.nn.swin import SwinConfig
    from macaque_tpu_torch.pipeline.perception import TorchPerception

    def detector(dtype, dev):
        return SwinMaskRCNN(DetectorConfig(
            swin=SwinConfig(embed_dim=16, depths=(2, 2, 2, 2),
                            num_heads=(2, 4, 4, 8), compute_dtype=dtype),
            fpn_channels=32, rpn_nms_pre=50, rpn_max=50, rcnn_max=10,
            rcnn_roi_topk=50, rcnn_roi_chunk=16, compute_dtype=dtype),
            device=dev)

    torch.manual_seed(0)
    det = detector(torch.float32, "cpu")
    with torch.no_grad():
        det.roi_head.bbox_head.fc_cls.bias[0] += 6.0
    pose = ViTPose(VitPoseConfig(img_size=(64, 48), embed_dim=64, depth=2,
                                 num_heads=4, deconv_channels=(32, 32)),
                   device="cpu")
    idm = ResNetClassifier(ResNetConfig(), device="cpu")
    if device != "cpu":
        card_det = detector(torch.bfloat16, "cuda")
        card_det.load_state_dict(det.state_dict())
        det, pose, idm = card_det, pose.to("cuda"), idm.to("cuda")
    return TorchPerception(det, pose, idm, max_det=4, det_target=128,
                           device=device)


def test_pose_2d_frames_on_the_card_by_default_matches_the_cpu(card,
                                                               monkeypatch):
    """``tools/run2d.pose_2d_frames`` through a perception given no device
    (the card: a bf16 detector, a float32 pose with TF32 off): its mask is
    the card detector's scores above the threshold, which keeps as many
    boxes as the float32 detector on the CPU (the scores sit near 0.99,
    far from 0.5); the CPU's float32 pose on the card's boxes gives the
    same NaN pattern, keypoint scores within 1e-4, keypoints within 0.1 px
    where their score reaches 0.3 and at least 90 % of all joints within
    0.1 px (tests/test_torch_run2d.py's tolerances)."""
    from macaque_tpu_torch.tools.run2d import pose_2d_frames

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rng = np.random.default_rng(0)
    frames = np.kron(rng.integers(40, 200, (8, 12, 16, 3)),
                     np.ones((1, 8, 8, 1))).astype(np.uint8)
    frames[:, 20:60, 30:70] = (220, 200, 40)
    on_card, on_cpu = _small_perception(None), _small_perception("cpu")
    assert on_card.device.type == "cuda"
    kc, vc = pose_2d_frames(on_card, frames, 0.5)
    boxes, scores = on_card.detect(frames)
    np.testing.assert_array_equal(vc, scores > 0.5)
    assert vc.any() and kc.shape == (8, 4, 17, 3)
    assert vc.sum() == (on_cpu.detect(frames)[1] > 0.5).sum()
    kh = on_cpu.pose(frames, boxes, vc)
    np.testing.assert_array_equal(np.isnan(kc), np.isnan(kh))
    np.testing.assert_allclose(kc[..., 2], kh[..., 2], atol=1e-4)
    sure = kh[..., 2] >= 0.3
    np.testing.assert_allclose(kc[sure][:, :2], kh[sure][:, :2], atol=0.1)
    moved = np.abs(kc[vc][..., :2] - kh[vc][..., :2]).max(-1)
    assert np.mean(moved <= 0.1) >= 0.9


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pictorial_on_the_card_matches_the_cpu(card, dtype):
    """``infer_pictorial_3d`` picks equal card against CPU on 20 problems
    at C = 16 and on a tie (first maximum on both); ``transitive_closure``
    and ``closure_to_clusters`` (on the card by default) equal."""
    from macaque_tpu_torch.association.pictorial import (
        closure_to_clusters, infer_pictorial_3d, transitive_closure)

    rng = np.random.default_rng(1)
    for trial in range(21):
        args = [rng.uniform(0, 1, (13, 16)), rng.uniform(-500, 500, (13, 16, 3)),
                rng.uniform(80, 150, 13), rng.uniform(5, 30, 13)]
        if trial == 20:                      # columns c and c + 8 tie
            args[0][:, 8:] = args[0][:, :8]
            args[1][:, 8:] = args[1][:, :8]
        got = infer_pictorial_3d(*(torch.as_tensor(a, dtype=dtype, device=card)
                                   for a in args))
        assert got.device.type == "cuda"
        want = infer_pictorial_3d(*(torch.as_tensor(a, dtype=dtype)
                                    for a in args))
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    for N in (5, 48, 130):
        X = (rng.uniform(size=(3, N, N)) < 2.0 / N)
        got = transitive_closure(torch.as_tensor(X, device=card))
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      transitive_closure(torch.as_tensor(X)).numpy())
        sym = (X[0] | X[0].T).astype(np.uint8)
        np.fill_diagonal(sym, 0)
        np.testing.assert_array_equal(closure_to_clusters(sym),
                                      closure_to_clusters(sym, device="cpu"))


# ------------------------------------------------------ the mesh on the card

def test_every_kernel_wrapper_launches_under_its_inputs_device(card,
                                                               monkeypatch):
    """Each wrapper's C call runs with its input's device current
    (``kernels.launch``): the current device is read inside every call to
    the kernel library. One card cannot show a launch on a second GPU;
    tests/test_torch_mesh.py holds the guard itself with a fake library."""
    real = kernels.library()
    seen = []

    class Spy:
        def __getattr__(self, entry):
            fn = getattr(real, entry)

            def call(*args):
                seen.append((entry, torch.cuda.current_device()))
                return fn(*args)
            return call

    monkeypatch.setattr(kernels, "library", Spy)
    with torch.no_grad():
        for name, key, call in _grad_cases(card):
            n, before = kernels.LAUNCHES[key], len(seen)
            call(False)
            assert kernels.LAUNCHES[key] > n, name
            launched = [d for e, d in seen[before:]
                        if not e.endswith(("_slots", "_blocks_per_sm"))]
            assert launched and all(
                d == (card.index or 0) for d in launched), (name, launched)
    torch.cuda.synchronize()


def _mesh_scene(tmp_path):
    from macaque_tpu_torch.pipeline.artifacts import write_alldata
    from macaque_tpu_torch.tools import synthetic as s

    rig = s.make_test_rig(4, seed=21)
    percam = s.synthesize_alldata(rig, s.simulate_scene(2, 96, seed=22),
                                  seed=23)

    def write(tag):
        rd = str(tmp_path / tag)
        for c, cam_id in enumerate(rig.camera_ids):
            write_alldata(f"{rd}/{cam_id}", percam[c],
                          np.arange(96, dtype=np.int32))
        return rd
    return rig, write


def test_steps_2_to_4_under_a_four_entry_mesh_match_no_mesh(card, tmp_path):
    """tests/test_multichip.py's scene and bounds on the card (float32):
    steps 2-4 under four entries of ``cuda:0`` against ``mesh=None`` at the
    JAX test's converged budget: equal bcombs, kp2d within 1e-9, kp3d
    within 2 mm with the same finite pattern."""
    from macaque_tpu_torch.core.mesh import make_mesh
    from macaque_tpu_torch.pipeline.artifacts import read_pickle
    from macaque_tpu_torch.pipeline.step2 import run_step2
    from macaque_tpu_torch.pipeline.step3 import run_step3
    from macaque_tpu_torch.pipeline.step4 import run_step4

    rig, write = _mesh_scene(tmp_path)
    budget = dict(lm_iters=100, cg_iters=300, cg_rtol=1e-4)
    rd = {}
    for tag, mesh in (("single", None),
                      ("mesh", make_mesh(devices=[card] * 4))):
        rd[tag] = write(tag)
        run_step2(rd[tag], rig, mesh=mesh)
        run_step3(rd[tag], rig, mesh=mesh)
        run_step4(rd[tag], rig, mesh=mesh, refine_overrides=budget)
    mk = {t: read_pickle(f"{rd[t]}/match_keyframe.pickle") for t in rd}
    assert len(mk["single"]) == len(mk["mesh"]) > 3
    for a, b in zip(mk["single"], mk["mesh"]):
        assert ({tuple(x.tolist()) for x in a["bcomb"]}
                == {tuple(x.tolist()) for x in b["bcomb"]})
    k2 = {t: np.asarray(read_pickle(f"{rd[t]}/kp2d.pickle")) for t in rd}
    np.testing.assert_array_equal(np.isnan(k2["mesh"]), np.isnan(k2["single"]))
    ok = ~np.isnan(k2["single"])
    np.testing.assert_allclose(k2["mesh"][ok], k2["single"][ok], rtol=0,
                               atol=1e-9)
    k3 = {t: read_pickle(f"{rd[t]}/kp3d.pickle")["kp3d"] for t in rd}
    fin = np.isfinite(k3["single"])
    np.testing.assert_array_equal(np.isfinite(k3["mesh"]), fin)
    assert fin.any()
    assert np.abs(k3["mesh"][fin] - k3["single"][fin]).max() < 2.0


def test_perception_under_a_four_entry_mesh_matches_no_mesh(card):
    """The small perception of ``_small_perception`` (bf16 detector, float32
    pose on the card) under four entries of ``cuda:0`` against
    ``mesh=None`` on 6 frames: boxes within 0.05 px, scores within 1e-4,
    equal labels (tests/test_multichip.py's bounds); the pose's NaN
    pattern equal, keypoint scores within 1e-4, keypoints within 0.05 px
    where their score reaches 0.3 and at least 90 % of all joints within
    0.05 px: the random-weight pose's heatmaps are nearly flat, and a
    batch of another size (another cuBLAS algorithm) moves the argmax of
    a few low-score joints (tests/test_torch_run2d.py's rule)."""
    from macaque_tpu_torch.core.mesh import make_mesh
    from macaque_tpu_torch.pipeline.perception import TorchPerception

    single = _small_perception(card)
    sharded = TorchPerception(single.detector_model, single.pose_model,
                              single.id_model, max_det=4, det_target=128,
                              mesh=make_mesh(devices=[card] * 4))
    frames = np.random.default_rng(0).integers(0, 255, (6, 96, 128, 3),
                                               dtype=np.uint8)
    b0, s0 = single.detect(frames)
    b1, s1 = sharded.detect(frames)
    np.testing.assert_allclose(s1, s0, rtol=0, atol=1e-4)
    np.testing.assert_allclose(b1, b0, rtol=0, atol=0.05)
    valid = s0 > 0.5
    k0, k1 = single.pose(frames, b0, valid), sharded.pose(frames, b0, valid)
    np.testing.assert_array_equal(np.isnan(k1), np.isnan(k0))
    assert valid.any()
    np.testing.assert_allclose(k1[valid][..., 2], k0[valid][..., 2], rtol=0,
                               atol=1e-4)
    sure = k0[..., 2] >= 0.3
    np.testing.assert_allclose(k1[sure][:, :2], k0[sure][:, :2], rtol=0,
                               atol=0.05)
    moved = np.abs(k1[valid][..., :2] - k0[valid][..., :2]).max(-1)
    assert np.mean(moved <= 0.05) >= 0.9
    (l0, c0), (l1, c1) = (p.classify(frames, b0, valid)
                          for p in (single, sharded))
    np.testing.assert_array_equal(l1, l0)
    np.testing.assert_allclose(c1, c0, rtol=0, atol=1e-4)


def test_pipeline_bench_serving_tier_on_the_card(card, tmp_path, monkeypatch):
    """``tools/pipeline_bench.run`` on the card at 26 frames (the shortest
    scene with keyframes and tracks) with the ``serving`` tier alone: the
    JAX tool's keys, the device's name, and the tier's K1, K2 and K5b
    launches."""
    from macaque_tpu_torch.tools import pipeline_bench

    for k, v in (("BENCH_STEP1_REAL", "1"), ("BENCH_STEP1_PARITY", "0"),
                 ("BENCH_STEP1_FAST", "0")):
        monkeypatch.setenv(k, v)
    before = dict(kernels.LAUNCHES)
    out = pipeline_bench.run(n_frame=26, n_cam=4, render=False,
                             root=str(tmp_path))
    assert out["camera_frames"] == 104 and out["step1_real_s"] > 0
    assert "e2e_measured_cf_s" in out and "step1_parity_s" not in out
    assert torch.cuda.get_device_name(card).split()[0] in out["device"]
    for k in ("packed_attention", "roi_align_windowed", "quant_int8_matmul"):
        assert kernels.LAUNCHES[k] > before[k], k
