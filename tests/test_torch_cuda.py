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
    packed_attention, packed_attention_reference)
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
