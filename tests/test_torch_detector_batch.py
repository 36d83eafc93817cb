"""``detect_frames`` runs the detector's trunk once over the whole chunk:
the same FPN maps, RPN outputs and detections as the trunk run one image
at a time and the head once over the chunk, in float32 and in bf16, on a
small-width detector on the CPU."""

import numpy as np
import pytest
import torch

from macaque_tpu_torch.nn import DetectorConfig, SwinMaskRCNN
from macaque_tpu_torch.nn.detector import detect_frames
from macaque_tpu_torch.nn.swin import SwinConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _detector(dtype):
    """Weights from seed 0, the box head's foreground bias raised so that
    every image has detections."""
    torch.manual_seed(0)
    model = SwinMaskRCNN(DetectorConfig(
        swin=SwinConfig(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 4, 4, 8),
                        compute_dtype=dtype),
        fpn_channels=32, rpn_nms_pre=50, rpn_max=50, rcnn_max=10,
        rcnn_roi_topk=50, rcnn_roi_chunk=16, compute_dtype=dtype), device="cpu")
    with torch.no_grad():
        model.roi_head.bbox_head.fc_cls.bias[0] += 3.0
    return model


def _close(got, want, dtype):
    """float32: summation order only; bf16: a reordered float32 sum that
    lands on the other side of a bf16 rounding boundary moves an output by
    an ulp of its magnitude, held to 2^-5 of the largest output (as the
    fused Swin block's bf16 test holds it)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float().numpy(), want.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(g, w, atol=2.0 ** -5 * np.abs(w).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B", [1, 3])
def test_batched_trunk_matches_the_trunk_image_by_image(B, dtype):
    dt = DTYPES[dtype]
    model = _detector(dt)
    images = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, 128, 96, 3)).astype(np.float32))
    trunk, calls = model.trunk, []

    def kept(x):            # the instance attribute the benchmark wraps too
        calls.append((len(x), trunk(x)))
        return calls[-1][1]

    model.trunk = kept
    with torch.no_grad():
        got = detect_frames(model, images)
        outs = [trunk(images[i:i + 1]) for i in range(B)]
        maps = [torch.cat([o[0][lvl] for o in outs]) for lvl in range(5)]
        rpn = [tuple(torch.cat([o[1][lvl][j] for o in outs]) for j in range(2))
               for lvl in range(5)]
        want = model.head(maps, rpn)
    assert [n for n, _ in calls] == [B]
    got_maps, got_rpn = calls[0][1]
    for g, w in zip(got_maps, maps, strict=True):
        _close(g, w, dt)
    for g, w in zip(got_rpn, rpn, strict=True):
        _close(g[0], w[0], dt)
        _close(g[1], w[1], dt)
    (bg, sg, vg), (bw, sw, vw) = got, want
    assert vg.shape == (B, 10) and vg.any()
    np.testing.assert_array_equal(vg.numpy(), vw.numpy())
    np.testing.assert_allclose(sg.numpy(), sw.numpy(), atol=1e-5)
    np.testing.assert_allclose(bg.numpy(), bw.numpy(), atol=5e-3)
