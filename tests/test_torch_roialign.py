"""The port's windowed RoIAlign (``macaque_tpu_torch.nn.roialign``) against
the JAX package's XLA path (``ops.roi_align_windowed``) and its Pallas
kernel in interpret mode, in every window bucket; the window-bucket
selection and the geometry against the JAX package's. The CUDA kernel
is held against its plain version on a card in test_torch_cuda.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from macaque_tpu.nn import ops as jops
from macaque_tpu.nn import pallas_roialign as jroi
from macaque_tpu_torch import kernels
from macaque_tpu_torch.nn import ops as tops
from macaque_tpu_torch.nn.roialign import (
    WINDOW_BUCKETS, roi_align_windowed, roi_align_windowed_reference,
    roi_align_windows, roi_align_windows_reference, roi_window_buckets,
    window_inputs)

STRIDES = (4, 8, 16, 32)


def _case(seed, B=2, R=12, C=16, H0=64):
    """FPN levels 0-3 of an (4*H0)-pixel image and RoIs of every kind: tiny
    (bucket 16), level-boundary squares, aspect 2 at a level's top scale,
    aspect 4 (clamped even at 48), border-clipped and degenerate zero
    boxes. RoIs in float64 so both packages build the same geometry."""
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(B, H0 >> l, H0 >> l, C)).astype(np.float32)
             for l in range(4)]
    img = 4 * H0
    boxes = []
    for _ in range(B):
        rows = []
        for i in range(R):
            kind = i % 6
            if kind == 5:
                rows.append((0.0, 0.0, 0.0, 0.0))
                continue
            h = {0: rng.uniform(8, 40), 1: rng.uniform(100, 112),
                 2: rng.uniform(70, 79), 3: rng.uniform(40, 50),
                 4: rng.uniform(60, 120)}[kind]
            w = {2: 2 * h, 3: 4 * h}.get(kind, h)
            x1, y1 = rng.uniform(-10, img - 10, 2)
            rows.append((max(x1, 0), max(y1, 0), min(x1 + w, img),
                         min(y1 + h, img)))
        boxes.append(rows)
    rois = np.asarray(boxes, np.float64)
    wh = np.maximum(rois[..., 2:] - rois[..., :2], 0)
    lvl = np.clip(np.floor(np.log2(np.sqrt(wh[..., 0] * wh[..., 1]) / 56.0
                                   + 1e-6)), 0, 3).astype(np.int32)
    return feats, rois, lvl


def _torch(feats, rois, lvl):
    return ([torch.from_numpy(f) for f in feats], torch.from_numpy(rois),
            torch.from_numpy(lvl).long())


def _jax(feats, rois, lvl):
    return [jnp.asarray(f) for f in feats], jnp.asarray(rois), jnp.asarray(lvl)


# float32 features, float64 geometry on both sides: the outputs differ only
# by float32 summation order
@pytest.mark.parametrize("window", WINDOW_BUCKETS)
def test_reference_matches_xla_path(window):
    case = _case(0)
    want = np.asarray(jops.roi_align_windowed(*_jax(*case), 7, STRIDES,
                                              window=window))
    got = roi_align_windowed_reference(*_torch(*case), 7, STRIDES,
                                       window=window).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", WINDOW_BUCKETS)
def test_reference_matches_pallas_kernel(window):
    case = _case(1)
    want = np.asarray(jroi.roi_align_windowed_fused(
        *_jax(*case), 7, STRIDES, window=window, interpret=True))
    got = roi_align_windowed_reference(*_torch(*case), 7, STRIDES,
                                       window=window).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_window_buckets_equal_jax():
    case = _case(2, R=60)
    want = np.asarray(jroi.roi_window_buckets(*_jax(*case), 7, STRIDES))
    got = roi_window_buckets(*_torch(*case), 7, STRIDES).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == set(range(len(WINDOW_BUCKETS)))


def test_bucketed_windows_equal_widest_window():
    """Each RoI aligned in its own bucket's window equals the 48 px window
    (the exactness the detector's bucket-sorted chunks rely on)."""
    feats, rois, lvl = _torch(*_case(3, R=30))
    need = roi_window_buckets(feats, rois, lvl, 7, STRIDES)
    full = roi_align_windowed_reference(feats, rois, lvl, 7, STRIDES)
    for i, w in enumerate(WINDOW_BUCKETS):
        sel = need == i
        got = roi_align_windowed_reference(feats, rois, lvl, 7, STRIDES,
                                           window=w)
        torch.testing.assert_close(got[sel], full[sel], atol=1e-5, rtol=1e-5)


def test_geometry_matches_jax():
    case = _case(4)
    feats_j = _jax(*case)[0]
    _, ys_j, xs_j, ky_j, kx_j, w_j = jops._roi_window_geometry(
        feats_j, jnp.asarray(case[1]), jnp.asarray(case[2]), 7, STRIDES, 2, 32)
    _, ys, xs, ky, kx, w = tops._roi_window_geometry(*_torch(*case), 7,
                                                     STRIDES, 2, 32)
    assert w == w_j
    np.testing.assert_array_equal(ys.numpy(), np.asarray(ys_j))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(xs_j))
    np.testing.assert_allclose(ky.numpy(), np.asarray(ky_j), atol=1e-12)
    np.testing.assert_allclose(kx.numpy(), np.asarray(kx_j), atol=1e-12)


def test_wrapper_runs_plain_version_on_cpu():
    args = window_inputs(*_torch(*_case(5)), 7, STRIDES, window=24)
    before = dict(kernels.LAUNCHES)
    torch.testing.assert_close(roi_align_windows(*args),
                               roi_align_windows_reference(*args),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        roi_align_windowed(*_torch(*_case(5)), 7, STRIDES, window=24),
        roi_align_windowed_reference(*_torch(*_case(5)), 7, STRIDES,
                                     window=24), rtol=0, atol=0)
    assert kernels.LAUNCHES == before
