"""The public functions of the JAX package that the port gained last, against
their JAX counterparts on the same numpy inputs: the exact RoIAlign by flat
gather (``nn/ops.py::roi_align``, ``roi_align_pyramid`` single and
batched) and the windowed route held against it, the single-image resize
and detector input (``nn/preprocess.py``), the flip-test wrapper
(``nn/heatmap.py::pose_forward_flip``) and ``native.native_available``."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from macaque_tpu import nn as jnn
from macaque_tpu.nn import heatmap as jhm
from macaque_tpu.nn import ops as jops
from macaque_tpu.nn import preprocess as jpre
from macaque_tpu_torch import nn as tnn
from macaque_tpu_torch.nn import heatmap as thm
from macaque_tpu_torch.nn import ops as tops
from macaque_tpu_torch.nn import preprocess as tpre
from macaque_tpu_torch.nn.convert import vitpose_from_jax
from macaque_tpu_torch.nn.roialign import roi_align_windowed
from tests.torch_parity import VIT, load, random_variables

STRIDES = (4, 8, 16, 32)
# jitted: one program each instead of a compile per primitive
jax_roi_align = jax.jit(jops.roi_align, static_argnums=(2, 3))
jax_pyramid = jax.jit(jops.roi_align_pyramid, static_argnums=(3, 4))


def _pyramid(rng, C=8, B=None, hw=(64, 48)):
    """FPN levels 0-3 of a (4*h, 4*w) image, float32, batched when B."""
    lead = () if B is None else (B,)
    return [rng.normal(size=lead + (hw[0] >> l, hw[1] >> l, C)).astype(
        np.float32) for l in range(4)]


def _boxes(rng, shape, lo, hi, wh=(30, 80)):
    """xyxy float64 boxes with corners from ``lo`` (may lie off the map)."""
    xy = rng.uniform(lo, hi, shape + (2,))
    return np.concatenate([xy, xy + rng.uniform(*wh, shape + (2,))], -1)


# ------------------------------------------------------------- RoIAlign

@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_roi_align_matches_jax(scale):
    """One map, boxes inside, across the borders and wholly outside (their
    samples zero), at the JAX test's bound (tests/test_nn.py:444)."""
    rng = np.random.default_rng(21)
    feat = rng.normal(size=(32, 24, 8)).astype(np.float32)
    rois = _boxes(rng, (20,), -30 / scale, 40 / scale,
                  (8 / scale, 30 / scale))
    want = np.asarray(jax_roi_align(jnp.asarray(feat), jnp.asarray(rois), 7,
                                     scale))
    got = tops.roi_align(torch.from_numpy(feat), torch.from_numpy(rois), 7,
                         scale)
    assert got.shape == want.shape == (20, 7, 7, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_roi_align_constant_map():
    """A constant map gives the constant in every bin (JAX's own test)."""
    feat = torch.full((32, 32, 2), 3.5)
    out = tops.roi_align(feat, torch.tensor([[4.0, 4.0, 20.0, 28.0]]), 7, 1.0)
    torch.testing.assert_close(out, torch.full((1, 7, 7, 2), 3.5),
                               atol=1e-6, rtol=0)


def test_roi_align_pyramid_matches_jax_and_per_level():
    """tests/test_nn.py:428's scene: the pyramid against JAX's, and each RoI
    against ``roi_align`` on its own level."""
    rng = np.random.default_rng(8)
    feats = _pyramid(rng, hw=(64, 48))
    rois = _boxes(rng, (6,), 10, 150)
    levels = rng.integers(0, 4, 6).astype(np.int32)
    want = np.asarray(jax_pyramid(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois),
        jnp.asarray(levels), 7, STRIDES))
    tf = [torch.from_numpy(f) for f in feats]
    got = tops.roi_align_pyramid(tf, torch.from_numpy(rois),
                                 torch.from_numpy(levels), 7, STRIDES)
    assert got.shape == want.shape == (6, 7, 7, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    for i, lv in enumerate(levels):
        one = tops.roi_align(tf[lv], torch.from_numpy(rois[i:i + 1]), 7,
                             1.0 / STRIDES[lv])[0]
        np.testing.assert_allclose(got[i].numpy(), one.numpy(), atol=1e-5,
                                   rtol=0)


def test_roi_align_pyramid_batched_mixed_levels_matches_jax():
    """Batched form: every image holds RoIs of all four levels, some across
    the borders, so a wrong per-level or per-image row offset reads another
    level's or image's rows. Against JAX's batched form, and image by image
    against the unbatched call."""
    rng = np.random.default_rng(22)
    B, R = 3, 16
    feats = _pyramid(rng, C=8, B=B, hw=(40, 56))
    rois = _boxes(rng, (B, R), -20, 200)
    levels = np.tile(np.arange(4, dtype=np.int32), (B, R // 4))
    levels = np.stack([rng.permutation(row) for row in levels])
    want = np.asarray(jax_pyramid(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois),
        jnp.asarray(levels), 7, STRIDES))
    tf = [torch.from_numpy(f) for f in feats]
    got = tops.roi_align_pyramid(tf, torch.from_numpy(rois),
                                 torch.from_numpy(levels), 7, STRIDES)
    assert got.shape == want.shape == (B, R, 7, 7, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    for b in range(B):
        one = tops.roi_align_pyramid([f[b] for f in tf],
                                     torch.from_numpy(rois[b]),
                                     torch.from_numpy(levels[b]), 7, STRIDES)
        torch.testing.assert_close(got[b], one, atol=0, rtol=0)


def test_roi_align_pyramid_bf16_table_matches_jax():
    """A bf16 pyramid (the detector's dtype): both packages cast the
    interpolation weights to bf16 and combine there; held within 2^-6 of the
    output's range (bf16 sums in another order)."""
    rng = np.random.default_rng(23)
    B, R = 2, 12
    feats = _pyramid(rng, C=8, B=B, hw=(40, 56))
    rois = _boxes(rng, (B, R), 0, 180).astype(np.float32)
    levels = rng.integers(0, 4, (B, R)).astype(np.int32)
    want = np.asarray(jax_pyramid(
        [jnp.asarray(f, jnp.bfloat16) for f in feats], jnp.asarray(rois),
        jnp.asarray(levels), 7, STRIDES)).astype(np.float32)
    got = tops.roi_align_pyramid(
        [torch.from_numpy(f).bfloat16() for f in feats], torch.from_numpy(rois),
        torch.from_numpy(levels), 7, STRIDES)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -6 * np.ptp(want))


def _interior_scene(seed=9, B=3, C=8, R=40):
    """tests/test_nn.py:446's scene: boxes sized for their level (finest
    scale 56), their sample stencils strictly inside the level's extent."""
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(B, 200 // (2 ** l), 152 // (2 ** l), C)).astype(
        np.float32) for l in range(4)]
    scale = rng.uniform(40, 400, (B, R))
    lvl = np.clip(np.floor(np.log2(scale / 56 + 1e-6)), 0, 3).astype(np.int32)
    ar = rng.uniform(0.5, 2.0, (B, R))
    w, h = scale * np.sqrt(ar), scale / np.sqrt(ar)
    cx, cy = rng.uniform(100, 500, (B, R)), rng.uniform(100, 650, (B, R))
    stride_of = np.asarray(STRIDES)[lvl].astype(np.float64)
    lo = 0.6 * stride_of
    rois = np.stack(
        [np.clip(cx - w / 2, lo, None), np.clip(cy - h / 2, lo, None),
         np.clip(cx + w / 2, None, 608 - lo), np.clip(cy + h / 2, None, 800 - lo)],
        axis=-1)
    return feats, rois, lvl


def test_windowed_route_matches_the_gather_on_interior_boxes():
    """The port's windowed route (K2's, here its plain version) against the
    port's gather and JAX's, at JAX's bound for this comparison
    (tests/test_nn.py:485)."""
    feats, rois, lvl = _interior_scene()
    tf = [torch.from_numpy(f) for f in feats]
    tr, tl = torch.from_numpy(rois), torch.from_numpy(lvl)
    gather = tops.roi_align_pyramid(tf, tr, tl, 7, STRIDES)
    want = np.asarray(jax_pyramid(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), jnp.asarray(lvl),
        7, STRIDES))
    np.testing.assert_allclose(gather.numpy(), want, atol=1e-5, rtol=0)
    windowed = roi_align_windowed(tf, tr, tl, 7, STRIDES)
    np.testing.assert_allclose(windowed.numpy(), gather.numpy(), atol=2e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("box,level", [((40.0, 60.0, 460.0, 300.0), 1),
                                       ((100.0, 40.0, 900.0, 283.0), 2)],
                         ids=["level1-52px", "level2-50px"])
def test_windowed_route_wider_than_its_window_matches_jax(box, level):
    """An interior RoI wider than the 48-pixel window at its level: the
    windowed route clamps its stencil into the window, in the port as in
    both of the JAX package's windowed routes (the XLA slice and the Pallas
    kernel, interpret mode), so the three agree at the Pallas test's bound
    (tests/test_pallas_roialign.py) while all depart from the gather."""
    from macaque_tpu.nn.pallas_roialign import roi_align_windowed_fused
    from macaque_tpu_torch.nn.roialign import roi_window_buckets

    rng = np.random.default_rng(27)
    feats = [rng.normal(size=(1, 128 >> l, 256 >> l, 128)).astype(np.float32)
             for l in range(4)]
    rois = np.array([[box]], np.float32)
    lvl = np.array([[level]], np.int32)
    tf = [torch.from_numpy(f) for f in feats]
    tr, tl = torch.from_numpy(rois), torch.from_numpy(lvl)
    gy, gx, Hs, Ws = tops._roi_sample_grids(tf, tr, tl, 7, STRIDES, 2)
    assert (gy > 0).all() and (gy < Hs[..., None] - 1).all()
    assert (gx > 0).all() and (gx < Ws[..., None] - 1).all()
    # wider than the widest window: not even bucket 48 covers it
    assert roi_window_buckets(tf, tr, tl, 7, STRIDES, buckets=(48, 48)) == 1
    got = roi_align_windowed(tf, tr, tl, 7, STRIDES, window=48).numpy()
    jf, jr, jl = [jnp.asarray(f) for f in feats], jnp.asarray(rois), jnp.asarray(lvl)
    xla = np.asarray(jops.roi_align_windowed(jf, jr, jl, 7, STRIDES, window=48))
    fused = np.asarray(roi_align_windowed_fused(jf, jr, jl, 7, STRIDES,
                                                window=48, interpret=True))
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, fused, rtol=1e-5, atol=1e-5)
    gather = tops.roi_align_pyramid(tf, tr, tl, 7, STRIDES).numpy()
    assert np.abs(got - gather).max() > 0.1


# ---------------------------------------------------------- preprocessing

@pytest.mark.parametrize("hw,out_hw", [((1536, 2048), (600, 800)),
                                       ((37, 53), (20, 29)),
                                       ((21, 17), (45, 38))],
                         ids=["full", "odd-down", "odd-up"])
def test_resize_bilinear_matches_jax(hw, out_hw):
    """uint8 frames, cv2's half-pixel INTER_LINEAR, float32 on both sides
    (JAX with x64 off, as it runs in production: in x64 its sample
    coordinates are float64): within 1e-4 of a 0-255 range (3.1e-5, one
    float32 ulp at 255, measured)."""
    img = np.random.default_rng(24).integers(0, 256, hw + (3,)).astype(np.uint8)
    with jax.enable_x64(False):
        want = np.asarray(jpre.resize_bilinear(jnp.asarray(img), out_hw))
    got = tpre.resize_bilinear(torch.from_numpy(img), out_hw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("hw", [(1536, 2048), (301, 457)],
                         ids=["full", "odd"])
def test_detector_input_matches_jax_and_the_batch_form(hw):
    """The single-image detector input: scale, resized extent and the padded
    normalized tensor against JAX's (within 1e-5 of normalized values of
    magnitude up to 2.7; 8.3e-7 measured), and equal to
    ``detector_input_batch(img[None])``."""
    img = np.random.default_rng(25).integers(0, 256, hw + (3,)).astype(np.uint8)
    with jax.enable_x64(False):
        wp, ws, wr = jpre.detector_input(jnp.asarray(img))
    t = torch.from_numpy(img)
    gp, gs, gr = tpre.detector_input(t)
    assert (gs, gr) == (ws, wr) and gp.shape == wp.shape
    assert gp.shape[0] == 1 and gp.shape[1] % 32 == 0 == gp.shape[2] % 32
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), atol=1e-5, rtol=0)
    bp, bs, br = tpre.detector_input_batch(t[None])
    assert (bs, br) == (gs, gr) and torch.equal(bp, gp)


# ------------------------------------------------------------- flip test

def test_pose_forward_flip_matches_jax():
    """A small ViTPose with converted weights: the flip-test heatmaps against
    JAX's ``pose_forward_flip(apply_fn, params, ...)`` at the ViTPose parity
    bound (tests/test_torch_models.py), and equal to the perception's
    batched form of the same sum."""
    jm = jnn.ViTPose(jnn.VitPoseConfig(**VIT))
    x = np.random.default_rng(26).normal(size=(3, 64, 48, 3)).astype(
        np.float32)
    v = random_variables(jm, jnp.asarray(x), seed=26)
    want = np.asarray(jax.jit(lambda v, x: jhm.pose_forward_flip(
        jm.apply, v, x))(v, jnp.asarray(x)))
    tm = load(tnn.ViTPose(tnn.VitPoseConfig(**VIT), device="cpu"),
              vitpose_from_jax(v))
    t = torch.from_numpy(x)
    with torch.no_grad():
        got = thm.pose_forward_flip(tm, t)
        hm2 = tm(torch.cat([t, t.flip(2)]))
    assert got.shape == want.shape == (3, 16, 12, 17)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(
        got, 0.5 * (hm2[:3] + thm.flip_heatmaps(hm2[3:])), atol=1e-5, rtol=0)


# ------------------------------------------------------------------ native

def test_native_available_builds_and_loads(tmp_path, monkeypatch):
    from macaque_tpu_torch.native import build, native_available

    monkeypatch.setenv("MACAQUE_TPU_TORCH_BUILD", str(tmp_path))
    build.load_native.cache_clear()
    assert native_available() is True
    lib = build.library_path()
    assert os.path.dirname(lib) == str(tmp_path) and os.path.isfile(lib)
    build.load_native.cache_clear()


@pytest.mark.parametrize("how", ["raises", "compiler"])
def test_native_available_false_on_failure(tmp_path, monkeypatch, how):
    """False when ``load_native`` raises, made to, or because the compiler
    fails on a fresh build directory."""
    from macaque_tpu_torch.native import build, native_available

    if how == "raises":
        def broken(build_dir=None):
            raise OSError("cannot load")
        monkeypatch.setattr(build, "load_native", broken)
    else:
        monkeypatch.setenv("MACAQUE_TPU_TORCH_BUILD", str(tmp_path / "lib"))
        monkeypatch.setenv("PATH", str(tmp_path))
        (tmp_path / "g++").write_text("#!/bin/sh\nexit 1\n")
        (tmp_path / "g++").chmod(0o755)
        build.load_native.cache_clear()
    assert native_available() is False
