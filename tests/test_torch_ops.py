"""The port's detection ops, heatmap codec, preprocessing and host tracker
against the JAX package's, on the same numpy inputs."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from macaque_tpu.nn import heatmap as jhm
from macaque_tpu.nn import ops as jops
from macaque_tpu.nn import preprocess as jpre
from macaque_tpu.tracking import BotSortTracker as JTracker
from macaque_tpu_torch.nn import heatmap as thm
from macaque_tpu_torch.nn import ops as tops
from macaque_tpu_torch.nn import preprocess as tpre
from macaque_tpu_torch.tracking import BotSortTracker as TTracker


def _boxes(rng, n, lo=20, hi=400):
    ctr = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(10, 90, (n, 2))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], 1)


def test_anchors_equal_jax():
    sizes, strides = [(8, 6), (4, 3), (2, 2)], (4, 8, 16)
    for a, b in zip(tops.make_anchors(sizes, strides),
                    jops.make_anchors(sizes, strides)):
        np.testing.assert_array_equal(a, b)


def test_delta2bbox_and_iou_match_jax():
    rng = np.random.default_rng(0)
    anc = _boxes(rng, 40)
    d = rng.normal(0, 1.5, (40, 4))      # some dw/dh beyond the clip
    want = np.asarray(jops.delta2bbox(jnp.asarray(anc), jnp.asarray(d),
                                      stds=(0.1, 0.1, 0.2, 0.2),
                                      max_shape=(300, 350)))
    got = tops.delta2bbox(torch.from_numpy(anc), torch.from_numpy(d),
                          stds=(0.1, 0.1, 0.2, 0.2), max_shape=(300, 350))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(
        tops.bbox_iou(got, got).numpy(),
        np.asarray(jops.bbox_iou(jnp.asarray(want), jnp.asarray(want))),
        atol=1e-12)


@pytest.mark.parametrize("batched", [False, True])
def test_nms_matches_jax(batched):
    """Tie-free scores (the JAX package sorts unstably), some invalid
    entries at -inf; batched over images and levels as the RPN uses it."""
    rng = np.random.default_rng(1)
    B, N = 3, 60
    boxes = np.stack([_boxes(rng, N) for _ in range(B)])
    scores = rng.permutation(B * N).reshape(B, N) / (B * N) + 0.01
    scores[:, ::7] = -np.inf
    ids = rng.integers(0, 3, (B, N))
    for b in range(B):
        if batched:
            wk, wv = jops.batched_nms_fixed(
                jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                jnp.asarray(ids[b]), 0.5, 30)
        else:
            wk, wv = jops.nms_fixed(jnp.asarray(boxes[b]),
                                    jnp.asarray(scores[b]), 0.5, 30)
        want = np.asarray(wk)[np.asarray(wv)]
        if batched:
            gk, gv = tops.batched_nms_fixed(
                torch.from_numpy(boxes), torch.from_numpy(scores),
                torch.from_numpy(ids), 0.5, 30)
        else:
            gk, gv = tops.nms_fixed(torch.from_numpy(boxes),
                                    torch.from_numpy(scores), 0.5, 30)
        np.testing.assert_array_equal(gk[b][gv[b]].numpy(), want)


def _heatmaps(seed, B=3, H=64, W=48, K=17):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0:W]
    ctr = np.stack([rng.uniform(4, W - 4, (B, K)), rng.uniform(4, H - 4, (B, K))], -1)
    hm = np.exp(-((xs - ctr[..., 0, None, None]) ** 2
                  + (ys - ctr[..., 1, None, None]) ** 2) / 8.0)
    hm = hm + rng.uniform(0, 0.05, hm.shape)
    return np.moveaxis(hm, 1, -1).astype(np.float32)     # (B, H, W, K)


def test_udp_decode_matches_jax():
    hm = _heatmaps(2)
    wk, wv = jhm.udp_decode(jnp.asarray(hm), input_size=(192, 256))
    gk, gv = thm.udp_decode(torch.from_numpy(hm), input_size=(192, 256))
    # float32 blur and log on both sides; sub-pixel offsets agree to 1e-3 px
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=1e-3)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=0)


def test_blur_and_flip_match_jax():
    hm = _heatmaps(3)
    np.testing.assert_allclose(
        thm.gaussian_blur_heatmaps(torch.from_numpy(hm).movedim(-1, 1)).numpy(),
        np.asarray(jhm.gaussian_blur_heatmaps(jnp.asarray(np.moveaxis(hm, -1, 1)))),
        atol=1e-6)
    np.testing.assert_array_equal(
        thm.flip_heatmaps(torch.from_numpy(hm)).numpy(),
        np.asarray(jhm.flip_heatmaps(jnp.asarray(hm))))


def test_detector_input_matches_jax():
    imgs = np.random.default_rng(4).integers(0, 256, (2, 150, 200, 3)).astype(
        np.float32)
    wp, ws, wr = jpre.detector_input_batch(jnp.asarray(imgs), target=96)
    gp, gs, gr = tpre.detector_input_batch(torch.from_numpy(imgs), target=96)
    assert (gs, gr) == (ws, wr) and gp.shape == wp.shape
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), atol=1e-4)


def test_pose_and_id_crops_match_jax():
    """UDP pose crops and classifier crops of boxes partly off the image
    (border replication), and the crop -> image coordinate map."""
    rng = np.random.default_rng(5)
    B, D = 2, 3
    imgs = rng.integers(0, 256, (B, 90, 120, 3)).astype(np.float32)
    boxes = np.stack([_boxes(rng, D, -10, 120) for _ in range(B)])
    c_t, s_t = tpre.bbox_to_center_scale(torch.from_numpy(boxes))
    crops_t = tpre.udp_crop(torch.from_numpy(imgs), c_t.float(), s_t.float(),
                            out_hw=(32, 24))
    ids_t = tpre.id_crops(torch.from_numpy(imgs), torch.from_numpy(boxes),
                          out=28, resize_to=32)
    for b in range(B):
        c_j, s_j = jpre.bbox_to_center_scale(jnp.asarray(boxes[b]))
        np.testing.assert_allclose(c_t[b].numpy(), np.asarray(c_j), atol=1e-9)
        np.testing.assert_allclose(s_t[b].numpy(), np.asarray(s_j), atol=1e-9)
        want = jpre.udp_crop(jnp.asarray(imgs[b]), c_j.astype(jnp.float32),
                             s_j.astype(jnp.float32), out_hw=(32, 24))
        np.testing.assert_allclose(crops_t[b].numpy(), np.asarray(want),
                                   atol=2e-3)
        want = jpre.id_crops(jnp.asarray(imgs[b]), jnp.asarray(boxes[b]),
                             out=28, resize_to=32)
        np.testing.assert_allclose(ids_t[b].numpy(), np.asarray(want),
                                   atol=2e-3)
    kp = rng.uniform(0, 24, (D, 17, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tpre.crop_coords_to_image(torch.from_numpy(kp), c_t[0].float(),
                                  s_t[0].float(), out_hw=(32, 24)).numpy(),
        np.asarray(jpre.crop_coords_to_image(
            jnp.asarray(kp), jnp.asarray(c_t[0].numpy(), jnp.float32),
            jnp.asarray(s_t[0].numpy(), jnp.float32), out_hw=(32, 24))),
        atol=1e-4)
    np.testing.assert_allclose(tpre.normalize_rgb(torch.from_numpy(imgs)).numpy(),
                               np.asarray(jpre.normalize_rgb(jnp.asarray(imgs))),
                               atol=1e-6)


def test_host_tracker_equals_jax_package():
    """Four animals walking with detection noise, drop-outs and clutter:
    the copied host tracker gives the same tracks, frame by frame."""
    rng = np.random.default_rng(6)
    jt, tt = JTracker(), TTracker()
    pos = rng.uniform(100, 900, (4, 2))
    vel = rng.normal(0, 4, (4, 2))
    for _ in range(40):
        pos += vel
        boxes = np.concatenate([pos - 40, pos + 40], 1) + rng.normal(0, 2, (4, 4))
        scores = rng.uniform(0.6, 1.0, 4)
        keep = rng.uniform(size=4) > 0.15
        clutter = _boxes(rng, 1, 0, 1000)
        b = np.concatenate([boxes[keep], clutter])
        s = np.concatenate([scores[keep], rng.uniform(0.05, 0.9, 1)])
        (wb, wi), (gb, gi) = jt.update(b, s), tt.update(b, s)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gb, wb)
