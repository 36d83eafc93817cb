"""Stage 1 at full width: the port's ``process_camera`` with
``TorchPerception`` against the JAX package's with ``FlaxPerception`` on a
one-camera store of two 2048x1536 frames, the three networks at the
widths the card runs (tests/fullwidth_cases.py: ViTPose-huge at depth 2,
Swin-S Mask R-CNN at depths (2, 2, 2, 2), ResNet-152 one block a stage),
each from one mm-keyed state dict loaded by both packages. The parity
tier (``DetectorConfig()``, the 800 target, the float pose with the flip
test) and the fast tier (``DetectorConfig.serving()``, the 640 target, the
int8 pose of ``quantize_vitpose_params`` / ``quantize_vitpose_``, one pose
pass). float32 on both sides, JAX with x64 off as it runs in production.

Held, with the worst difference measured here (in brackets):
- the frame numbers, the rows, their track ids and ID decisions: equal;
  the boxes (the tracker's integer boxes) within 1e-3 px [equal]; the ID
  scores within 1e-5 [8.9e-8];
- parity tier: the decoded heatmaps of the 16 pose slots within 2e-4
  [4.7e-5, of a 1.84 range]. That is 40 times the pose file's difference,
  because here each package cuts its crops in its own program: XLA fuses
  a crop's sample coordinate ``center - scale/2 + j * step`` into one
  multiply-add, which rounds once where eager code (the port, or the JAX
  function run op by op) rounds twice; one float32 ulp at 2,000 px is
  1.2e-4 px, which moves a sample on the texture's hard block edges by
  up to 0.018 grey levels. The same argmax for every joint, or where
  they differ two rival maxima within 2e-4 of each other [the same
  everywhere]; the keypoint scores within 1e-4 [1.6e-5] and the same
  joints below the keypoint threshold (NaN); each keypoint within
  4e-3 * (1 + |step|)^2 crop px, in image px through its crop's scale,
  where |step| is the larger DARK Newton step of its joint in heatmap px
  on the two sides (tests/test_torch_fullwidth_pose.py says why the
  decode amplifies noise so), the largest over the frames the track's
  smoothing mixed [largest d 0.244 of its bound];
- fast tier: upstream of the pose as the parity tier. The int8 pose's
  codes part by float32 noise and then cascade (the pose file counts
  them): its heatmaps are held to 2^-6 of their range [0.022, of a 2.82
  range: bound 0.044]. Where the two argmaxes differ (11 joints), each
  lies within that bound of the other map's maximum [0.0092]; the
  keypoint scores are held to it [0.0101], and a joint's NaN may differ
  only where its score lies within it of the threshold [none did]; the
  keypoints visible on both sides within 1.0 * (1 + |step|)^2 crop px
  where the argmaxes agree [largest d 0.339 of its bound], and they agree
  for at least 90 % of them [all 237].
"""

import json
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from macaque_tpu import nn as jnn
from macaque_tpu.core.config import Step1Config as JStep1Config
from macaque_tpu.nn import heatmap as jheatmap
from macaque_tpu.nn.quant import quantize_vitpose_params
from macaque_tpu.pipeline.perception import FlaxPerception
from macaque_tpu.pipeline.step1 import process_camera as jax_process_camera
from macaque_tpu.video.imgstore import ImgStoreReader as JReader
from macaque_tpu.video.imgstore import write_imgstore
from macaque_tpu_torch import nn as tnn
from macaque_tpu_torch.core.config import Step1Config
from macaque_tpu_torch.nn.preprocess import bbox_to_center_scale
from macaque_tpu_torch.nn.quant import quantize_vitpose_
from macaque_tpu_torch.pipeline import perception as tperception
from macaque_tpu_torch.pipeline.perception import TorchPerception
from macaque_tpu_torch.pipeline.step1 import process_camera
from macaque_tpu_torch.pipeline.weights import serving_tier
from macaque_tpu_torch.video.imgstore import ImgStoreReader
from tests import fullwidth_cases as fw
from tests.fullwidth_cases import tf32_off  # noqa: F401  (autouse)

# crop px, times (1 + |Newton step|)^2
KP_TOL, KP_TOL_INT8 = 4e-3, 1.0
HM_TOL = 2e-4           # the parity tier's heatmaps
POSE_HW = (256, 192)


@pytest.fixture(scope="module")
def nets():
    return fw.detector(), fw.vitpose(), fw.resnet()


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("fullwidth_step1")
    path = write_imgstore(str(root / "demo.cam0"), fw.synthetic_frames(2),
                          fourcc="FFV1")
    # a grid of the two frames' own times: a row for each frame
    T = np.asarray(JReader(path).get_frame_metadata()["frame_time"], float)
    return root, path, T


def _perceptions(nets, fast, jax_heatmaps):
    """Both packages' perceptions in one tier, on the same weights. The
    JAX package's pose program hands its heatmaps to ``jax_heatmaps``."""
    det, pose, idn = nets
    tier = serving_tier(fast=fast, int8=False, serving=False)
    jdcfg, tdcfg = fw.det_configs(serving=tier.serving)
    tdet = tnn.SwinMaskRCNN(tdcfg, device="cpu")
    tdet.load_state_dict(det.port.state_dict())
    jpcfg, tpcfg = fw.vit_configs()
    pose_vars, tpose = pose.jax_vars, pose.port
    if tier.int8:
        sd = {k: torch.from_numpy(v) for k, v in pose.state_dict.items()}
        jpcfg = fw.vit_configs(quantize="int8")[0]
        pose_vars = quantize_vitpose_params(pose.jax_vars)
        tpose = tnn.ViTPose(tpcfg, device="cpu")
        tpose.load_state_dict(sd)
        quantize_vitpose_(tpose, sd)
    real_decode = jheatmap.udp_decode

    def decode(hm, **kw):
        jax.debug.callback(lambda h: jax_heatmaps.append(np.asarray(h)), hm)
        return real_decode(hm, **kw)

    # FlaxPerception binds the decoder when it is built
    with mock.patch.object(jheatmap, "udp_decode", decode):
        flax = FlaxPerception(jnn.SwinMaskRCNN(jdcfg), det.jax_vars,
                              jnn.ViTPose(jpcfg), pose_vars, idn.jax_model,
                              idn.jax_vars, flip_test=tier.flip_test,
                              det_target=tier.det_target)
    port = TorchPerception(tdet, tpose, idn.port, det_target=tier.det_target,
                           device="cpu", flip_test=tier.flip_test)
    return tier, flax, port


def _run(nets, store, fast):
    """process_camera of both packages: their rows and frame numbers, the
    port's pose boxes and valid slots, and both packages' decoded
    heatmaps (B * D, 64, 48, 17)."""
    root, path, T = store
    hm_j, calls, hm_t = [], [], []
    tier, flax, port = _perceptions(nets, fast, hm_j)
    name = "fast" if fast else "parity"
    with jax.enable_x64(False):
        jax_process_camera(JReader(path), str(root / name / "jax"), T, flax,
                           JStep1Config(), chunk=2, prefetch=False)
    real_pose, real_decode = port.pose, tperception.udp_decode

    def pose(frames, boxes, valid):
        calls.append((np.asarray(boxes), np.asarray(valid)))
        return real_pose(frames, boxes, valid)

    def decode(hm, **kw):
        hm_t.append(hm.numpy().copy())
        return real_decode(hm, **kw)

    with mock.patch.object(port, "pose", pose), \
            mock.patch.object(tperception, "udp_decode", decode):
        process_camera(ImgStoreReader(path), str(root / name / "torch"), T,
                       port, Step1Config(), chunk=2, prefetch=False)
    out = {}
    for side in ("jax", "torch"):
        with open(root / name / side / "alldata.json") as f:
            out[side] = (json.load(f),
                         np.load(root / name / side / "frame_num.npy"))
    (boxes, valid), = calls
    return tier, out, boxes, valid, (hm_t[0], hm_j[0])


@pytest.fixture(scope="module")
def parity(nets, store):
    return _run(nets, store, fast=False)


@pytest.fixture(scope="module")
def fast(nets, store):
    return _run(nets, store, fast=True)


def _pairs(out):
    """The rows of both packages, entry by entry: (frame, entry, port entry,
    JAX entry), after the structure is held equal."""
    (rows_j, fn_j), (rows_t, fn_t) = out["jax"], out["torch"]
    np.testing.assert_array_equal(fn_t, fn_j)
    assert len(rows_t) == len(rows_j) == 2
    assert sum(len(r) for r in rows_j) > 0
    for f, (rt, rj) in enumerate(zip(rows_t, rows_j)):
        assert len(rt) == len(rj)
        for e, (et, ej) in enumerate(zip(rt, rj)):
            assert et[0] == ej[0] and et[6] == ej[6]        # track id, ID
            np.testing.assert_allclose(et[1:5], ej[1:5], rtol=0, atol=1e-3)
            np.testing.assert_allclose(et[7], ej[7], rtol=0, atol=1e-5)
            yield f, e, np.asarray(et[5], float), np.asarray(ej[5], float)


def _joints(boxes, valid, heatmaps, kp_tol):
    """Per valid slot and joint, from both packages' heatmaps: whether the
    argmax is the same, the heatmaps' difference at the two argmaxes, and
    the keypoint bound in image px, ``kp_tol * (1 + |step|)^2`` crop px
    with |step| the larger DARK Newton step of the two (inf where the
    argmaxes differ)."""
    B, D = valid.shape
    H, W, K = heatmaps[0].shape[1:]
    tops, steps, flats = [], [], []
    for hm in heatmaps:
        flat = hm.reshape(B, D, H * W, K)
        top = flat.argmax(2)
        kp = tperception.udp_decode(torch.from_numpy(np.array(hm)),
                                    input_size=(POSE_HW[1], POSE_HW[0]))[0]
        kp = kp.numpy().reshape(B, D, K, 2)
        steps.append(np.abs(kp / [(POSE_HW[1] - 1) / (W - 1),
                                  (POSE_HW[0] - 1) / (H - 1)]
                            - np.stack([top % W, top // W], -1)).max(-1))
        tops.append(top)
        flats.append(flat)
    same = tops[0] == tops[1]
    # each map's value at the other's argmax, below its own maximum
    gaps = [np.take_along_axis(fl, tops[1 - i][:, :, None], 2)[:, :, 0]
            for i, fl in enumerate(flats)]
    gaps = [fl.max(2) - g for fl, g in zip(flats, gaps)]
    _, scale = bbox_to_center_scale(torch.from_numpy(boxes),
                                    aspect=POSE_HW[1] / POSE_HW[0])
    px = (scale.numpy() / [POSE_HW[1] - 1, POSE_HW[0] - 1]).max(-1)
    bound = kp_tol * (1 + np.maximum(*steps)) ** 2 * px[..., None]
    bound = np.where(same, bound, np.inf)
    slot = {(f, e): k for f in range(B)
            for e, k in enumerate(np.where(valid[f])[0])}
    return same, np.maximum(*gaps), bound, slot


def _check_keypoints(rows_t, pairs, bound, slot):
    """Every visible keypoint of the rows within its joint's bound, the
    largest over the frames the track's smoothing mixed; returns the
    visible joints' d / bound."""
    seen, ratios = {}, []
    for f, e, kt, kj in pairs:
        tid = rows_t[f][e][0]
        b = np.maximum(seen.get(tid, 0.0), bound[f, slot[f, e]])
        seen[tid] = b
        vis = ~np.isnan(kt[:, 0])
        d = np.abs(kt[vis, :2] - kj[vis, :2]).max(-1)
        assert (d <= b[vis]).all(), (f, e, d, b[vis])
        ratios += list(d / b[vis])
    return np.asarray(ratios)


def test_parity_tier_rows_match_jax(parity):
    tier, out, boxes, valid, heatmaps = parity
    assert tier.flip_test and not tier.int8 and tier.det_target == 800
    hm_t, hm_j = heatmaps
    assert hm_t.shape == hm_j.shape == (16, 64, 48, 17)
    np.testing.assert_allclose(hm_t, hm_j, rtol=0, atol=HM_TOL)
    _, gap, bound, slot = _joints(boxes, valid, heatmaps, KP_TOL)
    # where the argmaxes differ, each is a rival maximum of the other map
    assert (gap[valid] <= HM_TOL).all()
    pairs = list(_pairs(out))
    for f, e, kt, kj in pairs:
        np.testing.assert_array_equal(np.isnan(kt), np.isnan(kj))
        np.testing.assert_allclose(kt[:, 2], kj[:, 2], rtol=0, atol=1e-4)
    ratios = _check_keypoints(out["torch"][0], pairs, bound, slot)
    assert len(ratios) > 0
    print(f"parity tier: largest keypoint d / bound {ratios.max():.3f} over "
          f"{len(ratios)} visible joints")


def test_fast_tier_rows_match_jax(fast):
    tier, out, boxes, valid, heatmaps = fast
    assert tier.int8 and tier.serving and not tier.flip_test
    assert tier.det_target == 640
    hm_t, hm_j = heatmaps
    assert hm_t.shape == hm_j.shape == (16, 64, 48, 17)
    tie = 2.0 ** -6 * np.ptp(hm_j)
    np.testing.assert_allclose(hm_t, hm_j, rtol=0, atol=tie)
    same, gap, bound, slot = _joints(boxes, valid, heatmaps, KP_TOL_INT8)
    # where the argmaxes differ, each is a rival maximum of the other map
    assert (gap[valid] <= tie).all()
    kp_thr = Step1Config().kp_thr
    pairs = list(_pairs(out))
    for f, e, kt, kj in pairs:
        np.testing.assert_allclose(kt[:, 2], kj[:, 2], rtol=0, atol=tie)
        differ = np.isnan(kt[:, 0]) != np.isnan(kj[:, 0])
        assert (np.abs(kj[differ, 2] - kp_thr) <= tie).all()
        # held below: the joints visible on both sides
        kt[differ, :2] = kj[differ, :2] = np.nan
    ratios = _check_keypoints(out["torch"][0], pairs, bound, slot)
    assert len(ratios) > 0 and np.isfinite(ratios).mean() >= 0.9
    print(f"fast tier: argmax differs at {(~same[valid]).sum()} joints; "
          f"largest keypoint d / bound {ratios[np.isfinite(ratios)].max():.3f}"
          f" over {len(ratios)} visible joints")
