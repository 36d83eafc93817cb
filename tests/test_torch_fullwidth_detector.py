"""The port's Swin-S Mask R-CNN against the JAX package's at full width
(``DetectorConfig()`` and ``DetectorConfig.serving()`` on Swin-S's widths
and heads, depths cut to (2, 2, 2, 2)), one mm-keyed state dict loaded by
both packages (tests/fullwidth_cases.py), on one 2048x1536 frame through
each package's own resize to the 800 target (a 608x800 input, so the
stage maps are 152x200 ... 19x25, padded to multiples of 7 and shifted
across several windows). float32 on both sides, JAX with x64 off as it
runs in production.

Held, with the worst difference measured here (in brackets):
- the detector input: within 1e-6 [3.6e-7];
- (a) the four Swin maps and the five FPN levels, and (b) the RPN
  objectness and deltas at every level: within 1.2e-5 of each map's
  largest magnitude [3.0e-6 of it, the objectness of level 2];
- (b) the proposals from the port's own RPN outputs: the same boxes in the
  same order within 1e-2 px [2.1e-3], except pairs of neighbours swapped
  by a near tie of their scores (4 pairs of 1,000 seen in the parity
  configuration, 1 pair of 512 in the serving one), each box then found at
  the next or previous rank;
- (c) the RoI head on the JAX package's proposals fed to both sides (the
  random-weight RPN scores them within about 1e-4 of each other, so a
  proposal set of each side's own would differ by near ties, not by a
  fault): the same proposals kept, every proposal's box within 1.5e-3 px
  [3.7e-4] and score within 5e-7 [1.2e-7];
- (d) ``detect_frames``'s detections on the same shared proposals: as many
  valid, matched one to one at boxes within 1.5e-3 px [3.1e-4] and scores
  within 5e-7 [1.2e-7] (every match at the same rank). A detection may go unmatched only at the
  ``rcnn_max`` cut (the frame's slots full), at most 2, each scoring within
  5e-7 of the other side's lowest kept score (none seen).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macaque_tpu.nn import detector as jdet
from macaque_tpu.nn.preprocess import detector_input_batch as jax_input_batch
from macaque_tpu_torch import nn as tnn
from macaque_tpu_torch.nn import detector as tdet
from macaque_tpu_torch.nn.preprocess import detector_input_batch
from tests import fullwidth_cases as fw
from tests.fullwidth_cases import tf32_off  # noqa: F401  (autouse)

MAP_TOL = 1.2e-5        # of each map's largest magnitude
BOX_TOL, SCORE_TOL = 1.5e-3, 5e-7
PROPOSAL_TOL = 1e-2


@pytest.fixture(scope="module")
def net():
    return fw.detector()


@pytest.fixture(scope="module")
def inputs():
    rgb = fw.synthetic_frames(1)[..., ::-1].astype(np.float32)
    with jax.enable_x64(False):
        xj, sj, hwj = jax_input_batch(jnp.asarray(rgb), target=800)
    xt, st, hwt = detector_input_batch(torch.from_numpy(rgb.copy()), target=800)
    return (np.asarray(xj), sj, hwj), (xt, st, hwt)


def test_detector_input_matches_jax(inputs):
    (xj, sj, hwj), (xt, st, hwt) = inputs
    assert xt.shape == xj.shape == (1, 608, 800, 3)
    assert (st, hwt) == (sj, hwj) == (0.390625, (600, 800))
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-6)


def _parts(m, x):
    maps = m.backbone(x)
    fpn = m.fpn(maps)
    return maps, fpn, m.rpn(fpn)


@pytest.fixture(scope="module")
def trunks(net, inputs):
    """(Swin maps, FPN levels, RPN outputs) of both packages, as numpy."""
    xj, xt = inputs[0][0], inputs[1][0]
    with jax.enable_x64(False):
        want = jax.jit(lambda v, x: net.jax_model.apply(v, x, method=_parts))(
            net.jax_vars, jnp.asarray(xj))
    with torch.no_grad():
        maps = net.port.backbone(xt)
        fpn = net.port.neck(maps)
        got = maps, fpn, net.port.rpn_head(fpn)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return to_np(got), to_np(want)


def _assert_maps(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i)
        scale = np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= MAP_TOL * scale, (what, i, err, scale)


def test_swin_maps_and_fpn_levels_match_jax(trunks):
    (maps, fpn, _), (maps_j, fpn_j, _) = trunks
    assert [m.shape[1:] for m in maps] == [
        (152, 200, 96), (76, 100, 192), (38, 50, 384), (19, 25, 768)]
    _assert_maps(maps, maps_j, "swin")
    assert [f.shape[1:3] for f in fpn] == [
        (152, 200), (76, 100), (38, 50), (19, 25), (10, 13)]
    _assert_maps(fpn, fpn_j, "fpn")


def test_rpn_outputs_match_jax(trunks):
    (*_, rpn), (*_, rpn_j) = trunks
    _assert_maps([c for c, _ in rpn], [c for c, _ in rpn_j], "objectness")
    _assert_maps([r for _, r in rpn], [r for _, r in rpn_j], "deltas")


@pytest.fixture(scope="module", params=["parity", "serving"])
def heads(request, net, inputs):
    """``detect_frames`` of both packages on one configuration. The JAX
    package's proposals and the boxes and scores into its final NMS are
    read out of its program; the port runs once on its own proposals and
    once on the JAX package's, recording the RoI head's input order and
    the boxes and scores into its final NMS."""
    jcfg, tcfg = fw.det_configs(serving=request.param == "serving")
    jm = jdet.SwinMaskRCNN(jcfg)
    tm = tnn.SwinMaskRCNN(tcfg, device="cpu")
    tm.load_state_dict(net.port.state_dict())
    xj, xt = inputs[0][0], inputs[1][0]
    rec = {"props": [], "pre": []}
    real_bnms, real_nms = jdet.batched_nms_fixed, jdet.nms_fixed

    def record(key):
        return lambda *a: rec[key].append(tuple(np.asarray(x) for x in a))

    def bnms(boxes, scores, ids, thr, n):
        keep, valid = real_bnms(boxes, scores, ids, thr, n)
        jax.debug.callback(record("props"), boxes[keep], valid)
        return keep, valid

    def nms(boxes, scores, thr, n):
        jax.debug.callback(record("pre"), boxes, scores)
        return real_nms(boxes, scores, thr, n)

    with jax.enable_x64(False), mock.patch.object(jdet, "batched_nms_fixed",
                                                  bnms), \
            mock.patch.object(jdet, "nms_fixed", nms):
        want = jax.jit(lambda v, x: jdet.detect_frames(jm, v, x))(
            net.jax_vars, jnp.asarray(xj))
        want = tuple(np.asarray(t) for t in want)
    (jprops, jvalid), = rec["props"]
    (jpre_b, jpre_s), = rec["pre"]

    own, roi, pre = [], [], []
    real_proposals, real_roi, real_tnms = (
        tm._proposals, tm._roi_features, tdet.nms_fixed)

    def proposals(*a):
        own.append(tuple(t.numpy() for t in real_proposals(*a)))
        return tuple(torch.from_numpy(t) for t in own[-1])

    def roi_features(feats, props, lvl, valid):
        out = real_roi(feats, props, lvl, valid)
        roi.append((props[0].numpy(), out[0][0].numpy()))
        return out

    def tnms(boxes, scores, *a):
        pre.append((boxes[0].numpy().copy(), scores[0].numpy().copy()))
        return real_tnms(boxes, scores, *a)

    with torch.no_grad():
        with mock.patch.object(tm, "_proposals", proposals):
            tdet.detect_frames(tm, xt)
        shared = (torch.from_numpy(np.array(jprops[None])),
                  torch.from_numpy(np.array(jvalid[None])))
        with mock.patch.object(tm, "_proposals", lambda *a: shared), \
                mock.patch.object(tm, "_roi_features", roi_features), \
                mock.patch.object(tdet, "nms_fixed", tnms):
            got = tuple(t.numpy() for t in tdet.detect_frames(tm, xt))
    return dict(cfg=tcfg, jprops=(jprops, jvalid), own=own[0],
                jpre=(jpre_b, jpre_s), roi_order=roi[0], pre=pre[0],
                got=got, want=want)


def test_rpn_proposals_match_jax(heads):
    """The port's own proposals: the JAX package's boxes rank by rank,
    but where a near tie of two neighbours' scores swapped them."""
    jprops, jvalid = heads["jprops"]
    props, valid = (a[0] for a in heads["own"])
    n = heads["cfg"].rpn_max
    assert props.shape == jprops.shape == (n, 4)
    np.testing.assert_array_equal(valid, jvalid)
    assert valid.sum() > n // 2
    d = np.abs(props - jprops).max(-1)
    for i in np.where(valid & (d > PROPOSAL_TOL))[0]:
        near = [j for j in (i - 1, i + 1) if 0 <= j < n
                and np.abs(props[j] - jprops[i]).max() <= PROPOSAL_TOL]
        assert near, (i, props[i], jprops[i])


def _rank_map(src, dst):
    """``dst`` rows are a permutation of ``src`` rows: the src index of each
    dst row."""
    key = lambda a: np.lexsort(a.T[::-1])  # noqa: E731
    ks, kd = key(src), key(dst)
    np.testing.assert_array_equal(src[ks], dst[kd])
    out = np.empty(len(dst), int)
    out[kd] = ks
    return out


def test_roi_head_on_shared_proposals_matches_jax(heads):
    """Every proposal's box and score into the final NMS (-inf where a
    proposal is dropped). The port aligns its RoIs in window-bucket order
    (the JAX package's XLA path keeps the RPN order): rows are matched
    through that reorder."""
    jpre_b, jpre_s = heads["jpre"]
    pre_b, pre_s = heads["pre"]
    src, dst = heads["roi_order"]
    cfg = heads["cfg"]
    assert len(src) == min(cfg.rcnn_roi_topk, cfg.rpn_max)
    idx = _rank_map(src, dst)
    assert (idx != np.arange(len(idx))).any()      # the chunked path ran
    jb, js = jpre_b[idx], jpre_s[idx]
    keep = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(pre_s), keep)
    assert keep.sum() > len(keep) // 2
    np.testing.assert_allclose(pre_b[keep], jb[keep], rtol=0, atol=BOX_TOL)
    np.testing.assert_allclose(pre_s[keep], js[keep], rtol=0, atol=SCORE_TOL)


def test_detect_frames_matches_jax(heads):
    (b, s, v), (bj, sj, vj) = heads["got"], heads["want"]
    rcnn_max = heads["cfg"].rcnn_max
    assert b.shape == bj.shape == (1, rcnn_max, 4)
    for f in range(len(v)):
        assert v[f].sum() == vj[f].sum() > 0
        a, sa = b[f][v[f]], s[f][v[f]]
        r, sr = bj[f][vj[f]], sj[f][vj[f]]
        free = np.ones(len(r), bool)
        lone = []
        for i in range(len(a)):
            ok = free & (np.abs(r - a[i]).max(-1) <= BOX_TOL) \
                & (np.abs(sr - sa[i]) <= SCORE_TOL)
            if not ok.any():
                lone.append(i)
                continue
            free[np.argmax(ok)] = False
        lone_j = np.where(free)[0]
        assert len(lone) == len(lone_j)
        if lone:
            # a swap at the rcnn_max cut: each unmatched detection scores at
            # the other side's lowest kept score
            assert v[f].all() and len(lone) <= 2, (f, sa[lone], sr[lone_j])
            assert np.abs(sa[lone] - sr.min()).max() <= SCORE_TOL
            assert np.abs(sr[lone_j] - sa.min()).max() <= SCORE_TOL
