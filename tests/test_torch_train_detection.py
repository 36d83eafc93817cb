"""The port's detection trainer (``macaque_tpu_torch/nn/train.py``, detection
half) and its random stream (``utils/threefry.py``: ``split``, ``uniform``,
``normal``) against the JAX package and ``jax.random``, on the CPU: the hand
cases of ``test_train_detection.py``, the sampler's masks bit for bit from
the same key, and one train step of that file's tiny detector with the
weights carried by ``swin_maskrcnn_from_jax``.

Tolerances (found values in brackets):
  * ``split`` and ``uniform`` (float32 and float64, any range) bit for bit;
    ``normal`` within 128 ulp in float32 [90] and 4096 ulp in float64
    [1958], with the median draw within 1 ulp: JAX's uniform draws are
    matched bit for bit, but XLA evaluates erfinv with its own polynomial,
    which drifts in the tails (|z| > 3.5; 5e-6 relative in float32,
    3e-13 in float64), while the port computes it in float64 and rounds once;
  * assignments and sampling masks equal; RPN/RoI losses on random inputs
    within 1e-6 relative (the same float64 targets, and the same masks);
  * one detection step: every loss term within 5e-6 relative [9e-7; with
    x64 on, the JAX package's ``bbox2delta`` computes the regression
    targets in float64, its stds being a float64 array], and the
    parameters within 1e-6 except where a gradient is below float noise:
    Adam's first step moves a parameter by lr times the sign of its
    gradient, so a gradient that is float noise on both sides takes +-lr on
    one side and -+lr on the other [1,089 of the 17.2 M parameters, most
    in the box head's first layer; 1.2e-4 at most]. At most 0.1% of the
    parameters may differ by more than 1e-6, and none by more than 2 lr."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from macaque_tpu import nn as jnn
from macaque_tpu.nn import train as jtrain
from macaque_tpu.nn.swin import SwinConfig as JSwinConfig
from macaque_tpu_torch import nn as tnn
from macaque_tpu_torch.nn import train as ttrain
from macaque_tpu_torch.nn.convert import swin_maskrcnn_from_jax
from macaque_tpu_torch.nn.ops import delta2bbox
from macaque_tpu_torch.nn.swin import SwinConfig as TSwinConfig
from macaque_tpu_torch.utils import threefry
from tests.torch_parity import random_variables

T = torch.as_tensor


# --------------------------------------------------------------- threefry

@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 + 5])
def test_split_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    for num in (2, 3, 8):
        np.testing.assert_array_equal(threefry.split(threefry.prng_key(seed),
                                                     num),
                                      np.asarray(jax.random.split(key, num)))
    sub = np.asarray(jax.random.split(key)[1])
    np.testing.assert_array_equal(
        threefry.split(threefry.split(threefry.prng_key(seed))[1], 4),
        np.asarray(jax.random.split(sub, 4)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_uniform_matches_jax_bit_for_bit(dtype):
    for seed in range(4):
        key, kk = jax.random.PRNGKey(seed), threefry.prng_key(seed)
        for lo, hi in ((0.0, 1.0), (-2.5, 7.0), (0.1, 0.3), (-1e3, 1e-3)):
            np.testing.assert_array_equal(
                threefry.uniform(kk, (3000,), dtype, lo, hi),
                np.asarray(jax.random.uniform(key, (3000,), dtype, lo, hi)))
        np.testing.assert_array_equal(
            threefry.uniform(kk, (7, 11), dtype),
            np.asarray(jax.random.uniform(key, (7, 11), dtype)))


@pytest.mark.parametrize("dtype,max_ulp", [(np.float32, 128),
                                           (np.float64, 4096)])
def test_normal_matches_jax_within_ulp(dtype, max_ulp):
    for seed in (0, 3):
        a = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (100000,),
                                         dtype))
        b = threefry.normal(threefry.prng_key(seed), (100000,), dtype)
        assert b.dtype == dtype
        ulp = np.abs(a - b) / np.spacing(np.abs(a).astype(dtype))
        assert ulp.max() <= max_ulp, ulp.max()
        assert np.median(ulp) <= 1


# ----------------------------------------------------- hand cases (JAX file)

def test_iou_matrix_oracle():
    a = T([[0.0, 0, 10, 10], [5, 5, 15, 15]])
    b = T([[0.0, 0, 10, 10], [10, 10, 20, 20]])
    np.testing.assert_allclose(ttrain.iou_matrix(a, b).numpy(),
                               [[1.0, 0.0], [25 / 175, 25 / 175]], atol=1e-6)


def test_bbox2delta_roundtrip_and_matches_jax():
    rng = np.random.default_rng(0)
    props = rng.uniform(0, 100, (20, 2))
    props = np.concatenate([props, props + rng.uniform(5, 60, (20, 2))], 1)
    gt = rng.uniform(0, 100, (20, 2))
    gt = np.concatenate([gt, gt + rng.uniform(5, 60, (20, 2))], 1)
    for stds in [(1.0, 1, 1, 1), (0.1, 0.1, 0.2, 0.2)]:
        deltas = ttrain.bbox2delta(T(props), T(gt), stds)
        np.testing.assert_allclose(
            deltas.numpy(), np.asarray(jtrain.bbox2delta(
                jnp.asarray(props), jnp.asarray(gt), stds)), rtol=1e-12)
        back = delta2bbox(T(props), deltas, stds=stds)
        np.testing.assert_allclose(back.numpy(), gt, atol=1e-3)


def test_max_iou_assign_hand_cases():
    gt = T([[0.0, 0, 10, 10], [20, 20, 30, 26]])
    boxes = T([[0.0, 0, 10, 10], [0.0, 0, 10, 5], [40.0, 40, 50, 50],
               [20.0, 20, 30, 30]])
    both = T([True, True])
    a = ttrain.max_iou_assign(boxes, gt, both, 0.7, 0.3, 0.3, True).tolist()
    assert a == [0, -2, -1, 1]          # box 3 rescued as gt 1's best
    a2 = ttrain.max_iou_assign(boxes, gt, both, 0.7, 0.3, 0.3, False)
    assert a2[3] == -2
    a3 = ttrain.max_iou_assign(boxes, gt, T([True, False]), 0.7, 0.3, 0.3, True)
    assert a3[3] == -1                  # gt 1 masked


def test_max_iou_assign_tie_later_gt_wins():
    gt = T([[0.0, 0, 10, 10], [0.0, 0, 10, 10]])
    a = ttrain.max_iou_assign(T([[0.0, 0, 10, 5]]), gt, T([True, True]),
                              0.7, 0.3, 0.3, True)
    assert a.tolist() == [1]


def test_max_iou_assign_matches_jax_on_random_boxes():
    rng = np.random.default_rng(5)
    for k in range(10):
        xy = rng.uniform(0, 80, (300, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(4, 40, (300, 2))], 1)
        boxes = np.round(boxes) if k % 2 else boxes    # integer ties
        gxy = rng.uniform(0, 80, (5, 2))
        gt = np.concatenate([gxy, gxy + rng.uniform(8, 40, (5, 2))], 1)
        gt = np.round(gt) if k % 2 else gt
        valid = rng.uniform(0, 1, 5) > 0.3
        for thr in ((0.7, 0.3, 0.3), (0.5, 0.5, 0.5)):
            for lq in (True, False):
                got = ttrain.max_iou_assign(T(boxes), T(gt), T(valid), *thr, lq)
                want = jtrain.max_iou_assign(jnp.asarray(boxes), jnp.asarray(gt),
                                             jnp.asarray(valid), *thr, lq)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_random_sample_masks_counts():
    key = threefry.prng_key(0)
    assigned = T([0] * 40 + [-1] * 500 + [-2] * 60)
    pos_s, neg_s, avg = ttrain.random_sample_masks(assigned, 256, 0.5, key)
    assert pos_s.sum() == 40 and neg_s.sum() == 216 and float(avg) == 256.0
    assert not (pos_s & neg_s).any()
    assert (assigned[pos_s] >= 0).all() and (assigned[neg_s] == -1).all()
    pos2, neg2, _ = ttrain.random_sample_masks(T([0] * 400 + [-1] * 400), 256,
                                               0.5, key)
    assert pos2.sum() == 128 and neg2.sum() == 128


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_random_sample_masks_bit_for_bit(seed):
    """The same key gives the JAX package's masks (its uniform is float64
    with x64 on, as in tier 1)."""
    rng = np.random.default_rng(seed)
    assigned = rng.choice([-2, -1, -1, -1, 0, 1, 2], 5000)
    for num, frac in ((256, 0.5), (512, 0.25), (64, 0.9)):
        key = jax.random.PRNGKey(seed + num)
        jp, jn, ja = jtrain.random_sample_masks(jnp.asarray(assigned), num,
                                                frac, key)
        tp, tn, ta = ttrain.random_sample_masks(
            T(assigned), num, frac, np.asarray(key), dtype=torch.float64)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        assert float(ta) == float(ja)


def test_rpn_roi_losses_zero_at_perfect_prediction():
    anchors = [np.array([[0.0, 0, 10, 10], [20, 20, 30, 30], [40, 40, 50, 50]],
                        np.float32)]
    gt, valid = T([[0.0, 0, 10, 10]]), T([True])
    key = threefry.prng_key(1)
    cls = T([50.0, -50.0, -50.0]).reshape(1, 1, 3)
    reg = torch.zeros((1, 1, 12))
    lc, lr = ttrain.rpn_loss([(cls, reg)], anchors, gt, valid, key)
    assert float(lc) < 1e-3 and float(lr) < 1e-6
    lc2, _ = ttrain.rpn_loss([(-cls, reg)], anchors, gt, valid, key)
    assert float(lc2) > 1.0
    props = T(anchors[0])
    assigned = ttrain.max_iou_assign(props, gt, valid, 0.5, 0.5, 0.5, True)
    logits = T([[50.0, -50], [-50, 50], [-50, 50]])
    lc3, lr3 = ttrain.roi_loss(logits, torch.zeros((3, 4)), props, assigned,
                               gt, key)
    assert float(lc3) < 1e-3 and float(lr3) < 1e-6


def test_rpn_and_roi_losses_match_jax():
    rng = np.random.default_rng(9)
    sizes = [(12, 12), (6, 6), (3, 3)]
    anchors = [a for a in __import__(
        "macaque_tpu_torch.nn.ops", fromlist=["make_anchors"]).make_anchors(
        sizes, (8, 16, 32))]
    outs = [(rng.normal(0, 2, (h, w, 3)).astype(np.float32),
             rng.normal(0, 0.3, (h, w, 12)).astype(np.float32))
            for h, w in sizes]
    gt = np.array([[10.0, 12, 50, 60], [60, 20, 90, 70], [0, 0, 1, 1]],
                  np.float32)
    valid = np.array([True, True, False])
    key = jax.random.PRNGKey(4)
    jl = jtrain.rpn_loss([(jnp.asarray(c), jnp.asarray(r)) for c, r in outs],
                         anchors, jnp.asarray(gt), jnp.asarray(valid), key)
    tl = ttrain.rpn_loss([(T(c), T(r)) for c, r in outs], anchors, T(gt),
                         T(valid), np.asarray(key), sample_dtype=torch.float64)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
        assert float(b) > 0

    xy = rng.uniform(0, 70, (200, 2))
    props = np.concatenate([xy, xy + rng.uniform(8, 40, (200, 2))], 1)
    props = np.concatenate([props, gt[:2]]).astype(np.float32)
    logits = rng.normal(0, 2, (202, 2)).astype(np.float32)
    reg = rng.normal(0, 0.3, (202, 4)).astype(np.float32)
    ja = jtrain.max_iou_assign(jnp.asarray(props), jnp.asarray(gt),
                               jnp.asarray(valid), 0.5, 0.5, 0.5, True)
    ta = ttrain.max_iou_assign(T(props), T(gt), T(valid), 0.5, 0.5, 0.5, True)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    jl = jtrain.roi_loss(jnp.asarray(logits), jnp.asarray(reg),
                         jnp.asarray(props), ja, jnp.asarray(gt), key)
    tl = ttrain.roi_loss(T(logits), T(reg), T(props), ta, T(gt),
                         np.asarray(key), sample_dtype=torch.float64)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
        assert float(b) > 0


# ------------------------------------------------------------- the step

SWIN = dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8))
DET = dict(rpn_nms_pre=64, rpn_max=64, rcnn_max=8)


def _batch(seed):
    """test_train_detection.py's synthetic single-box images."""
    r = np.random.default_rng(seed)
    imgs = np.full((2, 96, 96, 3), 0.1, np.float32)
    gts = np.zeros((2, 2, 4), np.float32)
    valid = np.zeros((2, 2), bool)
    for b in range(2):
        x, y = r.uniform(8, 48, 2)
        w, h = r.uniform(24, 40, 2)
        imgs[b, int(y):int(y + h), int(x):int(x + w)] = 1.0
        gts[b, 0] = [x, y, x + w, y + h]
        valid[b, 0] = True
    return imgs, gts, valid


def test_detection_decay_mask_matches_jax():
    jm = jnn.SwinMaskRCNN(jnn.DetectorConfig(swin=JSwinConfig(**SWIN), **DET))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 96, 96, 3)))
    keep = jax.tree_util.tree_map_with_path(
        lambda p, x: np.full(x.shape, float(p[-1].key not in (
            "bias", "scale", "rel_bias", "wscale")), np.float32),
        shapes["params"])
    want = swin_maskrcnn_from_jax({"params": keep})
    tm = tnn.SwinMaskRCNN(tnn.DetectorConfig(swin=TSwinConfig(**SWIN), **DET),
                          device="cpu")
    params = dict(tm.named_parameters())
    assert set(params) == set(want)
    for k, p in params.items():
        assert (not ttrain._no_decay(k, p)) == bool(want[k].flatten()[0]), k


def test_detection_train_step_matches_jax():
    torch.set_num_threads(4)
    jm = jnn.SwinMaskRCNN(jnn.DetectorConfig(swin=JSwinConfig(**SWIN), **DET))
    variables = random_variables(jm, jnp.zeros((1, 96, 96, 3)), seed=0)
    lr = 3e-4
    jopt = jtrain.make_detection_optimizer(variables["params"], lr=lr)
    jstep = jtrain.make_detection_train_step(jm, jopt, num_proposals=64)
    tm = tnn.SwinMaskRCNN(tnn.DetectorConfig(swin=TSwinConfig(**SWIN), **DET),
                          device="cpu")
    tm.load_state_dict(swin_maskrcnn_from_jax(variables))
    tp, _ = ttrain.train_state(tm)
    topt = ttrain.make_detection_optimizer(tp, lr=lr)
    tstep = ttrain.make_detection_train_step(tm, topt, num_proposals=64,
                                             sample_dtype=torch.float64)
    key = jax.random.split(jax.random.PRNGKey(2))[1]
    imgs, gts, valid = _batch(0)
    jp, jos, jm_ = jstep(variables["params"],
                         jopt.init(variables["params"]), key,
                         *map(jnp.asarray, (imgs, gts, valid)))
    tp, tos, tm_ = tstep(tp, topt.init(tp), np.asarray(key),
                         *map(torch.from_numpy, (imgs, gts, valid)))
    assert set(tm_) == set(jm_)
    for k in jm_:
        np.testing.assert_allclose(float(tm_[k]), float(jm_[k]), rtol=5e-6,
                                   err_msg=k)
        assert float(jm_[k]) > 0
    # Adam's first moment after one step is 0.1 x the clipped gradient:
    # each tensor's within 1e-4 of its largest entry (found <= 3e-5)
    want_mu = swin_maskrcnn_from_jax({"params": jos[1][0].mu})
    want = swin_maskrcnn_from_jax({"params": jp})
    mu = tos[1][0]["mu"]
    assert set(mu) == set(want_mu) == set(tp)
    for k, v in tp.items():
        g = torch.as_tensor(np.asarray(want_mu[k]))
        tol = 1e-4 * float(g.abs().max())
        assert float((mu[k] - g).abs().max()) <= tol, k
        # a first Adam step moves each entry by about lr times the sign of
        # its gradient: where the gradient is at float-noise level (within
        # the tolerance of zero) the sign may differ, elsewhere the
        # parameters agree within 1e-6
        d = (v - want[k]).abs()
        noise = g.abs() <= tol
        assert not (d[~noise] > 1e-6).any(), k
        assert float(d.max()) <= 2 * lr + 1e-6, k
