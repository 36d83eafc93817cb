"""The port's ViTPose-huge and ResNet-152 against the JAX package's at full
width (``VitPoseConfig()`` at depth 2: 1280 wide, 16 heads of 80, MLP
5120, 256x192 crops, the deconvolution head; ResNet-152's four stages'
widths and its 6-class head, one block a stage), each from one mm-keyed
state dict loaded by both packages (tests/fullwidth_cases.py), on crops of
one 2048x1536 frame: four boxes, two of them crossing the frame's edges.
float32 on both sides, JAX with x64 off as it runs in production.

Held, with the worst difference measured here (in brackets):
- the pose crops and the ID crops each package cuts from the frame: within
  2e-4 [3.6e-7 and 2.4e-7; normalized pixels span about 4.5], and the
  crops' centers and scales within 1e-4 [equal]; the networks then take
  the JAX package's crops on both sides;
- (e) the flip-test heatmaps: within 1e-5 [1.1e-6, of a 1.65 range] and
  the keypoint scores within 1e-5 [6.6e-7], the same argmax for every
  joint. The decoded keypoints are held joint by joint to
  4e-4 * (1 + |step|)^2 crop px, where |step| is the JAX decode's DARK
  Newton step in heatmap px: the step divides by the blurred log-heatmap's
  Hessian determinant, which shrinks as the step grows, so float32 noise in
  the map moves the keypoint by about the noise times (1 + |step|)^2. On
  these random-weight maps 24 of 68 joints step more than one heatmap px,
  one of them 190 px, far outside its crop [largest d / (1 + |step|)^2:
  8.5e-5; where |step| <= 1, d <= 4.2e-5 crop px; the largest d 0.92 crop
  px at the 190 px step]. The same holds with both decoders on the JAX
  package's heatmaps (0.51 px there), so it is the algorithm's own
  amplification, not a departure. ``crop_coords_to_image`` on the same
  keypoints agrees within 1e-3 image px [equal];
- (f) the ResNet logits: within 1e-4 [4.6e-7, of a 4.1 range], the same
  labels;
- (g) the int8 pose: ``quantize_vitpose_`` on the float checkpoint gives
  the codes, scales and biases of ``quantize_vitpose_params`` bit for bit.
  Run op by op on the same crops and their mirrors, each int8 layer's
  activation codes are compared: the first layer's inputs differ by
  float32 noise only, so at most 1e-4 of its codes may differ [24 of
  1,966,080]. A flipped code moves its layer's output by one quantization
  step, which flips codes downstream (8.4 % of all codes by the last
  layer, 1280 wide; tests/test_torch_int8.py saw up to 1 % at width 64);
  the heatmaps are held to 2^-6 of their range [1.5e-2, 5.2e-3 of the
  2.9 range].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macaque_tpu import nn as jnn
from macaque_tpu.nn import heatmap as jheatmap
from macaque_tpu.nn import preprocess as jpre
from macaque_tpu.nn import quant as jquant
from macaque_tpu.nn.quant import quantize_vitpose_params
from macaque_tpu_torch import nn as tnn
from macaque_tpu_torch.nn import heatmap as theatmap
from macaque_tpu_torch.nn import preprocess as tpre
from macaque_tpu_torch.nn.convert import vitpose_from_jax
from macaque_tpu_torch.nn.quant import quantize_vitpose_
from tests import fullwidth_cases as fw
from tests.fullwidth_cases import tf32_off  # noqa: F401  (autouse)
from tests import test_torch_int8 as ti

BOXES = np.array([[612.0, 380.0, 1010.0, 905.0],
                  [1500.0, 1100.0, 2150.0, 1620.0],   # past right and bottom
                  [-80.0, 200.0, 300.0, 700.0],       # past the left edge
                  [900.0, 600.0, 1000.0, 1400.0]], np.float32)
POSE_HW = (256, 192)
CROP_TOL = 2e-4


@pytest.fixture(scope="module")
def frame():
    return fw.synthetic_frames(1)[..., ::-1].astype(np.float32)   # RGB


@pytest.fixture(scope="module")
def pose_crops(frame):
    """Each package's normalized pose crops (N, 256, 192, 3), centers and
    scales."""
    with jax.enable_x64(False):
        c, s = jpre.bbox_to_center_scale(jnp.asarray(BOXES), aspect=0.75)
        want = jpre.normalize_rgb(jpre.udp_crop(jnp.asarray(frame[0]), c, s,
                                                out_hw=POSE_HW))
        want = tuple(np.asarray(a) for a in (want, c, s))
    ct, st = tpre.bbox_to_center_scale(torch.from_numpy(BOXES[None]),
                                       aspect=0.75)
    got = tpre.normalize_rgb(tpre.udp_crop(torch.from_numpy(frame), ct, st,
                                           out_hw=POSE_HW))[0]
    return (got.numpy(), ct[0].numpy(), st[0].numpy()), want


def test_pose_crops_match_jax(pose_crops):
    (got, c, s), (want, cj, sj) = pose_crops
    assert got.shape == want.shape == (4, 256, 192, 3)
    np.testing.assert_allclose(c, cj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(s, sj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=0, atol=CROP_TOL)


@pytest.fixture(scope="module")
def pose():
    return fw.vitpose()


def _jax_flip_heatmaps(model, variables, crops):
    """FlaxPerception's flip test: the crops and their mirrors, averaged."""
    with jax.enable_x64(False):
        fn = jax.jit(lambda v, x: model.apply(v, x, train=False))
        x = jnp.asarray(crops)
        hm = 0.5 * (fn(variables, x) + jheatmap.flip_heatmaps(
            fn(variables, x[:, :, ::-1, :])))
        kp, sc = jheatmap.udp_decode(hm, input_size=(POSE_HW[1], POSE_HW[0]))
        return tuple(np.asarray(a) for a in (hm, kp, sc))


def _port_flip_heatmaps(model, crops):
    """TorchPerception's flip test: one batch of the crops and mirrors."""
    x = torch.from_numpy(np.array(crops))
    with torch.no_grad():
        hm2 = model(torch.cat([x, x.flip(2)]))
    n = len(crops)
    hm = 0.5 * (hm2[:n] + theatmap.flip_heatmaps(hm2[n:]))
    kp, sc = theatmap.udp_decode(hm, input_size=(POSE_HW[1], POSE_HW[0]))
    return tuple(a.numpy() for a in (hm, kp, sc))


KP_TOL = 4e-4       # crop px, times (1 + |Newton step|)^2


def test_vitpose_heatmaps_and_keypoints_match_jax(pose, pose_crops):
    _, (crops, c, s) = pose_crops
    hm_j, kp_j, sc_j = _jax_flip_heatmaps(pose.jax_model, pose.jax_vars, crops)
    hm, kp, sc = _port_flip_heatmaps(pose.port, crops)
    assert hm.shape == hm_j.shape == (4, 64, 48, 17)
    np.testing.assert_allclose(hm, hm_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(sc, sc_j, rtol=0, atol=1e-5)
    top = hm_j.reshape(4, -1, 17).argmax(1)
    np.testing.assert_array_equal(hm.reshape(4, -1, 17).argmax(1), top)
    # the DARK Newton step of each joint, in heatmap px
    step = kp_j / [(POSE_HW[1] - 1) / 47, (POSE_HW[0] - 1) / 63] \
        - np.stack([top % 48, top // 48], -1)
    step = np.abs(step).max(-1)
    assert (step > 1).any()             # ill-posed steps are exercised
    d = np.abs(kp - kp_j).max(-1)
    assert (d <= KP_TOL * (1 + step) ** 2).all(), (d, step)
    with jax.enable_x64(False):
        img_j = np.asarray(jpre.crop_coords_to_image(
            jnp.asarray(kp_j), jnp.asarray(c), jnp.asarray(s), out_hw=POSE_HW))
    img = tpre.crop_coords_to_image(torch.from_numpy(kp_j), torch.from_numpy(c),
                                    torch.from_numpy(s), out_hw=POSE_HW).numpy()
    np.testing.assert_allclose(img, img_j, rtol=0, atol=1e-3)


def test_resnet_logits_match_jax(frame):
    net = fw.resnet()
    with jax.enable_x64(False):
        want_crops = np.asarray(jpre.normalize_rgb(jpre.id_crops(
            jnp.asarray(frame[0]), jnp.asarray(BOXES))))
        want = np.asarray(jax.jit(lambda v, x: net.jax_model.apply(
            v, x, train=False))(net.jax_vars, jnp.asarray(want_crops)))
    crops = tpre.normalize_rgb(tpre.id_crops(torch.from_numpy(frame),
                                             torch.from_numpy(BOXES[None])))[0]
    assert crops.shape == want_crops.shape == (4, 224, 224, 3)
    np.testing.assert_allclose(crops.numpy(), want_crops, rtol=0,
                               atol=CROP_TOL)
    with torch.no_grad():
        got = net.port(torch.from_numpy(np.array(want_crops))).numpy()
    assert got.shape == want.shape == (4, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _int8_pose(pose):
    """The port's int8 ViTPose: a float32 model loaded from the checkpoint,
    then ``quantize_vitpose_`` with that checkpoint as the source."""
    sd = {k: torch.from_numpy(v) for k, v in pose.state_dict.items()}
    model = tnn.ViTPose(fw.vit_configs()[1], device="cpu")
    model.load_state_dict(sd)
    return quantize_vitpose_(model, sd)


def test_int8_pose_codes_match_jax(pose):
    qvars = quantize_vitpose_params(pose.jax_vars)
    want = vitpose_from_jax(qvars)
    model = _int8_pose(pose)
    layers = ti._int8_layers(model)
    assert len(layers) == 4 * fw.VIT_DEPTH
    assert model.cfg.quantize == "int8" and model.cfg._gelu_approx
    for name, m in layers.items():
        for buf in ("weight_q", "wscale", "bias"):
            torch.testing.assert_close(getattr(m, buf), want[f"{name}.{buf}"],
                                       rtol=0, atol=0)
    assert layers["backbone.layers.0.ffn.layers.0.0"].weight_q.shape == (
        5120, 1280)


def test_int8_pose_heatmaps_match_jax(monkeypatch, pose, pose_crops):
    _, (crops, _, _) = pose_crops
    x = np.concatenate([crops, crops[:, :, ::-1]])
    jm = jnn.ViTPose(fw.vit_configs(quantize="int8")[0])
    qvars = quantize_vitpose_params(pose.jax_vars)
    model = _int8_pose(pose)
    seen_jax, seen_port = [], []
    chain = jquant.int8_matmul

    def recording(x, kernel_q, wscale):
        seen_jax.append(np.asarray(x))
        return chain(x, kernel_q, wscale)

    monkeypatch.setattr(jquant, "int8_matmul", recording)
    with jax.enable_x64(False):
        want = np.asarray(jm.apply(qvars, jnp.asarray(x), train=False))
    for m in ti._int8_layers(model).values():
        m.register_forward_pre_hook(
            lambda mod, args: seen_port.append(args[0].clone()))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert len(seen_jax) == len(seen_port) == 4 * fw.VIT_DEPTH
    flips = [int((a != b).sum()) for a, b in
             zip(ti._codes(seen_jax), ti._codes(seen_port))]
    n0 = seen_port[0].numel()
    print(f"full-width int8 ViTPose: activation codes differing a layer "
          f"{flips}; max |d heatmap| {np.abs(got - want).max():.2e}")
    assert n0 == 8 * 192 * 1280 and flips[0] <= n0 // 10000
    assert got.shape == want.shape == (8, 64, 48, 17)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * np.ptp(want))
