"""The frozen reference against ``macaque_tpu_torch`` on the CPU at tiny
widths, both in float32 from the same seeded state dicts."""

import numpy as np
import pytest
import torch

from portbench_tiny import tiny_cell
from portbench import files, harness, traffic
from portbench.reference import lowp, prep
from portbench.weights import seeded_state


@pytest.fixture(scope="module")
def models():
    cell = tiny_cell("parity.occupied")
    perception, (det, pose, idm) = harness.build_program(
        cell["config"], cell["mix"], 11, torch.device("cpu"))
    n = cell["config"]["networks"]
    ref = {}
    for kind in ("detector", "pose", "classifier"):
        arch = files.arch(n[kind])
        sd = seeded_state(kind, n[kind], 11, "cpu")
        if kind == "detector":
            sd[arch.FG_BIAS][0] += cell["mix"]["fg_bias"]
        ref[kind] = arch.reference(n[kind])
        ref[kind].load_state_dict(sd)
    frames = traffic.frames(cell["mix"], 11, "cpu")
    return cell, (det, pose, idm), ref, frames


def _close(a, b, tol=1e-5):
    a, b = a.float(), b.float()
    assert (a - b).abs().max() <= tol * max((b.max() - b.min()).item(), 1.0)


def test_state_dicts_share_keys(models):
    _, (det, pose, idm), ref, _ = models
    for prog, r in zip((det, pose, idm), ref.values()):
        assert set(prog.state_dict()) == set(r.state_dict())


def test_detector(models):
    cell, (det, _, _), ref, frames = models
    from macaque_tpu_torch.nn.preprocess import detector_input_batch

    rgb = torch.from_numpy(np.ascontiguousarray(frames[..., ::-1]))
    x, scale = prep.detector_input(rgb, 96)
    xp, scale_p, _ = detector_input_batch(rgb.float(), target=96)
    _close(x, xp)
    assert scale == scale_p
    with torch.no_grad():
        maps, rpn = det.trunk(xp)
        for a, b in zip(ref["detector"].maps(x), maps):
            _close(a, b)
        for (a, b), (c, d) in zip(ref["detector"].rpn_head(maps), rpn):
            _close(a, c)
            _close(b, d)


def test_pose_and_decode(models):
    _, (_, pose, _), ref, frames = models
    from macaque_tpu_torch.nn import heatmap, preprocess

    rgb = torch.from_numpy(np.ascontiguousarray(frames[:2, ..., ::-1])).float()
    boxes = torch.tensor([[[10.0, 5.0, 40.0, 50.0]], [[30.0, 20.0, 80.0, 60.0]]])
    c, s = prep.center_scale(boxes, aspect=24 / 32)
    cp, sp = preprocess.bbox_to_center_scale(boxes, aspect=24 / 32)
    crops = prep.pose_crops(rgb, c, s, (32, 24)).reshape(2, 32, 24, 3)
    crops_p = preprocess.normalize_rgb(preprocess.udp_crop(
        rgb, cp, sp, out_hw=(32, 24))).reshape(2, 32, 24, 3)
    _close(crops, crops_p)
    with torch.no_grad():
        hm, hm_p = ref["pose"](crops), pose(crops_p)
    _close(hm, hm_p)
    kp, sc = prep.udp_decode(hm, input_size=(24, 32))
    kp_p, sc_p = heatmap.udp_decode(hm, input_size=(24, 32))
    _close(kp, kp_p)
    _close(sc, sc_p)
    _close(prep.flip_heatmaps(hm), heatmap.flip_heatmaps(hm))


def test_classifier_and_crops(models):
    _, (_, _, idm), ref, frames = models
    from macaque_tpu_torch.nn import preprocess

    rgb = torch.from_numpy(np.ascontiguousarray(frames[:1, ..., ::-1])).float()
    boxes = torch.tensor([[[10.0, 5.0, 40.0, 50.0], [0.0, 0.0, 90.0, 60.0]]])
    crops = prep.id_crops(rgb, boxes).reshape(2, 224, 224, 3)
    crops_p = preprocess.normalize_rgb(preprocess.id_crops(rgb, boxes)).reshape(
        2, 224, 224, 3)
    _close(crops, crops_p)
    with torch.no_grad():
        _close(ref["classifier"](crops), idm(crops_p))


def test_int8_emulation_matches_the_program_scheme():
    from macaque_tpu_torch.nn.quant import Int8Linear

    g = torch.Generator().manual_seed(0)
    lin = torch.nn.Linear(64, 48)
    x = torch.randn(5, 64, generator=g)
    prog = Int8Linear.from_weights(lin.weight, lin.bias)
    with torch.no_grad():
        _close(lowp.QuantLinear(lin, "int8")(x), prog(x), 1e-6)


def test_roi_align_follows_mmcv_at_the_border():
    """The reference RoIAlign against the program's windowed route in
    float32, on RoIs inside the window, some touching the map's edges,
    where mmcv clamps a sample's coordinate at 0."""
    from macaque_tpu_torch.nn.roialign import roi_align_windowed_reference

    from portbench.reference import detect

    g = torch.Generator().manual_seed(3)
    maps = [torch.randn(1, 40 // 2 ** l, 48 // 2 ** l, 8, generator=g)
            for l in range(4)]
    rois = torch.tensor([[0.0, 0.0, 30.0, 20.0], [0.0, 64.0, 40.0, 90.0],
                         [150.0, 100.0, 192.0, 160.0], [10.5, 3.2, 60.7, 44.1]])
    lvl = torch.tensor([0, 0, 1, 1])
    got = detect.roi_align([m[0] for m in maps], rois, lvl)
    want = roi_align_windowed_reference(maps, rois[None], lvl[None], 7,
                                        detect.STRIDES, window=16)[0]
    _close(got, want, 1e-6)
