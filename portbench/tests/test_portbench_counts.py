"""The operation and byte counts against hand counts and against
``torch.utils.flop_counter`` on the reference networks at small shapes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench_tiny import tiny_cell
from portbench import files, peaks


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _total(ops):
    return sum(ops.values())


@pytest.fixture
def cfg():
    return tiny_cell("parity.occupied")["config"]


def test_detector_count(cfg):
    c = cfg["networks"]["detector"]
    arch = files.arch(c)
    hw = arch.input_hw([64, 96], c)
    det = arch.reference(c)
    x = torch.zeros(1, *hw, 3)
    R = c["rcnn_roi_topk"]

    def run():
        maps = det.maps(x)
        det.rpn_head(maps)
        det.roi_head.bbox_head(torch.zeros(R, 7, 7, c["fpn_channels"]))

    assert _total(files.load_module("counts/detector.py").ops(c, hw)) == _flops(run)


def test_detector_count_at_full_width():
    c = files.load_json("configs/parity.json")["networks"]["detector"]
    ops = files.load_module("counts/detector.py").ops(c, (608, 800))
    # Swin-S Mask R-CNN at 800x608 with 1000 RoIs: ~0.5 TFLOP in bf16
    assert 3e11 < ops["bf16"] < 8e11 and ops["f32"] < 1e-2 * ops["bf16"]


@pytest.mark.parametrize("int8", [False, True])
def test_pose_count(cfg, int8):
    c = dict(cfg["networks"]["pose"], int8_blocks=int8)
    vit = files.arch(c).reference(c)
    ops = files.load_module("counts/pose.py").ops(c)
    assert _total(ops) == _flops(lambda: vit(torch.zeros(1, *c["img_size"], 3)))
    assert (ops["int8"] > 0) == int8


def test_pose_count_at_full_width():
    c = files.load_json("configs/parity.json")["networks"]["pose"]
    ops = files.load_module("counts/pose.py").ops(c)
    # ViTPose-huge at 256x192: 632 M parameters over 192 tokens, ~0.25 TFLOP
    assert 2.3e11 < _total(ops) < 2.8e11


def test_classifier_count():
    c = {"arch_file": "archs/resnet_classifier.py", "depth": 50,
         "num_classes": 6, "crop": 64}
    net = files.arch(c).reference(c)
    ops = files.load_module("counts/classifier.py").ops(c)
    assert _total(ops) == _flops(lambda: net(torch.zeros(1, 64, 64, 3)))
    full = files.load_module("counts/classifier.py").ops(
        files.load_json("configs/parity.json")["networks"]["classifier"])
    # ResNet-152 at 224: 11.5 G multiply-adds
    assert 2.2e10 < _total(full) < 2.4e10


def test_k1_bound_by_hand():
    k1 = files.load_module("rooflines/k1.py")
    c = {"img_size": [32, 24], "patch_size": 8, "patch_padding": 2,
         "embed_dim": 32, "num_heads": 2, "depth": 2}
    # 2 crops, 12 tokens, width 32: qkv read and output written in bf16
    n_bytes = 2 * (2 * 12 * 96 + 2 * 12 * 32)
    n_ops = 4 * 2 * 2 * 12 * 12 * 16
    want = max(n_bytes / peaks.HBM_BYTES_PER_S, n_ops / peaks.BF16_FLOP_PER_S)
    assert k1.call_bound(c, 2)[0] == pytest.approx(want)
    assert k1.bound_s(c, [2, 2]) == pytest.approx(4 * want)
    full = files.load_json("configs/parity.json")["networks"]["pose"]
    t, by = k1.call_bound(full, 256)
    assert by == "bytes" and t * 1e3 == pytest.approx(0.15024, rel=1e-3)


def test_k5b_bound_by_hand():
    k5b = files.load_module("rooflines/k5b.py")
    M, K, N = 24, 32, 96
    n_bytes = M * K * 2 + N * K + N * 8 + M * N * 2
    want = max(n_bytes / peaks.HBM_BYTES_PER_S, 2 * M * N * K / peaks.INT8_OPS_PER_S)
    assert k5b.call_bound(M, K, N)[0] == pytest.approx(want)
    t, by = k5b.call_bound(49152, 5120, 1280)
    assert by == "operations" and t * 1e3 == pytest.approx(0.32554, rel=1e-3)


def test_least_seconds():
    assert peaks.least_seconds({"bf16": 989e12, "int8": 1979e12, "f32": 67e12}) \
        == pytest.approx(3.0)
