"""The ``vitdet`` configuration and its cell ``vitdet.occupied``: the tiny
cell runs ``correct`` on the CPU, the detector's operation count against
the flop counter and at the published widths, K7's bound by hand and by
shape, and the metric sets of the cells the benchmark already had."""

import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench_tiny import tiny_cell
from portbench import files, harness, peaks

# the per-layer metrics of the cells before ``vitdet.occupied`` joined
BEFORE = {
    "perception.detect_ms_per_cf", "perception.pose_id_ms_per_cf",
    "loop.host_ms_per_cf", "networks.detector_device_ms_per_cf",
    "networks.pose_device_ms_per_cf", "kernels.k1_roofline",
    "device.idle_share", "device.peak_mem_gib", "perception_mfu",
    "perception.upload_ms_per_cf", "perception.upload_mib_per_cf",
    "perception.host_reads_per_cf", "networks.trunk_host_ms_per_cf",
    "networks.head_host_ms_per_cf"}
NEW = {"kernels.k7_roofline", "networks.relpos_attn_device_ms_per_cf",
       "networks.vit_host_ms_per_cf"}


def _names(cell):
    return {m["name"] for m in cell["per_layer"]}


def test_metric_sets_of_the_cells():
    spec = files.bench()
    assert _names(files.cell("parity.occupied", spec)) == BEFORE
    assert _names(files.cell("serving.occupied", spec)) == BEFORE | {"kernels.k5b_roofline"}
    assert _names(files.cell("vitdet.occupied", spec)) == BEFORE | NEW
    vit = files.cell("vitdet.occupied", spec)
    assert vit["workload"]["chips"] == 1
    assert [m["name"] for m in vit["end_to_end"]] == ["stage1_cf_s", "setup_s"]


def test_tiny_cell_is_correct_on_the_cpu():
    r, lines = harness.run_cell(tiny_cell("vitdet.occupied"), 2 ** 31 + 2731,
                                0.1, True, "cpu", time.perf_counter())
    assert r["correct"], lines
    assert r["attempted"] > 0 and r["failed"] == 0
    # on the CPU the device readers find nothing; the host span does
    assert "networks.vit_host_ms_per_cf" in r["metrics"]
    assert set(r["metrics"]) <= BEFORE | NEW


def _cfg():
    return files.load_json("configs/vitdet.json")["networks"]["detector"]


def test_detector_count_against_the_flop_counter():
    c = files.arch(_cfg()).tiny(_cfg())
    arch = files.arch(c)
    hw = arch.input_hw([64, 96], c)
    det = arch.reference(c)
    x = torch.zeros(1, *hw, 3)
    R = c["rcnn_roi_topk"]

    def run():
        maps = det.maps(x)
        det.rpn_head(maps)
        det.roi_head.bbox_head(torch.zeros(R, 7, 7, c["fpn_channels"]))

    with FlopCounterMode(display=False) as fc:
        run()
    ops = files.load_module("counts/vitdet_detector.py").ops(c, hw)
    assert sum(ops.values()) == fc.get_total_flops()


def test_detector_count_at_full_width():
    c = _cfg()
    ops = files.load_module("counts/vitdet_detector.py").ops(
        c, files.arch(c).input_hw([1536, 2048], c))
    # ViTDet-H at 1024x1024 with 1,000 RoIs: 6.6 TFLOP a frame, the
    # relative position factors and the heads' outputs in float32
    assert sum(ops.values()) == pytest.approx(6.6e12, abs=0.1e12)
    assert 1e10 < ops["f32"] < 1e-2 * ops["bf16"]


def test_k7_bound_by_hand_and_by_shape():
    k7 = files.load_module("rooflines/k7.py")
    # 3 sequences of a 2 x 2 grid, 2 heads of 8
    n_bytes = 2 * (3 * 4 * 48 + 3 * 4 * 16) + 4 * 2 * 3 * 2 * 4 * 2
    n_ops = 4 * 3 * 2 * 4 * 4 * 8
    want = max(n_bytes / peaks.HBM_BYTES_PER_S, n_ops / peaks.BF16_FLOP_PER_S)
    assert k7.call_bound(3, 2, 2, 8)[0] == pytest.approx(want)
    c = _cfg()
    calls = k7.block_calls(c, (1024, 1024))
    assert calls.count((1, 64)) == 4 and calls.count((25, 14)) == 28
    _, by_global = k7.call_bound(32, 64, 16, 80)
    _, by_window = k7.call_bound(32 * 25, 14, 16, 80)
    assert (by_global, by_window) == ("operations", "bytes")
    per_frame = sum(k7.call_bound(s, g, 16, 80)[0] for s, g in calls)
    assert k7.bound_s(c, (1024, 1024), [32, 32, 32]) == pytest.approx(96 * per_frame)
