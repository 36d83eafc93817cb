"""The metrics that read the program's own spans and counters
(``macaque_tpu_torch/core/trace.py``), on the tiny cell on the CPU."""

import hashlib
import os
import time

import pytest

from portbench_tiny import tiny_cell
from portbench import files, harness

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)

NEW = ("perception.upload_ms_per_cf", "perception.upload_mib_per_cf",
       "perception.host_reads_per_cf", "networks.trunk_host_ms_per_cf",
       "networks.head_host_ms_per_cf")
# the benchmark's files (first 16 hex digits of each SHA-256), those before
# these metrics, which came as new files alone, and those added since,
# among them the architecture files (``archs/``). Only a change of the
# benchmark edits one of these files, and it updates the digest here.
BEFORE = {
    "__init__.py": "e3b0c44298fc1c14",
    "archs/resnet_classifier.py": "34ab8516f17e7654",
    "archs/swin_mask_rcnn.py": "7d338a2e63a3f9d0",
    "archs/vitpose.py": "c918a3e5e2756f61",
    "check.py": "d06fa598cf3a0ba1",
    "configs/parity.json": "2ddc336346d7a7e5",
    "configs/serving.json": "e1527d8b1d104b4d",
    "counts/classifier.py": "12413afcf3505f0d",
    "counts/detector.py": "e8356a9b8cb3fe5d",
    "counts/pose.py": "c981f141a53916ed",
    "devtrace.py": "db6359ab64e6dc86",
    "files.py": "7e72fa90dee71a47",
    "harness.py": "7d01321e44583ab4",
    "limits/parity.empty.json": "9caa21545fd905b0",
    "limits/parity.occupied.json": "f8179e0cb99da0a2",
    "limits/serving.occupied.json": "42ea83499d35c4c8",
    "metrics/device.idle_share.py": "ac96f7e8da7df1a4",
    "metrics/device.peak_mem_gib.py": "75bc141d0f465aa8",
    "metrics/kernels.k1_roofline.py": "d00de4d54aa8b708",
    "metrics/kernels.k5b_roofline.py": "1e5c6f56dfe922a8",
    "metrics/loop.host_ms_per_cf.py": "39652daec3b9a5e8",
    "metrics/networks.detector_device_ms_per_cf.py": "2ce68fbcc74a8b62",
    "metrics/networks.head_host_ms_per_cf.py": "deabf1e7f05dbe48",
    "metrics/networks.pose_device_ms_per_cf.py": "23b91ffb3f2a6897",
    "metrics/networks.trunk_host_ms_per_cf.py": "04c8fe5817a88573",
    "metrics/perception.detect_ms_per_cf.py": "ae7e1bfa75fbb073",
    "metrics/perception.host_reads_per_cf.py": "ef834285a763341c",
    "metrics/perception.pose_id_ms_per_cf.py": "435e62a1917bcaf8",
    "metrics/perception.upload_mib_per_cf.py": "4998a24b07cf63a2",
    "metrics/perception.upload_ms_per_cf.py": "a1e5cdfea782bb69",
    "metrics/perception_mfu.py": "434d3c1ee2d511cc",
    "metrics/setup_s.py": "8e970d9941721d5f",
    "metrics/stage1_cf_s.py": "538f9a1790664aef",
    "mixes/empty.json": "5aba68575391805d",
    "mixes/occupied.json": "e7f736624be8aac5",
    "peaks.py": "9bd61038c683b7e6",
    "readings.py": "dbdb309448a87744",
    "recorder.py": "29359fc17c4c57c8",
    "reference/__init__.py": "e3b0c44298fc1c14",
    "reference/detect.py": "0b2c4050ab189f49",
    "reference/lowp.py": "3c4d53a6539592a5",
    "reference/nets.py": "c2b99415d2337404",
    "reference/prep.py": "a639c98ef05adddb",
    "reference/track.py": "c01350cba27bfb7f",
    "rooflines/k1.py": "be3ea67338666b98",
    "rooflines/k5b.py": "1b9260f3b9e82e9b",
    "run.py": "b7b6f5293c627636",
    "tests/portbench_tiny.py": "6ce8768c2d270ae9",
    "tests/test_portbench_counts.py": "14a767627adddf70",
    "tests/test_portbench_discovery.py": "0c3b91b380f672ab",
    "tests/test_portbench_faults.py": "4b6addadfc824f7d",
    "tests/test_portbench_flow.py": "0a3ce49e5b71b015",
    "tests/test_portbench_modules.py": "f8e9bb2cf753b9e5",
    "tests/test_portbench_new_arch.py": "545999f8d0f229c7",
    "tests/test_portbench_nocard.py": "92c412a02dedf7ef",
    "tests/test_portbench_pins.py": "d027c05a62b3463f",
    "tests/test_portbench_reference.py": "699ff6f1740bff6c",
    "traffic.py": "16032ac6bc76e30c",
    "weights.py": "c153a583fd38b28d",
}


@pytest.fixture(scope="module", params=["parity.occupied", "serving.occupied"])
def traced(request):
    cell = tiny_cell(request.param)
    result, lines = harness.run_cell(cell, 2 ** 31 + 777, 0.1, True, "cpu",
                                     time.perf_counter())
    return cell, result, lines


def test_traced_run_reports_the_new_metrics_beside_the_others(traced):
    cell, result, lines = traced
    assert result["correct"], lines
    listed = {m["name"] for m in cell["per_layer"]}
    # the ten of before, less K5b's share in the parity cell
    old = 10 if cell["workload"]["name"] == "serving.occupied" else 9
    assert set(NEW) <= listed and len(listed) == len(NEW) + old
    assert {*NEW, "perception.detect_ms_per_cf", "perception.pose_id_ms_per_cf",
            "loop.host_ms_per_cf"} <= set(result["metrics"])
    m = result["metrics"]
    assert m["perception.host_reads_per_cf"]["unit"] == "reads/cf"
    assert 0 < m["networks.trunk_host_ms_per_cf"]["value"] \
        + m["networks.head_host_ms_per_cf"]["value"] \
        <= m["perception.detect_ms_per_cf"]["value"]


def test_upload_mib_is_the_frames_three_times_and_the_box_tables(traced):
    cell, result, _ = traced
    H, W = cell["mix"]["frame_hw"]
    D = cell["config"]["max_det"]
    per_cf = 3 * H * W * 3 + 2 * (D * 4 * 4 + D)
    assert result["metrics"]["perception.upload_mib_per_cf"]["value"] == \
        pytest.approx(per_cf / 2 ** 20, rel=1e-12)


class _Run:
    """What a reader sees of a run of a program without the new spans and
    counters: the five stage seconds of each segment alone."""

    frames = [None] * 96
    segments = [(0, 5.0, {"decode": 0.1, "detect": 3.0, "track": 0.1,
                          "pose+id": 1.5, "assemble": 0.1}, [])]


@pytest.mark.parametrize("name", NEW)
def test_reader_finds_nothing_in_a_program_without_the_spans(name):
    assert files.load_module(f"metrics/{name}.py").read(_Run(), None) is None


def test_the_benchmark_files_before_these_metrics_are_unchanged():
    for rel, digest in BEFORE.items():
        with open(os.path.join(PB, rel), "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest()[:16] == digest, rel
