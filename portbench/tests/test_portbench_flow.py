"""The harness end to end on the CPU at tiny widths, through the same
configuration, mix, limit and metric files as a run on the card."""

import time

import pytest
import torch

from portbench_tiny import tiny_cell
from portbench import check, harness


@pytest.mark.parametrize("name", ["parity.occupied", "serving.occupied",
                                  "parity.empty"])
def test_run_is_correct_and_complete(name):
    cell = tiny_cell(name)
    result, lines = harness.run_cell(cell, 2 ** 31 + 12345, 0.1, False, "cpu",
                                     time.perf_counter())
    assert result["attempted"] >= 4 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    assert list(result)[-1] == "checks"
    assert result["correct"], lines
    checked = {n for n, _, _ in lines}
    assert {"det_maps", "det_box_px", "rows"} <= checked
    assert ("pose_hm" in checked) == name.endswith("occupied")


def test_batched_trunk_and_split_pose_are_correct(monkeypatch):
    """The check reads the networks' outputs a frame and a crop at a time,
    however the program batches its calls: here the trunk runs once a chunk
    and the pose network in two calls, and the run is still correct."""
    from macaque_tpu_torch.pipeline import perception
    from macaque_tpu_torch.pipeline.perception import TorchPerception

    trunk_batches = []

    def batched(model, images, img_shape=None):
        trunk_batches.append(len(images))
        maps, rpn = model.trunk(images)
        return model.head(maps, rpn, img_shape)

    class Halves:
        def __init__(self, model):
            self.model, self.cfg = model, model.cfg

        def __call__(self, x):
            h = len(x) // 2
            return torch.cat([self.model(x[:h]), self.model(x[h:])])

    pose = TorchPerception._pose
    monkeypatch.setattr(perception, "detect_frames", batched)
    monkeypatch.setattr(TorchPerception, "_pose", lambda self, models, *a: pose(
        self, (models[0], Halves(models[1])) + tuple(models[2:]), *a))
    result, lines = harness.run_cell(tiny_cell("parity.occupied"), 2 ** 31 + 5,
                                     0.1, False, "cpu", time.perf_counter())
    assert max(trunk_batches) > 1
    assert result["correct"], lines


def test_traced_run_reports_the_host_metrics_and_a_breakdown():
    cell = tiny_cell("parity.occupied")
    result, _ = harness.run_cell(cell, 7, 0.1, True, "cpu", time.perf_counter())
    assert {"perception.detect_ms_per_cf", "perception.pose_id_ms_per_cf",
            "loop.host_ms_per_cf"} <= set(result["metrics"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0


def test_empty_mix_runs_no_pose():
    cell = tiny_cell("parity.empty")
    result, lines = harness.run_cell(cell, 3, 0.1, True, "cpu", time.perf_counter())
    assert "perception.pose_id_ms_per_cf" not in result["metrics"]
    assert not {"pose_hm", "id_prob"} & {n for n, _, _ in lines}


def test_judge_fails_a_number_without_a_limit():
    ok, lines = check.judge({"det_maps": 0.0, "rows": 0}, {})
    assert not ok and ("det_maps", 0.0, None) in lines
