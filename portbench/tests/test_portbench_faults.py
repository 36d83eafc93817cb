"""The output check catches a broken timed path: the rest of a run driven
on the CPU at tiny widths, past the look for a card, with one fault
planted underneath in the program, must come out not correct. And the
control, the reference one precision step lower in the program's place,
fails the cell's limits."""

import time

import numpy as np
import pytest
import torch

from portbench_tiny import tiny_cell
from portbench import check, harness
from portbench.readings import readings


def _correct(name="parity.occupied", max_det=None):
    cell = tiny_cell(name)
    if max_det:
        cell["config"]["max_det"] = max_det
    result, lines = harness.run_cell(cell, 2 ** 31 + 99, 0.1, False, "cpu",
                                     time.perf_counter())
    return result["correct"], {n: v for n, v, _ in lines}


def test_sound_run_is_correct():
    assert _correct()[0]


def test_an_altered_answer(monkeypatch):
    """A keypoint moved by a pixel where the perception produces it."""
    from macaque_tpu_torch.pipeline.perception import TorchPerception

    pose = TorchPerception.pose

    def altered(self, frames, boxes, valid):
        kps = pose(self, frames, boxes, valid)
        f, d = np.argwhere(np.asarray(valid))[0]
        kps[f, d, 0, 0] += 1.0
        return kps

    monkeypatch.setattr(TorchPerception, "pose", altered)
    ok, numbers = _correct()
    assert not ok and numbers["pose_kp_px"] >= 1.0


def test_half_the_batch_left_out(monkeypatch):
    """Detection run on half of each chunk, the rest filled with its mean."""
    from macaque_tpu_torch.pipeline.perception import TorchPerception

    detect = TorchPerception.detect

    def half(self, frames):
        h = max(len(frames) // 2, 1)
        boxes, scores = detect(self, frames[:h])
        fill = lambda a: np.concatenate(  # noqa: E731
            [a, np.repeat(a.mean(0, keepdims=True), len(frames) - h, 0)])
        return fill(boxes), fill(scores)

    monkeypatch.setattr(TorchPerception, "detect", half)
    assert not _correct()[0]


def test_detections_not_suppressed(monkeypatch):
    """The box head's NMS left out: the best-scored boxes kept, overlapping
    or not. With the full cell's 8 detections a frame, as the tiny cell's 2
    best boxes need not overlap."""
    from macaque_tpu_torch.nn import detector

    def no_nms(boxes, scores, iou_thr, max_out):
        top_s, top = torch.topk(scores, max_out, dim=-1)
        return top, top_s > -float("inf")

    assert _correct(max_det=8)[0]
    monkeypatch.setattr(detector, "nms_fixed", no_nms)
    ok, numbers = _correct(max_det=8)
    assert not ok and numbers["det_nms_iou"] > 0.5


def test_tracker_state_left_unchanged(monkeypatch):
    """A tracker whose update leaves its state as it was: no tracks."""
    from macaque_tpu_torch.tracking.botsort import BotSortTracker

    monkeypatch.setattr(BotSortTracker, "update",
                        lambda self, b, s: (np.zeros((0, 4)), np.zeros(0, int)))
    ok, numbers = _correct()
    assert not ok and numbers["rows"] > 0


@pytest.mark.parametrize("name", ["parity.occupied", "serving.occupied",
                                  "parity.empty"])
def test_control_fails_the_limits(name):
    cell = tiny_cell(name)
    lines = {(r["side"]): r["numbers"] for r in
             readings(cell, [21], {21}, 0.1, torch.device("cpu"))}
    assert check.judge(lines["program"] | {"rows": 0}, cell["limits"])[0]
    assert not check.judge(lines["control"], cell["limits"])[0]
