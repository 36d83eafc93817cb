"""The port's tracer (``macaque_tpu_torch/core/trace.py``): spans, counters
and records, the spans and counters at stage 1's work sites, and
``torch_profile``'s trace and idle table. The ``StageTimes`` and
``torch_profile`` tests against the JAX package are in
tests/test_torch_runner.py."""

import json
import threading
from contextlib import nullcontext
import time
import tracemalloc

import numpy as np
import pytest
import torch

from macaque_tpu_torch import kernels
from macaque_tpu_torch.core import trace
from macaque_tpu_torch.core.trace import (
    StageTimes, count, idle_by_span, record, span, torch_profile)
from macaque_tpu_torch.nn.ops import nms_fixed
from macaque_tpu_torch.pipeline.step1 import STAGES, process_camera

B, D, H, W = 4, 2, 64, 96           # chunk, max_det, frame size


class Store:
    """Frames in memory, read as ``process_camera`` reads an imgstore."""

    def __init__(self, frames):
        self.frames = frames
        self.fnums = np.arange(len(frames))
        self.ftimes = self.fnums / 24.0

    def get_frame_metadata(self):
        return {"frame_number": self.fnums.copy(),
                "frame_time": self.ftimes.copy()}

    def get_image(self, frame_index):
        return self.frames[frame_index], None


class Timed:
    """The perception, each call timed on the tracer's clock from outside."""

    def __init__(self, inner):
        self.inner, self.max_det, self.device = inner, inner.max_det, inner.device
        self.seconds = {"detect": 0.0, "pose": 0.0, "classify": 0.0}

    def _timed(self, name, *args):
        t = time.time_ns()
        out = getattr(self.inner, name)(*args)
        self.seconds[name] += (time.time_ns() - t) * 1e-9
        return out

    def detect(self, frames):
        return self._timed("detect", frames)

    def pose(self, *args):
        return self._timed("pose", *args)

    def classify(self, *args):
        return self._timed("classify", *args)


def _perception():
    """A small-width TorchPerception on the CPU, weights from seed 0, the
    box head's foreground bias raised so that every frame has boxes."""
    from dataclasses import dataclass

    from macaque_tpu_torch.nn import (
        DetectorConfig, ResNetClassifier, ResNetConfig, SwinMaskRCNN,
        ViTPose, VitPoseConfig)
    from macaque_tpu_torch.nn.swin import SwinConfig
    from macaque_tpu_torch.pipeline.perception import TorchPerception

    @dataclass(frozen=True)
    class TinyResNet(ResNetConfig):
        @property
        def stage_blocks(self):
            return (1, 1)

    torch.manual_seed(0)
    det = SwinMaskRCNN(DetectorConfig(
        swin=SwinConfig(embed_dim=8, depths=(2, 2, 2, 2), num_heads=(1, 1, 2, 2)),
        fpn_channels=16, rpn_nms_pre=100, rpn_max=40, rcnn_max=10,
        rcnn_roi_topk=40, rcnn_roi_chunk=16), device="cpu")
    with torch.no_grad():
        det.roi_head.bbox_head.fc_cls.bias[0] += 6.0
    pose = ViTPose(VitPoseConfig(img_size=(32, 24), patch_size=8, embed_dim=32,
                                 depth=1, num_heads=2, deconv_channels=(8, 8)),
                   device="cpu")
    idm = ResNetClassifier(TinyResNet(), device="cpu")
    return TorchPerception(det, pose, idm, max_det=D, det_target=96,
                           device="cpu")


@pytest.fixture(scope="module")
def camera(tmp_path_factory):
    """One camera of 8 frames in chunks of 4 through ``process_camera``:
    (its record, the perception's calls timed from outside)."""
    frames = np.random.default_rng(0).integers(0, 256, (2 * B, H, W, 3),
                                               dtype=np.uint8)
    store = Store(frames)
    perception = Timed(_perception())
    rec = process_camera(store, str(tmp_path_factory.mktemp("cam")),
                         store.ftimes, perception, chunk=B, redo=True,
                         prefetch=False)
    return rec, perception


def test_process_camera_returns_the_stage_keys_and_the_new_ones(camera):
    rec, perception = camera
    assert set(STAGES) == {"decode", "detect", "track", "pose+id", "assemble"}
    assert set(STAGES) <= set(rec)
    assert {"perception.upload", "perception.upload_bytes", "perception.gather",
            "detector.input", "detector.trunk", "detector.head",
            "detector.proposals", "detector.roi", "detector.box_head",
            "host_reads.nms", "host_reads.roi_buckets", "host_reads.gather",
            "detect/detector.trunk", "pose+id/perception.upload"} <= set(rec)
    assert all(isinstance(v, (int, float)) and v >= 0 for v in rec.values())
    # the stage keys keep their meaning: each holds the calls made in it
    # (the slack is the loop's own work between the span's edges and the
    # call's, a few microseconds, and the scheduler of a loaded host)
    s = perception.seconds
    assert s["detect"] <= rec["detect"] <= 1.1 * s["detect"] + 0.05
    pose_id = s["pose"] + s["classify"]
    assert 0 < pose_id <= rec["pose+id"] <= 1.1 * pose_id + 0.05


def test_spans_nested_in_a_span_sum_to_no_more_than_it(camera):
    rec, _ = camera
    parents = {k.split("/")[0] for k in rec if "/" in k}
    assert {"detect", "pose+id", "detector.head"} <= parents
    for p in parents:
        inside = sum(v for k, v in rec.items() if k.startswith(p + "/"))
        assert inside <= rec[p] + 1e-9, p
    assert {k for k in rec if k.startswith("detect/")} == {
        "detect/perception.upload", "detect/detector.input",
        "detect/detector.trunk", "detect/detector.head",
        "detect/perception.gather"}
    assert rec["detector.head"] == pytest.approx(rec["detect/detector.head"])


def test_upload_bytes_are_the_frames_three_times_and_the_box_tables(camera):
    rec, perception = camera
    chunks = 2
    frames = B * H * W * 3
    boxes = B * D * 4 * 4 + B * D           # float32 boxes, bool validity
    assert rec["perception.upload_bytes"] == chunks * (3 * frames + 2 * boxes)
    # one read a returned tensor: detect 2, pose 1, classify 2
    assert rec["host_reads.gather"] == chunks * 5
    # one waiting copy an array placed: the frames 3, boxes 2, validity 2
    assert rec["host_reads.upload"] == chunks * 7
    assert rec["host_reads.roi_buckets"] == chunks
    assert rec["host_reads.anchors"] == chunks * 5      # one an FPN level


@pytest.mark.parametrize("chunks", [1, 2])
def test_the_trunk_runs_once_a_chunk_inside_detect(camera, tmp_path, chunks):
    """A chunk of B frames makes one trunk call, counted as
    ``detector.trunk_calls``, and the trunk's span stays inside ``detect``."""
    if chunks == 2:
        rec, _ = camera
    else:
        frames = np.random.default_rng(1).integers(0, 256, (B, H, W, 3),
                                                   dtype=np.uint8)
        store = Store(frames)
        rec = process_camera(store, str(tmp_path), store.ftimes, _perception(),
                             chunk=B, redo=True, prefetch=False)
    assert rec["detector.trunk_calls"] == chunks
    assert rec["detect/detector.trunk"] == pytest.approx(rec["detector.trunk"])
    assert 0 < rec["detector.trunk"] <= rec["detect"]


def _chain(n, step=0.52, w=10.0):
    """n boxes in a row, each overlapping the next (IoU 0.316) and no other,
    scores falling along the row."""
    x = np.arange(n) * step * w
    boxes = np.stack([x, np.zeros(n), x + w, np.full(n, w)], -1)
    return (torch.tensor(boxes, dtype=torch.float32),
            torch.linspace(1.0, 0.5, n))


def _sweeps(boxes, thr):
    """The fixed-point sweeps of the greedy recurrence, counted in numpy."""
    b = boxes.numpy().astype(np.float64)
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt, rb = np.maximum(b[:, None, :2], b[None, :, :2]), np.minimum(
        b[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), -1)
    sup = np.tril(inter / (area[:, None] + area[None] - inter) > thr, -1)
    alive, n = np.ones(len(b), bool), 0
    while True:
        n += 1
        new = ~(sup & alive[None]).any(1)
        if (new == alive).all():
            return n, alive
        alive = new


def test_host_reads_nms_counts_the_sweeps_of_a_suppression_chain():
    boxes, scores = _chain(9)
    expect, alive = _sweeps(boxes, 0.3)
    assert expect >= 8 and alive.tolist() == [i % 2 == 0 for i in range(9)]
    with record() as rec:
        keep, valid = nms_fixed(boxes, scores, 0.3, 9)
    assert rec == {"host_reads.nms": expect}
    assert sorted(keep[valid].tolist()) == [0, 2, 4, 6, 8]


def test_records_of_two_threads_do_not_mix():
    barrier = threading.Barrier(2, timeout=10)
    out = {}

    def work(name):
        with record("own") as rec:
            for _ in range(50):
                with span(name):
                    barrier.wait()
                    with span("inner"):
                        count(f"{name}.n")
            out[name] = rec

    threads = [threading.Thread(target=work, args=(n,)) for n in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
        assert not t.is_alive()
    for name in ("a", "b"):
        assert set(out[name]) == {"own", name, "inner", f"{name}/inner",
                                  f"{name}.n"}
        assert out[name][f"{name}.n"] == 50


def test_recording_off_keeps_no_list_and_calls_no_cuda_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the tracer called torch.cuda")

    for name in dir(torch.cuda):
        if not name.startswith("__") and callable(getattr(torch.cuda, name)):
            monkeypatch.setattr(torch.cuda, name, refuse)
    assert "torch" not in vars(trace)
    timer = StageTimes()
    with record("x") as rec, timer.stage("x"):
        with span("y"):
            count("z", 2)
    assert rec["x"] > 0 and rec["x/y"] == rec["y"] and rec["z"] == 2
    assert trace._recording is None

    def spans(n):
        with record() as r:
            for _ in range(n):
                with span("a"):
                    with span("b"):
                        count("c")
        return r

    spans(100)
    mine = [tracemalloc.Filter(True, trace.__file__)]
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot().filter_traces(mine)
        r = spans(20000)
        after = tracemalloc.take_snapshot().filter_traces(mine)
    finally:
        tracemalloc.stop()
    assert r["c"] == 20000 and trace._local.open == []
    assert sum(d.size_diff for d in after.compare_to(before, "filename")) < 4096


def test_torch_profile_shows_the_spans_around_the_profiled_operations(tmp_path):
    with torch_profile(str(tmp_path)):
        with span("s"):
            with torch.profiler.record_function("rf"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    (s,) = [e for e in events if e.get("cat") == "program_span"]
    (rf,) = [e for e in events if e.get("name") == "rf"
             and e.get("cat") != "program_span"]
    assert s["name"] == "s" and s["args"] == {"depth": 0}
    assert s["ts"] <= rf["ts"] and rf["ts"] + rf["dur"] <= s["ts"] + s["dur"]
    with open(tmp_path / "idle_by_span.json") as f:
        idle = json.load(f)
    # no card: nothing is device time, so the block is idle throughout
    assert idle["busy_s"] == pytest.approx(0, abs=1e-9)
    names = dict(idle["idle_by_span_s"])
    assert names["s"] > 0 and sum(names.values()) == pytest.approx(
        idle["window_s"])
    with torch_profile(str(tmp_path)):
        with pytest.raises(RuntimeError, match="already open"):
            with torch_profile(str(tmp_path)):
                pass


def test_idle_by_span_on_synthetic_intervals():
    spans = [(1, "A", 0, 60, 0), (1, "B", 10, 30, 1), (2, "C", 70, 90, 0),
             (3, "before", -20, -5, 0)]
    busy = [(95, 120), (40, 75), (8, 12), (5, 15)]
    assert idle_by_span(busy, spans, 0, 100) == [
        ("A", 0, 5),                      # inside A, before B opens
        ("B", 15, 30), ("A", 30, 40),     # a gap across B's end
        ("C", 75, 90), (None, 90, 95)]    # a gap leaving every span
    assert idle_by_span([], [], 0, 10) == [(None, 0, 10)]
    assert idle_by_span([(-5, 20)], spans, 0, 10) == []
    # of two open spans of two threads, the deeper one names the gap
    assert idle_by_span([], [(1, "outer", 0, 10, 0), (2, "deep", 2, 4, 1)],
                        0, 10) == [("outer", 0, 2), ("deep", 2, 4),
                                   ("outer", 4, 10)]


def test_launch_counts_into_launches_and_the_record(monkeypatch):
    class Lib:
        def __getattr__(self, entry):
            return lambda *args: 0

    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(kernels, "library", Lib)
    monkeypatch.setattr(kernels, "current_stream", lambda d: None)
    monkeypatch.setattr(kernels, "LAUNCHES", dict(kernels.LAUNCHES))
    before = dict(kernels.LAUNCHES)
    with record() as rec:
        kernels.launch("roi_align_windowed", "roi_align_windowed", "cuda:0")
    assert set(kernels.LAUNCHES) == set(before) and len(before) == 8
    assert kernels.LAUNCHES["roi_align_windowed"] == \
        before["roi_align_windowed"] + 1
    assert rec == {"launches.roi_align_windowed": 1}
    kernels.reset_launches()
    assert not any(kernels.LAUNCHES.values())


def test_relpos_attention_counts_its_launches(monkeypatch):
    """K7's launches reach ``launches.relpos_attention`` in the record."""
    class Lib:
        def __getattr__(self, entry):
            return lambda *args: 0

    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(kernels, "library", Lib)
    monkeypatch.setattr(kernels, "current_stream", lambda d: None)
    monkeypatch.setattr(kernels, "LAUNCHES", dict(kernels.LAUNCHES))
    with record() as rec:
        for _ in range(3):
            kernels.launch("relpos_attention", "relpos_attention", "cuda:0")
    assert rec == {"launches.relpos_attention": 3}
    assert kernels.LAUNCHES["relpos_attention"] >= 3


def _vitdet_perception():
    """The tiny perception above with a tiny ViTDet (a 4 x 4 map, 3 x 3
    windows, blocks 1 and 3 global) as its detector, made by
    ``build_detector``; the perception reads its square input from it."""
    from macaque_tpu_torch.nn import DetectorConfig
    from macaque_tpu_torch.nn.vitdet import ViTDetConfig
    from macaque_tpu_torch.pipeline.perception import TorchPerception
    from macaque_tpu_torch.pipeline.weights import build_detector

    base = _perception()
    torch.manual_seed(0)
    det = build_detector(
        "vitdet", "cpu", torch.float32,
        config=DetectorConfig(fpn_channels=16, rpn_nms_pre=100, rpn_max=40,
                              rcnn_max=10, rcnn_roi_topk=40, rcnn_roi_chunk=16),
        vit=ViTDetConfig(img_size=64, embed_dim=32, depth=4, num_heads=2,
                         window=3, global_blocks=(1, 3), pretrain_grid=3))
    with torch.no_grad():
        det.roi_head.bbox_head.fc_cls.bias[0] += 6.0
    p = TorchPerception(det, base.pose_model, base.id_model, max_det=D,
                        device="cpu")
    assert (p.det_target, p.det_square) == (64, 64)
    return p


def test_the_vitdet_trunk_spans_and_window_padding(tmp_path):
    """ViTDet's ``detector.vit`` and ``detector.pyramid`` sit inside
    ``detector.trunk``, once a chunk, and ``vit.window_pad_tokens`` counts
    the tokens the window blocks add: 6 x 6 - 4 x 4 = 20 a frame in each of
    the 2 window blocks."""
    frames = np.random.default_rng(1).integers(0, 256, (2 * B, H, W, 3),
                                               dtype=np.uint8)
    store = Store(frames)
    rec = process_camera(store, str(tmp_path), store.ftimes,
                         _vitdet_perception(), chunk=B, redo=True,
                         prefetch=False)
    assert rec["detector.trunk_calls"] == 2
    for name in ("detector.vit", "detector.pyramid"):
        assert rec[f"detector.trunk/{name}"] == pytest.approx(rec[name])
        assert rec[name] > 0
    assert rec["detector.vit"] + rec["detector.pyramid"] <= rec["detector.trunk"]
    assert rec["vit.window_pad_tokens"] == 2 * B * 2 * 20
    with open(tmp_path / "alldata.json") as f:
        rows = json.load(f)
    assert len(rows) == 2 * B and any(rows)
