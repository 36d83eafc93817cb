"""One run of one cell: set-up, the measured window, the traced segment,
the output check and the result line.

The program under test is ``macaque_tpu_torch``: its camera loop
(``pipeline/step1.py::process_camera``) over a ``TorchPerception`` whose
three networks (detector, pose, classifier) the architecture files that
the configuration names (``archs/``) build through the port's public
constructors, their weights loaded from state dicts seeded on the device.
The traffic is one camera's segment of frames from the mix, served from
memory; every segment is a fresh ``process_camera`` call with fresh
tracker and EMA state, as ``run_step1`` gives each camera, writing its
``alldata.json`` under ``TMPDIR``.

Set-up runs from the process start to the window: imports, the kernel
library (built once into ``portbench/.cache/kernels``), the weights, the
frames and one warm-up segment. A run that builds the library also gives
the build's seconds, which ``setup_s`` includes, as ``kernel_build_s``.
The window then runs segments in a closed loop and ends when the segment
running at ``--seconds`` completes; ``stage1_cf_s`` is its camera-frames
over its length. With ``--trace 1`` one more segment runs under
``torch.profiler`` after the window, for the device metrics. The output check runs last, after the program is freed.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from portbench import check, devtrace, files, traffic
from portbench.recorder import Recorder, instrument
from portbench.weights import seeded_state

FORBIDDEN = ("jax", "jaxlib", "flax", "macaque_tpu")


ROLES = ("detector", "pose", "classifier")


def build_program(cfg: dict, mix: dict, seed: int, device: torch.device):
    """The configuration's three networks as their architecture files
    build them, loaded from the seeded state dicts, and the perception over
    them; the mix's ``fg_bias`` raises the detector's foreground bias."""
    from macaque_tpu_torch.pipeline.perception import TorchPerception

    dt = torch.bfloat16 if device.type == "cuda" else torch.float32
    blocks = cfg["networks"]
    archs = {r: files.arch(blocks[r]) for r in ROLES}
    models = {r: archs[r].program(blocks[r], dt, device) for r in ROLES}
    kwargs = {}
    for r in ROLES:
        sd = seeded_state(r, blocks[r], seed, device)
        if r == "detector":
            sd[archs[r].FG_BIAS][0] += mix["fg_bias"]
        models[r].load_state_dict(sd)
        archs[r].loaded(models[r], blocks[r], sd)
        kwargs.update(archs[r].perception_kwargs(blocks[r]))
        del sd
    nets = tuple(models[r] for r in ROLES)
    perception = TorchPerception(*nets, max_det=cfg["max_det"], device=device,
                                 **kwargs)
    return perception, nets


def well_formed(rows: list, n: int, D: int) -> bool:
    """``alldata.json`` of one segment: n frames of at most D entries, each
    a finite box, 17 joints blanked below threshold, an id score in
    [0, 1]."""
    if len(rows) != n:
        return False
    for frame in rows:
        if len(frame) > D:
            return False
        for tid, x1, y1, x2, y2, kps, aid, asc in frame:
            kp = np.asarray(kps, np.float64)
            seen = kp[:, 2] > 0
            if (kp.shape != (17, 3) or not np.isfinite([x1, y1, x2, y2, asc]).all()
                    or not (x2 > x1 and y2 > y1) or not np.isfinite(kp[seen]).all()
                    or not np.isnan(kp[~seen, :2]).all() or not 0 <= asc <= 1):
                return False
    return True


class Run:
    """State of one run; ``device`` is the card, or the CPU in tests."""

    def __init__(self, cell: dict, seed: int, device, t0: float):
        self.cell, self.seed, self.t0 = cell, seed, t0
        self.cfg, self.mix = cell["config"], traffic.check_mix(cell["mix"])
        self.device = torch.device(device)
        self.card = self.device.type == "cuda"
        self.D = self.cfg["max_det"]
        self.segments = []          # (index, wall s, stages, rows or None)

    def _sync(self):
        if self.card:
            torch.cuda.synchronize(self.device)

    def setup(self) -> None:
        from macaque_tpu_torch import kernels
        from macaque_tpu_torch.core.config import Step1Config
        from macaque_tpu_torch.pipeline.step1 import process_camera

        self.kernels, self.step1 = kernels, Step1Config()
        self.process_camera = process_camera
        self.build_s = 0.0
        if self.card:
            # a checkout's first run builds the kernel library; setup_s
            # includes the build, which is also reported by itself
            built = os.path.exists(kernels.library_path())
            t = time.perf_counter()
            kernels.library()
            if not built:
                self.build_s = time.perf_counter() - t
        perception, (det, pose, idm) = build_program(self.cfg, self.mix,
                                                     self.seed, self.device)
        self.frames = traffic.frames(self.mix, self.seed, self.device)
        self.store = traffic.MemoryStore(self.frames, self.mix["fps"])
        # the chunks of the window's first segment that the check compares
        rng = np.random.default_rng(self.seed % (1 << 63))
        n_chunks = math.ceil(self.mix["segment_frames"] / self.mix["chunk"])
        sample = {(0, int(c)) for c in rng.choice(
            n_chunks, self.mix["check_chunks"], replace=False)}
        self.rec = Recorder(perception, sample)
        instrument(self.rec, det, pose, idm)
        self.tmp = tempfile.mkdtemp(prefix="portbench-")
        self.segment(-1)                                   # warm-up
        if self.segments[-1][3] is None:
            raise RuntimeError("the warm-up segment failed")
        self.segments.clear()
        self._sync()
        self.setup_peak = (torch.cuda.max_memory_allocated(self.device)
                           if self.card else 0)
        self.setup_s = time.perf_counter() - self.t0

    def segment(self, idx: int) -> None:
        self.rec.begin_segment(idx)
        out = tempfile.mkdtemp(prefix=f"seg{idx}-", dir=self.tmp)
        t = time.perf_counter()
        rows = stages = None
        try:
            with contextlib.redirect_stdout(sys.stderr):
                stages = self.process_camera(
                    self.store, out, self.store.ftimes, self.rec, self.step1,
                    chunk=self.mix["chunk"], redo=True)
            self._sync()
            with open(os.path.join(out, "alldata.json")) as f:
                rows = json.load(f)
            if not well_formed(rows, len(self.frames), self.D):
                print(f"segment {idx}: malformed alldata.json", file=sys.stderr)
                rows = None
        except Exception:  # noqa: BLE001 (a failed segment fails its frames)
            traceback.print_exc()
        finally:
            shutil.rmtree(out, ignore_errors=True)
        self.segments.append((idx, time.perf_counter() - t, stages, rows))

    def window(self, seconds: float) -> None:
        if self.card:
            torch.cuda.reset_peak_memory_stats(self.device)
        self.kernels.reset_launches()
        t0 = time.perf_counter()
        i = 0
        while True:
            self.segment(i)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0
        self.launches = dict(self.kernels.LAUNCHES)
        self.window_peak = (torch.cuda.max_memory_allocated(self.device)
                            if self.card else 0)

    def traced_segment(self) -> dict:
        """One more segment with the device's activity profiled (on the CPU,
        the host's, for the tests)."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA if self.card else ProfilerActivity.CPU]
        self.rec.marking = self.card
        try:
            with profile(activities=acts) as prof:
                self.segment(-2)
        finally:
            self.rec.marking = False
        return devtrace.summarize(prof, self.segments[-1][1], self.rec.marks)

    def crops(self, seg_filter) -> tuple:
        """(pose crops per pose call, ID crops per classify call, frames
        detected) over the records of the segments ``seg_filter`` takes."""
        flip = 2 if self.cfg["networks"]["pose"]["flip_test"] else 1
        pose, ids, frames = [], [], 0
        for (seg, _), r in self.rec.chunks.items():
            if not seg_filter(seg):
                continue
            frames += r.get("n", 0)
            if "pose_in" in r:
                pose.append(r["n"] * self.D * flip)
            if "id_in" in r:
                ids.append(r["n"] * self.D)
        return pose, ids, frames

    def work(self, pose_crops, id_crops, frames) -> dict:
        """Operations of the networks' calls, by the type they run in."""
        n = self.cfg["networks"]
        counts = self.cfg["counts"]
        total = {"bf16": 0.0, "int8": 0.0, "f32": 0.0}

        def add(ops, times):
            for k, v in ops.items():
                total[k] += v * times

        det = n["detector"]
        add(files.load_module(counts["detector"]).ops(
            det, files.arch(det).input_hw(self.mix["frame_hw"], det)), frames)
        add(files.load_module(counts["pose"]).ops(n["pose"]), sum(pose_crops))
        add(files.load_module(counts["classifier"]).ops(n["classifier"]),
            sum(id_crops))
        return total

    def path_violations(self) -> int:
        """Kernels that launched off the configuration's path, or did not
        launch on it, in the window."""
        path = self.cfg["path"]
        ran_pose = any("pose_in" in r for (s, _), r in self.rec.chunks.items()
                       if s >= 0)
        expect = set(path["detect"]) | (set(path["pose"]) if ran_pose else set())
        return sum((k in expect) != (v > 0) for k, v in self.launches.items())

    def judged(self, key) -> check.Judged:
        cap, rec = self.rec.captures[key], self.rec.chunks[key]
        c0 = key[1] * self.mix["chunk"]
        j = check.Judged(
            frames=self.frames[c0:c0 + rec["n"]], det=rec["det"],
            maps=cap["maps"], rpn=cap["rpn"],
            proposals=[p[0][v[0]] for p, v in cap["proposals"]])
        if "pose_in" in rec:
            j.pose_in, j.kps = rec["pose_in"], rec["kps"]
            j.heatmaps = torch.cat(cap["heatmaps"]) if cap["heatmaps"] else None
        if "id_in" in rec:
            j.id_in, j.id_out = rec["id_in"], rec["id_out"]
        return j

    def free_program(self) -> None:
        self.rec.inner = self.store = None
        gc.collect()
        if self.card:
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The output numbers of this run (program side)."""
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        try:
            ref = check.Reference(self.cfg, self.seed, self.device,
                                  self.mix["fg_bias"])
            numbers = {}
            for key in sorted(self.rec.captures):
                try:
                    got = check.compare(self.judged(key), ref)
                except Exception:  # noqa: BLE001 (malformed outputs fail)
                    traceback.print_exc()
                    got = dict.fromkeys(check.CHUNK, float("inf"))
                for k, v in got.items():
                    numbers[k] = max(numbers.get(k, 0.0), v)
            if not numbers:
                raise RuntimeError("no sampled chunk ran in the window")
            window_rows = [(i, rows) for i, _, _, rows in self.segments
                           if i >= 0 and rows is not None]
            numbers["rows"] = check.check_rows(window_rows, self.rec.chunks, self.D)
            if self.card:
                numbers["path"] = self.path_violations()
            return numbers
        finally:
            torch.backends.cuda.matmul.allow_tf32, \
                torch.backends.cudnn.allow_tf32 = flags

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


def metric_values(run: Run, names: list, trace: dict | None) -> dict:
    """Each metric's reader (``metrics/<name>.py``) on this run; a reader
    that finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in names:
        value = files.load_module(f"metrics/{m['name']}.py").read(run, trace)
        if value is None:
            print(f"metric {m['name']}: nothing to read", file=sys.stderr)
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t0: float) -> tuple[dict, list]:
    """One run; returns (the result line, the checks' (name, value, limit))."""
    run = Run(cell, seed, device, t0)
    try:
        run.setup()
        t = time.perf_counter()
        run.window(seconds)
        summary = run.traced_segment() if trace else None
        t_trace = time.perf_counter() - t - run.window_s
        peak = max(run.setup_peak, run.window_peak)
        window = [s for s in run.segments if s[0] >= 0]
        attempted = len(window) * len(run.frames)
        failed = sum(len(run.frames) for s in window if s[3] is None)
        names = cell["per_layer"] if trace else cell["end_to_end"]
        metrics = metric_values(run, names, summary)
        run.free_program()
        t = time.perf_counter()
        numbers = run.check()
        print(f"set-up {run.setup_s:.3f} s (the kernel library's build "
              f"{run.build_s:.3f} s of it), window {run.window_s:.3f} s, "
              f"traced segment and its reading {t_trace:.3f} s, check "
              f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
    finally:
        run.close()
    ok, lines = check.judge(numbers, cell["limits"])
    device_info = {"platform": "gpu" if run.card else "cpu",
                   "kind": (torch.cuda.get_device_name(run.device) if run.card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok and failed == 0 and attempted > 0),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_info}
    if summary is not None:
        device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = devtrace.breakdown(summary)
    result["kernel_build_s"] = run.build_s
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in lines}
    return result, lines
