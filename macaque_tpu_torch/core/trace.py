"""Per-stage timing and a profiler hook.

Port of ``macaque_tpu/core/trace.py``: ``StageTimes`` prints the same
``[trace]`` lines and writes the same ``run_manifest.json``;
``torch_profile`` is the counterpart of ``xla_profile``, on
``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class StageTimes:
    """Accumulates wall-time per named stage; dumps JSON (the JAX
    package's ``StageTimes``)."""

    times: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            print(f"[trace] {name}: {dt:.3f}s", flush=True)

    def summary(self) -> dict:
        return {
            name: {"total_s": round(t, 4), "calls": self.counts[name]}
            for name, t in self.times.items()
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def torch_profile(logdir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace of the block, the card's kernels
    too when there is one, and write it as ``trace.json`` (Chrome trace
    format) into ``logdir`` (the JAX package's ``xla_profile``). Yields
    the profiler, whose ``key_averages()`` sum the time by operator."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.environ.get(
        "MACAQUE_TPU_PROFILE_DIR",
        os.path.join(tempfile.gettempdir(), "macaque_tpu_torch_profile"))
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[trace] torch trace written to {path}")
