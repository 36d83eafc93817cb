"""Spans, counters and records of the program; per-stage timing; a
profiler hook.

Port of ``macaque_tpu/core/trace.py``: ``StageTimes`` prints the same
``[trace]`` lines and writes the same ``run_manifest.json``;
``torch_profile`` is the counterpart of ``xla_profile``, on
``torch.profiler``.

The port's one tracer:

- :func:`span` times a block on ``time.time_ns()``, the Unix-epoch clock
  that ``torch.profiler``'s events also report, and adds its seconds to
  the current record under its name and, when it is nested in another
  span of that record, under ``<parent>/<name>`` too;
- :func:`count` adds to an integer counter of the current record;
- :func:`record` opens a record: a flat dict of span seconds and counters,
  one per thread (``process_camera`` opens one a call and returns it).

With no profile open a span is two clock reads and two dict adds, and a
counter an integer add: neither touches the device nor keeps a list. While
:func:`torch_profile` is open every span is also kept as ``(thread, name,
t0_ns, t1_ns, depth)``, and the profile's ``trace.json`` shows them beside
the device's events.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Optional


class _Local(threading.local):
    def __init__(self):
        self.records = []       # (record, depth of open spans at its start)
        self.open = []          # names of the open spans, innermost last


_local = _Local()
# the spans kept while torch_profile is open, else None
_recording: Optional[list] = None


class span:
    """``with span(name):`` times the block and adds its seconds to the
    current thread's record, if one is open. Spans nest."""

    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _local.open.append(self.name)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        loc = _local
        loc.open.pop()
        depth = len(loc.open)
        if loc.records:
            rec, base = loc.records[-1]
            dt = (t1 - self.t0) * 1e-9
            rec[self.name] = rec.get(self.name, 0.0) + dt
            if depth > base:
                key = f"{loc.open[-1]}/{self.name}"
                rec[key] = rec.get(key, 0.0) + dt
        kept = _recording
        if kept is not None:
            kept.append((threading.get_native_id(), self.name, self.t0, t1,
                         depth))
        return False


def count(name: str, n: int = 1, total: Optional[tuple] = None) -> None:
    """Add ``n`` to the counter ``name`` of the current thread's record, if
    one is open, and with ``total=(counters, key)`` to ``counters[key]``
    as well (``kernels.LAUNCHES``)."""
    if total is not None:
        counters, key = total
        counters[key] += n
    if _local.records:
        rec = _local.records[-1][0]
        rec[name] = rec.get(name, 0) + n


@contextlib.contextmanager
def record(*keys: str):
    """Open a record for this thread, its ``keys`` at 0.0, and yield it:
    the spans and counters of the block (spans of other threads do not
    reach it)."""
    rec = dict.fromkeys(keys, 0.0)
    _local.records.append((rec, len(_local.open)))
    try:
        yield rec
    finally:
        _local.records.pop()


@dataclass
class StageTimes:
    """Accumulates wall-time per named stage; dumps JSON (the JAX
    package's ``StageTimes``). Each stage is also a :func:`span`."""

    times: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
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


def idle_by_span(busy_intervals, spans, t0: int, t1: int) -> list:
    """The idle time of a device in ``[t0, t1]`` (ns), cut at the spans'
    edges: ``(name, start, end)`` pieces in time order, each named by the
    innermost span open over it (the deepest, then the latest started, of
    any thread), or None outside every span. ``busy_intervals`` are the
    device's ``(start, end)`` activities, in any order and overlapping;
    ``spans`` are ``(thread, name, start, end, depth)``, as
    :func:`torch_profile` keeps them."""
    gaps, cur = [], t0
    for s, e in sorted(busy_intervals):
        if s >= t1:
            break
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < t1:
        gaps.append((cur, t1))

    spans = sorted(spans, key=lambda s: s[2])
    ends = sorted(range(len(spans)), key=lambda i: spans[i][3])
    edges = sorted({t for s in spans for t in s[2:4] if t0 < t < t1} | {t0, t1})
    labelled, active, si, ei = [], {}, 0, 0
    for a, b in zip(edges, edges[1:]):
        while si < len(spans) and spans[si][2] <= a:
            active[si] = spans[si]
            si += 1
        while ei < len(ends) and spans[ends[ei]][3] <= a:
            active.pop(ends[ei], None)
            ei += 1
        inner = max(active.values(), key=lambda s: (s[4], s[2]), default=None)
        labelled.append((a, b, inner[1] if inner else None))

    pieces, j = [], 0
    for g0, g1 in gaps:
        while labelled[j][1] <= g0:
            j += 1
        for a, b, name in labelled[j:]:
            if a >= g1:
                break
            lo, hi = max(a, g0), min(b, g1)
            if hi > lo:
                pieces.append((name, lo, hi))
    return pieces


def _device_intervals(prof) -> list:
    """The (start, end) ns of every device activity in a finished profile."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CPU"):
            out.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


@contextlib.contextmanager
def torch_profile(logdir: Optional[str] = None):
    """Profile the block with ``torch.profiler``: the card's activity alone
    when there is one (profiling the host's operators too would slow the
    host about twofold), else the CPU's. Yields the profiler, whose
    ``key_averages()`` sum the time by operation (the JAX package's
    ``xla_profile``). Writes into ``logdir``:

    - ``trace.json`` (Chrome trace format, for Perfetto), with the
      program's spans of the block merged in as host-thread events
      (category ``program_span``) on the profiler's time base;
    - ``idle_by_span.json``: the block's length, the device's busy and
      idle seconds in it, and the idle seconds by the innermost span open
      at that moment (:func:`idle_by_span`; ``null`` outside every span).
    """
    global _recording
    import torch
    from torch.profiler import ProfilerActivity, profile

    if _recording is not None:
        raise RuntimeError("torch_profile: a profile is already open")
    logdir = logdir or os.environ.get(
        "MACAQUE_TPU_PROFILE_DIR",
        os.path.join(tempfile.gettempdir(), "macaque_tpu_torch_profile"))
    card = torch.cuda.is_available()
    kept = []
    with profile(activities=[ProfilerActivity.CUDA if card
                             else ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        _recording = kept
        try:
            yield prof
            if card:
                torch.cuda.synchronize()
        finally:
            _recording = None
            t1 = time.time_ns()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base, pid = trace.get("baseTimeNanoseconds", 0), os.getpid()
    trace["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": name, "pid": pid,
         "tid": tid, "ts": (a - base) / 1e3, "dur": (b - a) / 1e3,
         "args": {"depth": depth}}
        for tid, name, a, b, depth in kept)
    with open(path, "w") as f:
        json.dump(trace, f)

    pieces = idle_by_span(_device_intervals(prof), kept, t0, t1)
    by_span: dict = {}
    for name, a, b in pieces:
        by_span[name] = by_span.get(name, 0.0) + (b - a) * 1e-9
    idle = sum(by_span.values())
    window = (t1 - t0) * 1e-9
    with open(os.path.join(logdir, "idle_by_span.json"), "w") as f:
        json.dump({"window_s": window, "busy_s": window - idle, "idle_s": idle,
                   "idle_by_span_s": [[n, s] for n, s in sorted(
                       by_span.items(), key=lambda kv: -kv[1])]}, f, indent=1)
    print(f"[trace] torch trace written to {path}")
