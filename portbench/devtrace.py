"""Aggregates of one ``torch.profiler`` trace of the device, kept in memory.

The profiler records the device's activity alone (kernels, copies, sets):
profiling the host's operators as well would slow the host, which sets the
pace here, about twofold. The recorder's spans (``detect``, ``pose``,
``classify`` around the perception's calls; ``net.detector``, ``net.pose``,
``net.classifier`` around the networks') reach the device's timeline as
marker kernels, one at each edge, in launch order. From those: the union
of the device-busy intervals; device time by operation name; device time
inside each span; and the device's idle time, labelled with the span the
loop was in (a gap inside ``detect`` is the host launching the detector's
work; between spans: ``track`` after ``detect``, ``assemble`` after
``classify``; before the segment's first operation and after its last:
``decode+write``). Nothing is written to disk.
"""

from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict

MARKER = "spin_kernel"
OUTER = ("detect", "pose", "classify")
AFTER = {"detect": "track", "pose": "pose", "classify": "assemble"}


def summarize(prof, window_s: float, marks: list) -> dict:
    """The aggregates of a finished profile of one segment that took
    ``window_s`` seconds on the host's clock; ``marks`` lists the marker
    kernels' (span, edge) in launch order."""
    ops, markers = [], []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CPU"):
            continue
        name, start, dur = e.name(), e.start_ns(), e.duration_ns()
        if MARKER in name:
            markers.append((start, start + dur))
        elif dur > 0:
            ops.append((start, start + dur, name))
    ops.sort()
    markers.sort()
    by_name = defaultdict(float)
    for s, e, name in ops:
        by_name[name] += (e - s) * 1e-9
    busy, gaps = _union([(s, e) for s, e, _ in ops])
    spans = _spans(markers, marks)
    by_range = {name: sum(_overlap(ops, r0, r1) for r0, r1 in rs) * 1e-9
                for name, rs in spans.items()}
    outer = sorted((s, e, n) for n in OUTER for s, e in spans.get(n, []))
    outer = ([s for s, _, _ in outer], [e for _, e, _ in outer],
             [n for _, _, n in outer])
    idle = defaultdict(float)
    for g0, g1 in gaps:
        for label, ns in _split(outer, g0, g1):
            idle[label] += ns * 1e-9
    busy_s = busy * 1e-9
    idle["decode+write"] += max(window_s - busy_s - sum(idle.values()), 0.0)
    return {"window_s": window_s, "busy_s": busy_s, "by_name": dict(by_name),
            "by_range": by_range, "idle_by_label": dict(idle)}


def _spans(markers, marks) -> dict:
    """Each span's device interval, from the end of its start marker to the
    start of its end marker; none if the trace lost a marker."""
    if len(markers) != len(marks):
        return {}
    spans, open_ = defaultdict(list), defaultdict(list)
    for (s, e), (name, edge) in zip(markers, marks):
        if edge == 0:
            open_[name].append(e)
        else:
            spans[name].append((open_[name].pop(), s))
    return spans


def _union(intervals):
    """(busy length, gaps between the merged intervals) of sorted
    intervals."""
    busy, gaps, cur0, cur1 = 0, [], None, None
    for s, e in intervals:
        if cur1 is None or s > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
                gaps.append((cur1, s))
            cur0, cur1 = s, e
        else:
            cur1 = max(cur1, e)
    if cur1 is not None:
        busy += cur1 - cur0
    return busy, gaps


def _overlap(ops, r0, r1) -> int:
    """Device time of the operations inside [r0, r1]."""
    total = 0
    for s, e, _ in ops[max(bisect_right(ops, (r0,)) - 1, 0):]:
        if s >= r1:
            break
        total += max(0, min(e, r1) - max(s, r0))
    return total


def _split(outer, g0, g1):
    """The gap [g0, g1] cut at the perception spans' edges: each part named
    by the span holding it, or by what the loop does after the last span
    that ended before it."""
    starts, ends, names = outer
    i = bisect_right(starts, g0) - 1
    t = g0
    while t < g1:
        if i >= 0 and t < ends[i]:
            stop, label = min(ends[i], g1), names[i]
        else:
            stop = min(starts[i + 1], g1) if i + 1 < len(starts) else g1
            label = AFTER[names[i]] if i >= 0 else "decode+write"
        if stop > t:
            yield label, stop - t
        t = stop
        if i + 1 < len(starts) and t >= starts[i + 1]:
            i += 1


def breakdown(summary: dict, top: int = 10) -> dict:
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(summary["idle_by_label"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle if s > 0]}
