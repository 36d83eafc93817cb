"""What the benchmark sees of the program: spans, records and captures.

``Recorder`` stands in front of the program's perception as the camera
loop's backend. It puts each call into the perception in a span
(``detect``, ``pose``, ``classify``) and keeps the call's inputs and
outputs, which are small host arrays. ``instrument`` wraps the networks'
entry points (``net.detector`` around the detector's trunk and head,
``net.pose``, ``net.classifier``) and, on the chunks that the output check
samples, keeps device copies of what they produced: the detector's FPN
maps, RPN outputs and proposals, and the pose network's heatmaps. Each is
kept at the granularity the check compares, not that of the call: the
detector's outputs one entry a frame, whatever the number of frames a call
takes, and the heatmaps of every pose call of the chunk, in call order.

Whatever its architecture, a program detector keeps the contract these
wrappers rely on: ``trunk(images) -> (maps, rpn)``, the pyramid's maps
and the RPN's (class, box) outputs a level, each with a leading frame
dimension; ``head(maps, rpn, img_shape)``, which makes the detections;
and ``_proposals(maps, rpn, img_shape) -> (boxes, valid)``, the ranked
proposals and their validity, each with a leading frame dimension, which
the head calls. The pose and classifier networks are called through
``forward``.

While ``marking`` is on (the traced segment), each span's start and end
also launch a one-cycle marker kernel on the card (``torch.cuda._sleep``,
``spin_kernel`` in the trace) and are listed in ``marks``, in launch order:
the device's own timeline then shows which operations each span launched,
without profiling the host.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


class Recorder:
    def __init__(self, perception, sample: set):
        self.inner = perception
        self.max_det = perception.max_det
        self.device = perception.device
        self.sample = sample            # {(segment, chunk)} to capture
        self.segment = -1
        self.chunk = -1
        self.capturing = False
        self.chunks = {}                # (segment, chunk) -> record dict
        self.captures = {}              # (segment, chunk) -> device copies
        self.marking = False
        self.marks = []                 # (span name, 0 start / 1 end)

    @contextlib.contextmanager
    def span(self, name):
        if self.marking:
            self.marks.append((name, 0))
            torch.cuda._sleep(1)
        try:
            yield
        finally:
            if self.marking:
                self.marks.append((name, 1))
                torch.cuda._sleep(1)

    def begin_segment(self, segment: int) -> None:
        self.segment, self.chunk = segment, -1

    def _call(self, name, fn, *args):
        """``fn(*args)``, a call into the perception, inside its span."""
        with self.span(name):
            return fn(*args)

    def _record(self):
        return self.chunks.setdefault((self.segment, self.chunk), {})

    def detect(self, frames):
        self.chunk += 1
        key = (self.segment, self.chunk)
        self.capturing = key in self.sample
        if self.capturing:
            self.captures[key] = {"maps": [], "rpn": [], "proposals": [],
                                  "heatmaps": []}
        boxes, scores = self._call("detect", self.inner.detect, frames)
        self._record().update(n=len(frames), det=(boxes, scores))
        return boxes, scores

    def pose(self, frames, boxes, valid):
        kps = self._call("pose", self.inner.pose, frames, boxes, valid)
        self._record().update(pose_in=(np.array(boxes), np.array(valid)),
                              kps=kps)
        return kps

    def classify(self, frames, boxes, valid):
        labels, scores = self._call("classify", self.inner.classify, frames,
                                    boxes, valid)
        self._record().update(id_in=(np.array(boxes), np.array(valid)),
                              id_out=(labels, scores))
        return labels, scores

    def _keep(self, name, value, per_frame=True):
        """Append a copy of ``value`` to the capture ``name``: one entry for
        each row of its leading (frame) dimension, or, with ``per_frame``
        off, the whole output as one entry."""
        if not self.capturing:
            return
        cap = self.captures[(self.segment, self.chunk)][name]
        if not per_frame:
            cap.append(_clone(value, slice(None)))
            return
        for i in range(_rows(value)):
            cap.append(_clone(value, slice(i, i + 1)))


def _rows(x) -> int:
    return x.shape[0] if isinstance(x, torch.Tensor) else _rows(x[0])


def _clone(x, rows: slice):
    """A copy of the nested tensors ``x``, each cut to ``rows``."""
    if isinstance(x, torch.Tensor):
        return x[rows].detach().clone()
    return type(x)(_clone(v, rows) for v in x)


def instrument(rec: Recorder, det, pose, idm) -> None:
    """Spans around the three networks and the captures of the sampled
    chunks, installed on the program's module objects."""
    trunk, head, proposals = det.trunk, det.head, det._proposals

    def trunk_fn(images):
        with rec.span("net.detector"):
            maps, rpn = trunk(images)
        rec._keep("maps", maps)
        rec._keep("rpn", rpn)
        return maps, rpn

    def head_fn(*args, **kw):
        with rec.span("net.detector"):
            return head(*args, **kw)

    def proposals_fn(*args):
        out = proposals(*args)
        rec._keep("proposals", out)
        return out

    det.trunk, det.head, det._proposals = trunk_fn, head_fn, proposals_fn
    for name, mod, keep in (("net.pose", pose, "heatmaps"),
                            ("net.classifier", idm, None)):
        mod.forward = _ranged(name, mod.forward, rec, keep)


def _ranged(name, forward, rec, keep):
    def fn(x):
        with rec.span(name):
            out = forward(x)
        if keep:
            rec._keep(keep, out, per_frame=False)
        return out
    return fn
