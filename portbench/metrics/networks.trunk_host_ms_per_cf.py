"""Host milliseconds a camera-frame in the detector's trunk: the program's
``detector.trunk`` span (``nn/detector.py::detect_frames``' one trunk call
a chunk) summed over the window's segments; nothing where the program has
no such span."""


def read(run, trace):
    seg = [s[2] for s in run.segments if s[0] >= 0 and s[2] is not None]
    if not seg or not all("detector.trunk" in r for r in seg):
        return None
    cf = len(run.frames) * len(seg)
    return 1e3 * sum(r["detector.trunk"] for r in seg) / cf
