"""Host milliseconds a camera-frame in the detector's head: the program's
``detector.head`` span (the detector's ``head``: proposals and the RPN NMS,
the RoI features and K2, the box head and its NMS) summed over the
window's segments; nothing where the program has no such span."""


def read(run, trace):
    seg = [s[2] for s in run.segments if s[0] >= 0 and s[2] is not None]
    if not seg or not all("detector.head" in r for r in seg):
        return None
    cf = len(run.frames) * len(seg)
    return 1e3 * sum(r["detector.head"] for r in seg) / cf
