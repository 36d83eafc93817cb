"""Host milliseconds a camera-frame in the ViT backbone of the detector:
the program's ``detector.vit`` span (``nn/vitdet.py``, the 32 blocks
inside ``detector.trunk``) summed over the window's segments; nothing
where the program has no such span."""


def read(run, trace):
    seg = [s[2] for s in run.segments if s[0] >= 0 and s[2] is not None]
    if not seg or not all("detector.vit" in r for r in seg):
        return None
    cf = len(run.frames) * len(seg)
    return 1e3 * sum(r["detector.vit"] for r in seg) / cf
