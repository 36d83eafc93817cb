"""Milliseconds a camera-frame in ``TorchPerception.pose`` and
``.classify``, from ``process_camera``'s ``pose+id`` seconds over the
window's segments; nothing where the window ran no pose."""


def read(run, trace):
    pose, _, _ = run.crops(lambda s: s >= 0)
    if not pose:
        return None
    seg = [s for s in run.segments if s[0] >= 0 and s[2] is not None]
    return 1e3 * sum(s[2]["pose+id"] for s in seg) / (len(run.frames) * len(seg))
