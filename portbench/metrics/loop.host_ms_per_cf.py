"""Milliseconds a camera-frame of the camera loop's host work between the
perception's calls: ``process_camera``'s ``decode`` (the wait on the
decode-ahead thread), ``track`` and ``assemble`` seconds."""


def read(run, trace):
    seg = [s for s in run.segments if s[0] >= 0 and s[2] is not None]
    host = sum(s[2][n] for s in seg for n in ("decode", "track", "assemble"))
    return 1e3 * host / (len(run.frames) * len(seg))
