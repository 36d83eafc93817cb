"""Milliseconds a camera-frame in ``TorchPerception.detect``, from
``process_camera``'s ``detect`` seconds over the window's segments."""


def read(run, trace):
    return _stage_ms(run, ("detect",))


def _stage_ms(run, names):
    seg = [s for s in run.segments if s[0] >= 0 and s[2] is not None]
    frames = len(run.frames) * len(seg)
    return 1e3 * sum(s[2][n] for s in seg for n in names) / frames
