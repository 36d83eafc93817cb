"""Camera-frames through stage 1 per second: every camera-frame of the
window's segments over the window's length (host clock)."""


def read(run, trace):
    frames = sum(len(run.frames) for s in run.segments if s[0] >= 0)
    return frames / run.window_s
