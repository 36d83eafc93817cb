"""Device milliseconds a camera-frame of the kernels that the detector's
calls launched (the ``net.detector`` ranges around ``trunk`` and ``head``),
in the traced segment."""


def read(run, trace):
    if trace is None or "net.detector" not in trace["by_range"]:
        return None
    _, _, frames = run.crops(lambda s: s == -2)
    return 1e3 * trace["by_range"]["net.detector"] / frames
