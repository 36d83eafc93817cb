"""Device milliseconds a camera-frame of K7, the detector's attention with
decomposed relative position (``rooflines/k7.py``'s kernels), in the
traced segment; nothing where K7 did not run."""

from portbench.files import load_module


def read(run, trace):
    if trace is None:
        return None
    names = load_module("rooflines/k7.py").KERNELS
    t = sum(v for n, v in trace["by_name"].items()
            if any(name in n for name in names))
    _, _, frames = run.crops(lambda s: s == -2)
    if t <= 0 or not frames:
        return None
    return 1e3 * t / frames
