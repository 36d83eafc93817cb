"""Percent of K7's roofline: the least time of every K7 launch in the
traced segment (``rooflines/k7.py``: the global blocks bound by
operations, the window blocks by bytes) over K7's device time there;
nothing where K7 did not run."""

from portbench.files import arch, load_module


def read(run, trace):
    if trace is None:
        return None
    k = load_module("rooflines/k7.py")
    t = sum(v for n, v in trace["by_name"].items()
            if any(name in n for name in k.KERNELS))
    calls = [r["n"] for (s, _), r in run.rec.chunks.items()
             if s == -2 and "n" in r]
    c = run.cfg["networks"]["detector"]
    if t <= 0 or not calls or "window" not in c:
        return None
    hw = arch(c).input_hw(run.mix["frame_hw"], c)
    return 100.0 * k.bound_s(c, hw, calls) / t
