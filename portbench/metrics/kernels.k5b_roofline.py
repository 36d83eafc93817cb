"""Percent of K5b's roofline: the least time of every K5b launch in the
traced segment (``rooflines/k5b.py``, operations-bound) over K5b's device
time there, its two kernels' (the row quantizer and the int8 GEMM);
nothing where K5b did not run."""

from portbench.files import load_module


def read(run, trace):
    return _share(run, trace, load_module("rooflines/k5b.py"))


def _share(run, trace, k):
    if trace is None:
        return None
    t = sum(v for n, v in trace["by_name"].items()
            if any(name in n for name in k.KERNELS))
    pose, _, _ = run.crops(lambda s: s == -2)
    if t <= 0 or not pose:
        return None
    return 100.0 * k.bound_s(run.cfg["networks"]["pose"], pose) / t
