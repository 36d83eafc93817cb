"""Seconds from the process start to the window: imports, the kernel
library, the weights, the frames and the warm-up segment (host clock)."""


def read(run, trace):
    return run.setup_s
