"""``torch.cuda.max_memory_allocated()`` over the window, GiB."""


def read(run, trace):
    return run.window_peak / 2 ** 30 if run.card else None
