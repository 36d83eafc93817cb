"""Percent of the chip's peak that the perception's work in the window
would take: the networks' operations on the window's calls (counted from
shapes by the configuration's count files), bf16 over 989 TFLOP/s, int8
over 1,979 TOP/s, float32 over 67 TFLOP/s, over the window's length."""

from portbench.peaks import least_seconds


def read(run, trace):
    if not run.card:
        return None
    work = run.work(*run.crops(lambda s: s >= 0))
    return 100.0 * least_seconds(work) / run.window_s
