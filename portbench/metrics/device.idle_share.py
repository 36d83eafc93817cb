"""Percent of the traced segment in which no operation ran on the device:
1 - (union of device-busy intervals / the traced window)."""


def read(run, trace):
    if trace is None or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
