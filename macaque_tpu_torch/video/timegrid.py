"""PTP time-grid alignment of multi-camera streams.

The reference builds a uniform clock ``T = arange(t0, t_end, 1/fps)`` from
camera 0 and, per camera and per tick, picks the frame whose timestamp is
nearest, reusing the previous result when the same frame repeats
(step1_proc2d.py:403-418, 211-223). Here the whole alignment is one
vectorized argmin over the chunk instead of a per-frame Python search.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def make_time_grid(
    frame_times0: np.ndarray,
    fps: float,
    t_intv: Optional[Tuple[float, float]] = None,
) -> np.ndarray:
    t0 = frame_times0[0]
    if t_intv is None:
        t_start, t_end = t0, frame_times0[-1]
    else:
        t_start, t_end = t0 + t_intv[0], t0 + t_intv[1]
    return np.arange(t_start, t_end, 1.0 / fps)


def align_time_grid(frame_times: np.ndarray, T: np.ndarray) -> np.ndarray:
    """For each grid tick, index of the nearest camera frame (monotone
    non-decreasing). Vectorized nearest-neighbour via searchsorted."""
    ft = np.asarray(frame_times)
    pos = np.searchsorted(ft, T)
    pos = np.clip(pos, 1, len(ft) - 1)
    left = ft[pos - 1]
    right = ft[pos]
    idx = np.where(np.abs(T - left) <= np.abs(right - T), pos - 1, pos)
    return idx.astype(np.int64)
