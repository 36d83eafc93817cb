"""Temporal filters on tensors: NaN interpolation, median filter, EMA,
Viterbi (port of ``macaque_tpu/filters``; the score autoencoder waits for
the training port, ROADMAP.md §1 item 7)."""

from macaque_tpu_torch.filters.smoothing import (
    interpolate_nan,
    median_filter_1d,
    ema_smooth,
)
from macaque_tpu_torch.filters.viterbi import (
    viterbi_filter, viterbi_filter_joints)

__all__ = [
    "interpolate_nan",
    "median_filter_1d",
    "ema_smooth",
    "viterbi_filter",
    "viterbi_filter_joints",
]
