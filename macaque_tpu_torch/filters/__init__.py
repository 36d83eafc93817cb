"""Temporal filters on tensors: NaN interpolation, median filter, EMA,
Viterbi, and the keypoint-score autoencoder (port of
``macaque_tpu/filters``)."""

from macaque_tpu_torch.filters.smoothing import (
    interpolate_nan,
    median_filter_1d,
    ema_smooth,
)
from macaque_tpu_torch.filters.viterbi import (
    viterbi_filter, viterbi_filter_joints)
from macaque_tpu_torch.filters.autoencoder import (
    AEParams, filter_scores_autoencoder, load_autoencoder, save_autoencoder,
    train_autoencoder)

__all__ = [
    "interpolate_nan",
    "median_filter_1d",
    "ema_smooth",
    "viterbi_filter",
    "viterbi_filter_joints",
    "AEParams",
    "train_autoencoder",
    "save_autoencoder",
    "load_autoencoder",
    "filter_scores_autoencoder",
]
