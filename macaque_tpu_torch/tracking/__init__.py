"""Multi-object tracking: BoT-SORT-style two-stage association with a
constant-velocity Kalman filter, on the host (NumPy/scipy; copies of the JAX
package's host paths) and on the device (``device_tracker``: the track table
on a tensor device, with the Kalman filter and the Jonker-Volgenant
assignment in PyTorch)."""

from macaque_tpu_torch.tracking.botsort import BotSortTracker, TrackerParams
from macaque_tpu_torch.tracking.device_tracker import (
    EMPTY, LOST, TRACKED, UNCONFIRMED, TrackTable, make_table,
    track_chunk_device)
from macaque_tpu_torch.tracking.hungarian import hungarian, hungarian_torch
from macaque_tpu_torch.tracking.kalman import (
    KalmanXYWH, kalman_predict, kalman_update)

__all__ = ["KalmanXYWH", "BotSortTracker", "TrackerParams", "hungarian",
           "hungarian_torch", "kalman_predict", "kalman_update", "EMPTY",
           "TRACKED", "LOST", "UNCONFIRMED", "TrackTable", "make_table",
           "track_chunk_device"]
