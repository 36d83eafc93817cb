"""Multi-object tracking on the host: BoT-SORT-style two-stage association
with a constant-velocity Kalman filter (NumPy/scipy; copies of the JAX
package's host paths)."""

from macaque_tpu_torch.tracking.botsort import BotSortTracker, TrackerParams
from macaque_tpu_torch.tracking.hungarian import hungarian
from macaque_tpu_torch.tracking.kalman import KalmanXYWH

__all__ = ["KalmanXYWH", "BotSortTracker", "TrackerParams", "hungarian"]
