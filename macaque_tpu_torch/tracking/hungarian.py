"""Linear sum assignment on the host (scipy).

The reference relies on scipy's ``linear_sum_assignment``
(step3_crossframematching.py:723) and boxmot's internal matcher. Instances
are tiny (<= 16x16), so the host path uses scipy.
"""

from __future__ import annotations

import numpy as np


def hungarian(cost: np.ndarray):
    """Host assignment: rows->cols minimizing total cost. Returns
    (row_idx, col_idx) like scipy."""
    from scipy.optimize import linear_sum_assignment

    return linear_sum_assignment(cost)
