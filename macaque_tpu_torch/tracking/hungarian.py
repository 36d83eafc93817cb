"""Linear sum assignment: scipy on the host, Jonker-Volgenant on tensors.

The reference relies on scipy's ``linear_sum_assignment``
(step3_crossframematching.py:723) and boxmot's internal matcher. Instances
are tiny (<= 16x16), so the host path uses scipy. :func:`hungarian_torch`
is the JAX package's ``hungarian_jax``: the same shortest augmenting path,
in float32, for the on-device track table, taking and giving tensors on the
table's device.
"""

from __future__ import annotations

import numpy as np
import torch


def hungarian(cost: np.ndarray):
    """Host assignment: rows->cols minimizing total cost. Returns
    (row_idx, col_idx) like scipy."""
    from scipy.optimize import linear_sum_assignment

    return linear_sum_assignment(cost)


def _solve(cost: np.ndarray) -> np.ndarray:
    """``hungarian_jax``'s loops on a float32 (N, M) array, operation for
    operation in float32. Returns col4row (N,) int64."""
    N, M = cost.shape
    f32 = np.float32
    INF = f32(np.inf)
    u, v = np.zeros(N, f32), np.zeros(M, f32)
    col4row, row4col = np.full(N, -1), np.full(M, -1)
    for cur_row in range(N):
        # Dijkstra over columns to find an augmenting path
        sp = np.full(M, INF)
        path = np.full(M, -1)
        done = np.zeros(M, bool)
        row_min = np.full(N, INF)
        i, min_val = cur_row, f32(0.0)
        pref = np.where(row4col < 0, f32(1e-9), f32(0.0))
        while True:
            red = min_val + cost[i] - u[i] - v
            better = ~done & (red < sp)
            sp = np.where(better, red, sp)
            path = np.where(better, i, path)
            masked = np.where(done, INF, sp)
            # prefer unassigned columns on ties (scipy tie-break); the
            # first index among equals, as jnp.argmin
            j = int(np.argmin(masked - pref))
            row_min[i] = min_val
            done[j] = True
            min_val = masked[j]
            if row4col[j] < 0:
                break
            i = row4col[j]
        # dual updates
        delta = min_val
        u[cur_row] += delta
        other = (row_min < INF) & (np.arange(N) != cur_row)
        sp_of_row = np.where(col4row >= 0, sp[np.clip(col4row, 0, None)],
                             f32(0.0))
        with np.errstate(invalid="ignore"):
            u = np.where(other, u + delta - sp_of_row, u)
            v = np.where(done, v + sp - delta, v)
        # augment: walk predecessors from the sink
        while True:
            i = path[j]
            row4col[j] = i
            j, col4row[i] = col4row[i], j
            if i == cur_row:
                break
    return col4row


def hungarian_torch(cost: torch.Tensor, stats: dict | None = None
                    ) -> torch.Tensor:
    """Shortest-augmenting-path assignment (Jonker-Volgenant), in float32
    as ``hungarian_jax`` solves it. cost (N, M) with N <= M, on any device.
    Returns col4row (N,) int64 on the cost's device.

    The cost is read to the host once and solved there by the JAX
    package's loops, and the assignment goes back to the cost's device. On
    the card a solve of the tracker's matrices (at most 16 x 32) is a few
    hundred dependent scans of one row each: run there, step by step, each
    scan's condition would be a host read of its own. Ties take the first
    index (``np.argmin``, as ``jnp.argmin``), with unassigned columns
    preferred by 1e-9, as in the JAX package. ``stats``, if given, has its
    ``host_reads`` raised by the one read made."""
    col4row = _solve(cost.detach().to("cpu", torch.float32).numpy())
    if stats is not None:
        stats["host_reads"] = stats.get("host_reads", 0) + 1
    return torch.from_numpy(col4row).to(cost.device)
