"""Exact linear assignment: the host solver (scipy) and :func:`hungarian`.

:func:`linear_assignment` is the host-side solver of
``vbt_tpu.tracking.assignment``, with scipy only: the JAX package prefers its
native Jonker-Volgenant hostops, which the port does not load. Both return an
optimal assignment, so they agree wherever the optimum is unique.

:func:`hungarian` transliterates ``hungarian_jax``, the solver of the scan
tracker, and returns the same assignment on ties: rows inserted in order,
the first-index ``argmin``, float32 potentials. It loops in Python and is
the plain version of the assignment inside the scan kernel
(``csrc/track_scan.cu``); on a CUDA tensor every loop test is a sync.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize
import torch


def linear_assignment(cost: np.ndarray) -> np.ndarray:
    """Minimization assignment; returns a (K, 2) array of (row, col),
    sorted by row."""
    rows, cols = scipy.optimize.linear_sum_assignment(np.asarray(cost, np.float64))
    return np.stack([rows, cols], axis=1)


def hungarian(cost: torch.Tensor) -> torch.Tensor:
    """Minimizing assignment on a square (n, n) cost -> ``col_of_row``
    int32 (n,). Shortest augmenting paths with row and column potentials:
    each row is inserted by a Dijkstra over reduced costs from a virtual
    column ``n`` until a free column is reached, then the predecessor chain
    is augmented."""
    cost = cost.to(torch.float32)
    n = cost.shape[0]
    dev = cost.device
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    rows = torch.arange(n, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    row_of_col = [-1] * (n + 1)
    for i in range(n):
        row_of_col[n] = i
        minv = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
        way = torch.full((n,), n, dtype=torch.int64, device=dev)
        used = torch.zeros(n, dtype=torch.bool, device=dev)
        j0 = n
        while row_of_col[j0] != -1:
            if j0 < n:
                used[j0] = True
            i0 = row_of_col[j0]
            cur = cost[i0] - u[i0] - v
            better = ~used & (cur < minv)
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0, way)
            masked = torch.where(used, inf, minv)
            j1 = int(torch.argmin(masked))  # the first index of the minimum
            delta = masked[j1]
            # Every used column's owner row gains delta, and so does row i
            # (held by the virtual column); used columns lose delta,
            # unreached ones shrink their minv.
            owners = torch.tensor([row_of_col[j] for j in range(n)], device=dev)
            u = torch.where(torch.isin(rows, owners[used]), u + delta, u)
            u[i] = u[i] + delta
            v = torch.where(used, v - delta, v)
            minv = torch.where(~used, minv - delta, minv)
            j0 = j1
        way_host = way.tolist()
        while j0 != n:  # augment along the predecessor chain
            j1 = way_host[j0]
            row_of_col[j0] = row_of_col[j1]
            j0 = j1
        row_of_col[n] = -1
    col_of_row = torch.zeros(n, dtype=torch.int32, device=dev)
    col_of_row[torch.tensor(row_of_col[:n], device=dev)] = torch.arange(
        n, dtype=torch.int32, device=dev)
    return col_of_row
