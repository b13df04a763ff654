"""Exact linear assignment on the host: a Jonker-Volgenant shortest
augmenting path solver over a square padded cost matrix.

Benchmark copy of the port's ``tracking/assignment.py``: only the parts
the plain reference runs are kept.
"""

from __future__ import annotations

import numpy as np


def _jv_solve(cost: np.ndarray) -> np.ndarray:
    """Shortest augmenting paths on an (n, m) float64 cost, n <= m ->
    ``col_of_row`` (n,). Column ``m`` is the virtual column that holds the
    row being inserted."""
    n, m = cost.shape
    u = np.zeros(n + 1)
    v = np.zeros(m + 1)
    p = np.full(m + 1, -1)  # p[j] = the row matched to column j
    way = np.zeros(m + 1, dtype=np.int64)
    for i in range(n):
        p[m] = i
        j0 = m
        minv = np.full(m + 1, np.inf)
        used = np.zeros(m + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            free = ~used[:m]
            cur = cost[i0] - u[i0] - v[:m]
            better = free & (cur < minv[:m])
            minv[:m] = np.where(better, cur, minv[:m])
            way[:m] = np.where(better, j0, way[:m])
            masked = np.where(free, minv[:m], np.inf)
            j1 = int(np.argmin(masked))  # the first column of the minimum
            delta = masked[j1]
            if not delta < np.inf:
                raise ValueError("no finite assignment: a row has no finite cost left")
            owners = p[used]
            u[owners[owners >= 0]] += delta  # distinct rows: one add each
            v[used] -= delta
            minv[~used] -= delta
            j0 = j1
            if p[j0] == -1:
                break
        while j0 != m:  # augment along the predecessor chain
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
        p[m] = -1
    col_of_row = np.full(n, -1)
    cols = np.nonzero(p[:m] >= 0)[0]
    col_of_row[p[cols]] = cols
    return col_of_row


def linear_assignment(cost: np.ndarray) -> np.ndarray:
    """Minimization assignment; returns a (K, 2) array of (row, col),
    sorted by row. With more rows than columns the transposed problem is
    solved, as the JAX package does."""
    cost = np.asarray(cost, np.float64)
    n, m = cost.shape
    if n <= m:
        return np.stack([np.arange(n), _jv_solve(cost)], axis=1)
    rows = _jv_solve(np.ascontiguousarray(cost.T))
    pairs = np.stack([rows, np.arange(m)], axis=1)
    return pairs[np.argsort(pairs[:, 0], kind="stable")]
