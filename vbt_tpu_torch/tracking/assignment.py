"""Exact linear assignment: the host solver and :func:`hungarian`.

:func:`linear_assignment` is the host-side solver of
``vbt_tpu.tracking.assignment``: a numpy float64 transliteration of the
native Jonker-Volgenant solver the JAX package builds
(``vbt_tpu/native/csrc/hostops.cpp::jv_solve``), with its transpose for
more rows than columns and the stable sort by row. It makes the same
choices on ties as that solver (the first column of the smallest reduced
cost, rows inserted in order), so the host OC-SORT matches JAX's id for id
where several assignments are optimal. The column loop of each Dijkstra
step is vectorised; the arithmetic is the C++ loop's, element by element.

:func:`hungarian` transliterates ``hungarian_jax``, the solver of the scan
tracker, and returns the same assignment on ties: rows inserted in order,
the first-index ``argmin``, float32 potentials. It loops in Python and is
the plain version of the assignment inside the scan kernel
(``csrc/track_scan.cu``); on a CUDA tensor every loop test is a sync.
"""

from __future__ import annotations

import numpy as np
import torch


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
