"""Exact linear assignment on the host (scipy).

The host-side ``linear_assignment`` of ``vbt_tpu.tracking.assignment``,
with scipy only: the JAX package prefers its native Jonker-Volgenant
hostops, which the port does not load. Both return an optimal assignment,
so they agree wherever the optimum is unique.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize


def linear_assignment(cost: np.ndarray) -> np.ndarray:
    """Minimization assignment; returns a (K, 2) array of (row, col),
    sorted by row."""
    rows, cols = scipy.optimize.linear_sum_assignment(np.asarray(cost, np.float64))
    return np.stack([rows, cols], axis=1)
