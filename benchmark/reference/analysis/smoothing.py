"""The plot CLI's smoothing in numpy float64: trailing rolling means,
expanding means and the reference's running average.

Benchmark copy of the port's ``analysis/smoothing.py``: only the parts the
plain reference runs are kept.
"""

from __future__ import annotations

import numpy as np


def rolling_mean_np(x: np.ndarray, window: int) -> np.ndarray:
    """Trailing mean of the last ``window`` samples (of fewer at the start),
    float64."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    padded = np.concatenate([np.zeros(window - 1), x])
    shifted = np.stack([padded[k:k + n] for k in range(window)])
    return shifted.sum(0) / np.minimum(np.arange(1, n + 1), window)


def expanding_mean_np(x: np.ndarray) -> np.ndarray:
    """Mean of every sample so far, float64."""
    x = np.asarray(x, np.float64)
    return np.cumsum(x) / np.arange(1, x.shape[0] + 1)
