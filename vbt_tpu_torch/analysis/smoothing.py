"""Smoothing primitives matching the reference's pandas semantics.

Port of ``vbt_tpu.analysis.smoothing``. The reference smooths with pandas:
``rolling(window=5, min_periods=1).mean()`` on x, y, dx, dy and
``expanding(min_periods=1).mean()`` on the plate dimensions (plot.py:90-95),
and the VelocityTracker smooths plate dimensions with a 30-sample running
average whose single shared instance sees widths and heights *interleaved*
(VelocityTracker.py:44-45, 98-99, the "shared RunningAverage" quirk).

:func:`rolling_mean`, :func:`expanding_mean` and
:func:`shared_plate_average` take torch tensors and run on their device;
the ``*_np`` forms are numpy float64 for the host lane (no pandas needed).
"""

from __future__ import annotations

import numpy as np
import torch


def rolling_mean(x: torch.Tensor, window: int) -> torch.Tensor:
    """Trailing rolling mean with min_periods=1 (pandas ``rolling(w).mean()``):
    out[i] = mean(x[max(0, i-window+1) : i+1]), as a sum of shifted copies
    (a cumulative-sum difference would lose precision over long series)."""
    n = x.shape[0]
    padded = torch.cat([x.new_zeros(window - 1), x])
    shifted = torch.stack([padded[k:k + n] for k in range(window)])
    counts = torch.clamp(torch.arange(1, n + 1, device=x.device), max=window).to(x.dtype)
    return shifted.sum(0) / counts


def expanding_mean(x: torch.Tensor) -> torch.Tensor:
    """Expanding mean with min_periods=1 (pandas ``expanding().mean()``)."""
    counts = torch.arange(1, x.shape[0] + 1, dtype=x.dtype, device=x.device)
    return torch.cumsum(x, 0) / counts


def shared_plate_average(widths: torch.Tensor, heights: torch.Tensor,
                         window: int = 30) -> tuple[torch.Tensor, torch.Tensor]:
    """Vectorized :func:`shared_plate_average_np`."""
    inter = torch.stack([widths, heights], dim=1).reshape(-1)
    smoothed = rolling_mean(inter, window)
    return smoothed[0::2], smoothed[1::2]


def rolling_mean_np(x: np.ndarray, window: int) -> np.ndarray:
    """:func:`rolling_mean` in numpy float64."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    padded = np.concatenate([np.zeros(window - 1), x])
    shifted = np.stack([padded[k:k + n] for k in range(window)])
    return shifted.sum(0) / np.minimum(np.arange(1, n + 1), window)


def expanding_mean_np(x: np.ndarray) -> np.ndarray:
    """:func:`expanding_mean` in numpy float64."""
    x = np.asarray(x, np.float64)
    return np.cumsum(x) / np.arange(1, x.shape[0] + 1)


def running_average_np(x: np.ndarray, window: int) -> np.ndarray:
    """Exact sliding-total running average (host lane): a running ``total``
    accumulates adds and subtracts in stream order, as the reference's
    RunningAverage does (RunningAverage.py:15-27)."""
    out = np.empty_like(x, dtype=np.float64)
    buf = np.empty(window, dtype=np.float64)
    total = 0.0
    count = 0
    head = 0
    for i, v in enumerate(np.asarray(x, dtype=np.float64)):
        buf[(head + count) % window] = v
        total += v
        count += 1
        if count >= window:
            out[i] = total / window
            total -= buf[head]
            head = (head + 1) % window
            count -= 1
        else:
            out[i] = total / count
    return out


def shared_plate_average_np(widths: np.ndarray, heights: np.ndarray,
                            window: int = 30) -> tuple[np.ndarray, np.ndarray]:
    """Width/height running averages through one shared window (host lane):
    each output is a mean over the interleaved [w0, h0, w1, h1, ...] stream."""
    inter = np.empty(2 * len(widths), dtype=np.float64)
    inter[0::2] = widths
    inter[1::2] = heights
    smoothed = running_average_np(inter, window)
    return smoothed[0::2], smoothed[1::2]
