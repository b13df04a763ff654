"""A synthetic lifting scene in numpy, made from a seed.

A dark bumper-plate-like disc (rim, inner ring, bright hub) on a bar moves
vertically over a blocky textured background. The shipped lite0 detector
finds the disc with a high score, so the scene drives detection and
tracking end to end without video files or OpenCV: ``chip_smoke.py`` feeds
its frames straight to the pipeline, and the tests write them to a video.
"""

from __future__ import annotations

import numpy as np


def plate_frames(n: int, height: int, width: int, seed: int = 0,
                 period: int = 32) -> np.ndarray:
    """``n`` uint8 RGB frames (n, height, width, 3); the disc's center
    moves as ``0.5 + 0.15 sin(2 pi t / period)`` of the height."""
    rng = np.random.default_rng(seed)
    cell = max(1, height // 30)
    bg = rng.integers(90, 170, size=(-(-height // cell), -(-width // cell), 3), dtype=np.uint8)
    bg = np.repeat(np.repeat(bg, cell, 0), cell, 1)[:height, :width]
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    r = 0.3 * height
    ring = max(1.0, height / 240)
    out = np.empty((n, height, width, 3), np.uint8)
    for t in range(n):
        cy = height * (0.5 + 0.15 * np.sin(2 * np.pi * t / period))
        cx = width / 2
        img = bg.copy()
        img[np.abs(yy - cy) <= height / 80] = 200  # the bar
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        img[d <= r] = 20
        img[d <= 0.55 * r] = 40
        img[np.abs(d - 0.55 * r) <= ring] = 90
        img[d <= 0.12 * r] = 220
        out[t] = img
    return out
