"""Operations and bytes of the program's CUDA kernels, from their inputs'
shapes and what the inputs need; a roofline share is the least time the
card could take (the larger of operations over the peak rate and bytes
over the HBM rate, ``core/card.py``) over the measured time of a launch.

Each input byte is read once and each output byte written once; the
operations are float32 outside the tensor cores (both kernels are scalar
code). Counts as ``chip_smoke.py`` made them for the kernel table.
"""

from __future__ import annotations

from benchmark.core import card

NMS_CANDIDATES = 512  # K1's prefilter width
DETECTIONS = 25
TRACK_SLOTS = 16


def bound_s(n_bytes: float, n_ops: float, ops_per_s: float = card.F32_FLOPS) -> float:
    return max(n_bytes / card.HBM_BYTES_PER_S, n_ops / ops_per_s)


def nms_work(batch: int, selected: float, k: int = NMS_CANDIDATES, d: int = DETECTIONS):
    """K1 over ``batch`` images of ``k`` candidates that select ``selected``
    boxes in all: reads the scores and boxes, writes counts, scores and
    boxes; a sigmoid and an area per candidate (7 operations), and per
    selecting round the argmax compare and the IoU test of every candidate
    (14). Returns (bytes, operations)."""
    n_bytes = (batch * k + batch * k * 4) * 4 + batch * 4 + batch * d * 4 * 5
    return n_bytes, batch * k * 7 + selected * k * 14


def track_scan_work(clips: int, frames: int, valid: float, reported: float,
                    d: int = DETECTIONS, s: int = TRACK_SLOTS):
    """K3 over ``clips`` x ``frames``: detections (6 float32) and masks read
    once, every output written once; per frame the predict of every slot
    (about 150 operations), the affinity of every valid detection against
    every slot (about 60), the update of every reported slot (about 750).
    The Hungarian's share is left out, so the bound is low. Returns
    (bytes, operations)."""
    n_bytes = clips * frames * d * 6 * 4 + clips * frames * d + clips * frames * s * 37
    return n_bytes, clips * frames * s * 150 + valid * s * 60 + reported * 750
