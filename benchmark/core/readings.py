"""What the per-layer readers share (``metrics/<name>.py``). Each takes
the run (``run.py::Run``) and returns a number or None where the run holds
nothing to read."""

from __future__ import annotations

import math

from benchmark.core import card
from benchmark.counts.flops import TRAIN_FACTOR, forward_flops


def device_idle_pct(run) -> float | None:
    """The share of the traced window in which no kernel, copy or memset
    ran on the card."""
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def forwarded_frames(frames: int, batch: int) -> int:
    """Frames the forward ran on for a set of ``frames`` in batches of
    ``batch``: a short last batch is padded to the full batch."""
    return math.ceil(frames / batch) * batch


def mfu_pct(run, frames: int, factor: int = 1) -> float | None:
    """Analytic FLOPs of ``frames`` forwards (``factor`` a frame) over the
    window, against the card's bf16 peak."""
    if not frames or run.window_s <= 0:
        return None
    flops = factor * frames * forward_flops(run.config["spec"])
    return 100.0 * flops / run.window_s / card.BF16_FLOPS


def train_mfu_pct(run, images: int) -> float | None:
    return mfu_pct(run, images, TRAIN_FACTOR)


def span_ms_per_call(run, *names, per: str | None = None) -> float | None:
    """The spans ``names`` summed, in ms, over their calls (or over the
    counter ``per``)."""
    spans = run.cell.spans
    if not all(n in spans for n in names):
        return None
    total = sum(spans[n][0] for n in names)
    calls = run.cell.counters.get(per) if per else spans[names[0]][1]
    return 1e3 * total / calls if calls else None


def kernel(run, name: str) -> tuple[float, int] | None:
    """Device seconds and launches of the trace's kernels whose name
    holds ``name``."""
    if run.trace is None:
        return None
    hits = [v for k, v in run.trace["kernels"].items() if name in k]
    launches = sum(v["launches"] for v in hits)
    if not launches:
        return None
    return sum(v["seconds"] for v in hits), launches
