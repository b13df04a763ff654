"""Tracing and profiling, the port of ``vbt_tpu.utils.profiling``:

- :class:`StageTimer`, wall-clock stage accounting for host orchestration
  (decode, detect, tracker, dataframe);
- :func:`trace`, a ``torch.profiler`` trace of the CPU and the card written
  as a TensorBoard-loadable file, the counterpart of ``jax.profiler``'s.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class StageTimer:
    """Accumulates wall-clock time per named stage.

    >>> timer = StageTimer()
    >>> with timer.stage("detect"):
    ...     run_detection()
    >>> timer.report()
    """

    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            total = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name}: {total:.3f}s total, {n} calls, {total / n * 1e3:.1f} ms/call")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Record the CPU and, where there is a card, its CUDA activity inside
    the block with ``torch.profiler`` and write the trace into ``log_dir``
    (``torch.profiler.tensorboard_trace_handler``: one
    ``<worker>.<time>.pt.trace.json`` that TensorBoard's profiler plugin and
    ``chrome://tracing`` open); no-op without a directory."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
