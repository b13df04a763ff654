"""Wall-clock stage accounting for host orchestration (decode, detect,
tracker, dataframe). Copy of ``vbt_tpu.utils.profiling.StageTimer``."""

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
