"""The traced run's device trace and what is read from it.

:class:`DeviceTrace` wraps the measured window in ``torch.profiler`` (CPU
and CUDA activity) and reduces the events once the window has closed:

- ``window_s``: the length of the harness's ``window`` range;
- ``busy_s``: the union of the intervals in which a kernel, a copy or a
  memset ran on the card, inside the window (the device side of the
  ``window`` range itself, a user annotation, is no work);
- ``kernels``: device seconds and launches by kernel name;
- ``breakdown``: the ten device operations that took most time, and the
  ten host operations under which the card idled longest (an idle gap is
  put to the innermost host event that was running when it began, or to
  ``host: no torch op`` where none was).
"""

from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW = "window"
DEVICE_KINDS = ("kernel", "memcpy", "memset", "gpu_")
TOP = 10


def _union(intervals, lo, hi) -> float:
    total, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


class DeviceTrace:
    """``with DeviceTrace(on) as t: ... with t.window(): <measured work>``;
    after the block, :meth:`reduce` gives the readings (None when off)."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def window(self):
        import contextlib

        if self.prof is None:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(WINDOW)

    def reduce(self) -> dict | None:
        if self.prof is None:
            return None
        events = self.prof.profiler.kineto_results.events()
        device, host = [], []
        win = None
        for e in events:
            start = e.start_ns()
            end = start + e.duration_ns()
            name = e.name()
            if str(e.device_type()).endswith("CUDA"):
                if name != WINDOW and not e.is_user_annotation():
                    device.append((start, end, name))
            else:
                if name == WINDOW:
                    win = (start, end)
                host.append((start, end, name))
        if win is None:
            raise RuntimeError("the trace holds no window range")
        lo, hi = win
        device = [d for d in device if d[1] > lo and d[0] < hi]
        busy = _union([(s, e) for s, e, _ in device], lo, hi)
        kernels = defaultdict(lambda: [0.0, 0])
        for s, e, name in device:
            kernels[name][0] += (min(e, hi) - max(s, lo)) / 1e9
            kernels[name][1] += 1
        top_ops = sorted(((n, v[0]) for n, v in kernels.items()), key=lambda x: -x[1])[:TOP]
        gaps = self._gaps(device, host, lo, hi)
        return {"window_s": (hi - lo) / 1e9, "busy_s": busy / 1e9,
                "kernels": {n: {"seconds": v[0], "launches": v[1]} for n, v in kernels.items()},
                "breakdown": {"device_ops": [[n, s] for n, s in top_ops],
                              "idle_gaps": gaps}}

    @staticmethod
    def _gaps(device, host, lo, hi) -> list:
        """Idle seconds of the card by the innermost host event running at
        each gap's start, the ten largest."""
        host = sorted((s, e, n) for s, e, n in host if n != WINDOW and e > lo and s < hi)
        starts = [h[0] for h in host]
        by_name = defaultdict(float)
        cursor = lo
        for s, e, _ in sorted(device) + [(hi, hi, "")]:
            if s > cursor:
                i = bisect.bisect_right(starts, cursor) - 1
                name = "host: no torch op"
                for j in range(i, max(i - 500, -1), -1):
                    if host[j][1] > cursor:
                        name = host[j][2]
                        break
                by_name[name] += (s - cursor) / 1e9
            cursor = max(cursor, e)
        return [[n, v] for n, v in sorted(by_name.items(), key=lambda x: -x[1])[:TOP]]
