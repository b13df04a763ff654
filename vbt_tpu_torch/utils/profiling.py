"""Tracing and profiling, the port of ``vbt_tpu.utils.profiling``:

- :class:`StageTimer`, wall-clock stage accounting for host orchestration
  (decode, detect, tracker, dataframe);
- :func:`span`, a named host-clock span inside a stage, and :func:`to_host`,
  a device-to-host read timed as the span ``<layer>.readback``;
- :func:`trace`, a ``torch.profiler`` trace of the CPU and the card written
  as a TensorBoard-loadable file, the counterpart of ``jax.profiler``'s;
- :func:`launch_counter`, the registry of the kernels' launch counters
  (``nms.launches``, ``fused_mbconv.launches`` and
  ``fused_mbconv.launches_by_variant``, ``int8_matmul.calls``,
  ``track_scan.launches``, ``analysis_scan.launches``): each binding
  registers its own where it is defined, and a CUDA graph's replay adds to
  every registered counter the launches the graph holds
  (:mod:`vbt_tpu_torch.runtime.graphs`).

A span records into the innermost :class:`StageTimer` whose stage is open
around it on the calling thread (a ``contextvars`` variable), so a caller's
timer collects the spans of the code below it without the timer being
passed down; where no stage is open it records into the process-wide timer
(:func:`process_timer`). While a ``torch.profiler`` records, a stage or a
span also opens ``record_function(name)``, so it stands on the trace's own
clock; otherwise it costs two clock reads and a few dict and contextvar
operations. No span synchronizes the card, allocates on it or launches
anything.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field

from torch._C._autograd import _profiler_enabled
from torch.autograd.profiler import record_function

# Durations kept a name (the last calls), so that a reader can take a
# window's own calls and memory stays flat in a long run.
RECENT_CALLS = 4096


@dataclass
class StageTimer:
    """Accumulates wall-clock time per named stage, and the spans recorded
    inside its open stages.

    >>> timer = StageTimer()
    >>> with timer.stage("detect"):
    ...     run_detection()
    >>> timer.report()
    """

    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))
    recent: dict = field(default_factory=lambda: defaultdict(
        lambda: deque(maxlen=RECENT_CALLS)))
    stage_names: set = field(default_factory=set)  # the names opened as stages

    def stage(self, name: str) -> "_Span":
        """Time ``name`` into this timer; spans opened inside record here."""
        self.stage_names.add(name)
        return _Span(name, self)

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1
        self.recent[name].append(seconds)

    def last(self, name: str, n: int) -> list[float]:
        """The durations of the last ``n`` calls of ``name`` (fewer where
        fewer are kept), oldest first."""
        calls = self.recent.get(name, ())
        return list(calls)[-n:] if n > 0 else []

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            total = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name}: {total:.3f}s total, {n} calls, {total / n * 1e3:.1f} ms/call")
        return "\n".join(lines)


_PROCESS = StageTimer()
_CURRENT: contextvars.ContextVar[StageTimer | None] = contextvars.ContextVar(
    "vbt_torch_stage_timer", default=None)


def process_timer() -> StageTimer:
    """The timer of the spans recorded where no stage is open."""
    return _PROCESS


class _Span:
    """A stage of ``timer`` (made the current timer while it is open), or,
    with no timer, a span of the current one."""

    __slots__ = ("name", "timer", "stage", "token", "annotation", "t0")

    def __init__(self, name: str, timer: StageTimer | None = None):
        self.name = name
        self.timer = timer
        self.stage = timer is not None

    def __enter__(self):
        if self.stage:
            self.token = _CURRENT.set(self.timer)
        else:
            self.timer = _CURRENT.get() or _PROCESS
        self.annotation = None
        if _profiler_enabled():
            self.annotation = record_function(self.name)
            self.annotation.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timer.add(self.name, time.perf_counter() - self.t0)
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        if self.stage:
            _CURRENT.reset(self.token)
        return False


def span(name: str) -> _Span:
    """``with span(name): ...`` times the block into the innermost open
    stage's timer, else into :func:`process_timer`."""
    return _Span(name)


# Registered launch counters: name -> (owner, attribute, key of a dict-valued
# attribute or None).
_COUNTERS: dict[str, tuple[object, str, object]] = {}


def launch_counter(owner, attr: str = "launches", keys: tuple = ()) -> None:
    """Register ``owner.<attr>`` as a count of kernel launches and set it to
    0: an int, or with ``keys`` a dict of one int a key. Read by attribute
    as before; :func:`launch_counts` and :func:`add_launches` reach every
    registered counter."""
    setattr(owner, attr, dict.fromkeys(keys, 0) if keys else 0)
    base = f"{owner.__module__}.{owner.__qualname__}.{attr}"
    for key in keys or (None,):
        _COUNTERS[base if key is None else f"{base}[{key}]"] = (owner, attr, key)


def launch_counts() -> dict[str, int]:
    """Every registered counter's value, by name."""
    return {name: getattr(owner, attr) if key is None else getattr(owner, attr)[key]
            for name, (owner, attr, key) in _COUNTERS.items()}


def add_launches(counts: dict[str, int], sign: int = 1) -> None:
    """Add ``sign`` times ``counts`` (named as :func:`launch_counts` names
    them) to the registered counters."""
    for name, n in counts.items():
        owner, attr, key = _COUNTERS[name]
        if key is None:
            setattr(owner, attr, getattr(owner, attr) + sign * n)
        else:
            getattr(owner, attr)[key] += sign * n


def to_host(tensor, layer: str):
    """``tensor`` as a host numpy array, the wait for the card and the copy
    timed as the span ``<layer>.readback``; its call count is the layer's
    count of readbacks."""
    with span(f"{layer}.readback"):
        return tensor.cpu().numpy()


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
