"""The marginal-rate timing of the bench and the measurement tools.

One copy of the method the JAX package repeats in ``bench.py:41-95``,
``tools/perf_probe.py:27``, ``tools/int8_profile.py:41``,
``tools/turbo_check.py:54`` and ``tools/prefilter_check.py:60``:

- a timed region runs ``fn(i)`` for ``i`` in ``range(n)`` and ends with a
  host readback of a value of the last call's output (on the card that
  readback is also the synchronisation: the work runs in stream order), on
  ``time.perf_counter``, so it measures what a user waits for, host
  included;
- a trial is ``(run(N_LONG) - run(N_SHORT)) / (N_LONG - N_SHORT)``, which
  cancels the fixed cost of the readback;
- a non-positive trial (a stall that landed inside the short run) is
  discarded; the median of the rest is the headline and their minimum
  ``best``; if none is left, :func:`marginal_seconds` raises
  ``RuntimeError`` carrying ``raw_trials``.

The counts are read when a function is called, so a test may set them.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

N_SHORT = 8
N_LONG = 40
TRIALS = 3


class Marginal(NamedTuple):
    median_s: float  # seconds a call, the headline
    best_s: float  # the fastest positive trial
    raw_trials: list  # every trial's seconds a call, discarded ones included


def readback(out) -> float:
    """The first element of the first tensor of ``out`` (a tensor, or a
    tuple, named tuple or dict of them) as a Python float."""
    while not isinstance(out, torch.Tensor):
        out = next(iter(out.values())) if isinstance(out, dict) else out[0]
    return float(out.reshape(-1)[0].item())


def timed_run(fn: Callable[[int], object], n: int) -> float:
    """Seconds for ``fn(0) ... fn(n - 1)`` and a readback of the last output."""
    t0 = time.perf_counter()
    out = None
    for i in range(n):
        out = fn(i)
    readback(out)
    return time.perf_counter() - t0


def marginal_seconds(fn: Callable[[int], object], n_short: int | None = None,
                     n_long: int | None = None, trials: int | None = None) -> Marginal:
    """The marginal seconds a call of ``fn(i)`` by :data:`TRIALS` short/long
    pairs (module docstring). Warm ``fn`` up first."""
    n_short = N_SHORT if n_short is None else n_short
    n_long = N_LONG if n_long is None else n_long
    trials = TRIALS if trials is None else trials
    raw = []
    for _ in range(trials):
        t_short = timed_run(fn, n_short)
        t_long = timed_run(fn, n_long)
        raw.append((t_long - t_short) / (n_long - n_short))
    rates = [r for r in raw if r > 0]
    if not rates:
        exc = RuntimeError("benchmark invalid: no positive marginal-rate trial survived "
                           "(a stall in every trial's short run); rerun on an idle card")
        exc.raw_trials = raw
        raise exc
    return Marginal(float(np.median(rates)), min(rates), raw)


def marginal_ms(fn: Callable[[int], object], warmup: int = 2, **kw) -> float:
    """Median marginal milliseconds a call, after ``warmup`` calls."""
    timed_run(fn, warmup)
    return marginal_seconds(fn, **kw).median_s * 1e3


def prepare_device(device, context: str) -> torch.device:
    """``device`` resolved (a missing card raises), probed by the health
    probe under ``context``, with the kernel build cache on."""
    from vbt_tpu_torch.utils.cache import enable_persistent_cache
    from vbt_tpu_torch.utils.device import resolve_device
    from vbt_tpu_torch.utils.health import require_healthy_device

    dev = resolve_device(device)
    require_healthy_device(dev, context=context)
    enable_persistent_cache()
    return dev


def card(device: torch.device) -> tuple[str, float | None]:
    """(name, power limit in W) of the card ``device`` as ``nvidia-smi
    --query-gpu=name,power.limit`` reports them; ``("cpu", None)`` for the
    CPU."""
    if device.type != "cuda":
        return "cpu", None
    out = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=name,power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), float(limit)
