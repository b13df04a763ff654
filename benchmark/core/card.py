"""The card a run uses: the refusal without one, its name, power limit and
clocks, and the peaks every share is stated against.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W power limit.
A card set below 700 W runs slower under load; every run prints its limit.
"""

from __future__ import annotations

import subprocess
import sys

BF16_FLOPS = 989e12  # tensor cores, bf16 in, f32 accumulate
TF32_FLOPS = 495e12
F32_FLOPS = 67e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

SMI_FIELDS = "name,power.limit,power.draw,clocks.sm,clocks.mem,clocks.max.sm,temperature.gpu"


def require_cards(count: int) -> None:
    """Exit 3 (no result line) unless CUDA has at least ``count`` cards."""
    import torch

    if not torch.cuda.is_available():
        print("benchmark: torch.cuda.is_available() is false; this benchmark measures the card "
              "and does not run without one", file=sys.stderr)
        sys.exit(3)
    have = torch.cuda.device_count()
    if have < count:
        print(f"benchmark: the cell asks for {count} cards, torch sees {have}", file=sys.stderr)
        sys.exit(3)


def smi(index: int = 0) -> str:
    """nvidia-smi's reading of the card: name, power limit and draw, clocks,
    temperature ("" where nvidia-smi is absent)."""
    try:
        out = subprocess.run(["nvidia-smi", f"--id={index}", f"--query-gpu={SMI_FIELDS}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def print_card(when: str, index: int = 0) -> None:
    """One line on standard error: the card's reading ``when`` (before or
    after the window), with its field names, and the host's load average."""
    import os

    print(f"card {when}: [{SMI_FIELDS}] {smi(index) or 'nvidia-smi gave nothing'}; host load "
          f"average {' '.join(f'{x:.2f}' for x in os.getloadavg())} on {os.cpu_count()} CPUs",
          file=sys.stderr, flush=True)


def host_counters() -> dict:
    """The host's CPU time stolen by other guests of its machine (all CPUs,
    from /proc/stat; absent where the kernel does not count it), this
    process's CPU time and the clock, for :func:`print_host`."""
    import os
    import time

    steal = None
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        steal = int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    t = os.times()
    return {"steal_s": steal, "cpu_s": t.user + t.system, "wall_s": time.perf_counter()}


def print_host(when: str, before: dict) -> None:
    """One line on standard error: what the host did since ``before``."""
    import os

    now = host_counters()
    wall = now["wall_s"] - before["wall_s"]
    steal = ("not counted" if now["steal_s"] is None or before["steal_s"] is None else
             f"{now['steal_s'] - before['steal_s']:.2f} s stolen of {os.cpu_count()} CPUs")
    print(f"host {when}: {wall:.3f} s, this process's CPU {now['cpu_s'] - before['cpu_s']:.3f} s,"
          f" {steal}", file=sys.stderr, flush=True)


def device_record(count: int) -> dict:
    """The result line's ``device``: platform, the card's name, the cards
    used and the peak memory of the fullest one."""
    import torch

    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak)}
