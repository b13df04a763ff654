"""Drive the benchmark on the CPU: the harness's look for a card skipped,
the program's CPU lane in its place, traffic cut to a few small frames.
Nothing here imports JAX."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Small stand-ins of each mix: the same generators and drivers, sizes a
# test run can hold.
TINY = {
    "track": dict(frames=48, height=180, width=320, batch=16, reps_min=2, reps_max=3),
    "stream": dict(frames=48, height=180, width=320, chunk=16, reps_min=2, reps_max=3),
    "train": dict(images=8, images_per_set=4, set_frames=60, height=180, width=320, batch=4,
                  epochs=4),
}


@pytest.fixture(autouse=True)
def held_out_cells(monkeypatch):
    """The held-out cells (``held_out.json``) resolve as if listed."""
    from benchmark.tests.held_out import with_held_out

    with_held_out(monkeypatch)


@pytest.fixture
def cpu_run(monkeypatch, capsys):
    """``cpu_run(workload, seed, trace) -> (rc, result line or None, stderr)``:
    ``benchmark/run.py``'s main on the CPU at the tiny sizes."""
    import torch

    from benchmark import run as run_mod
    from benchmark.core import card, registry
    from benchmark.core.modules import forbidden_loaded

    torch.set_num_threads(4)
    before = set(sys.modules)
    real_mix = registry.mix

    def tiny_mix(name):
        mix = real_mix(name)
        return dict(mix, **TINY[mix["driver"]])

    monkeypatch.setattr(registry, "mix", tiny_mix)
    monkeypatch.setattr(card, "require_cards", lambda count: None)
    monkeypatch.setattr(card, "print_card", lambda *a, **k: None)
    monkeypatch.setattr(card, "device_record", lambda count: {
        "platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0})
    for fam in ("track", "stream", "train"):
        monkeypatch.setattr(registry.driver(fam).Cell, "device", "cpu")
    # Only what the run itself loads counts (pytest's plugins may load more).
    monkeypatch.setattr(run_mod, "forbidden_loaded", lambda: [
        m for m in forbidden_loaded() if m not in before])

    def go(workload: str, seed: int = 2**31 + 5, trace: int = 0, seconds: float = 1.0):
        rc = run_mod.main(["--workload", workload, "--seed", str(seed), "--seconds",
                           str(seconds), "--trace", str(trace)])
        out, err = capsys.readouterr()
        lines = out.strip().splitlines()
        result = json.loads(lines[-1]) if rc == 0 and lines else None
        return rc, result, err

    return go
