"""Cells held out of ``BENCHMARK.json`` whose files the benchmark keeps:
``held_out.json`` has their entries (workloads, end-to-end and per-layer
metrics) as ``BENCHMARK.json`` had them, so that the tests drive their
driver, mix, limits and readers through the harness as if listed. A cell
comes back by moving its entries into ``BENCHMARK.json``."""

from __future__ import annotations

import json
from pathlib import Path

HELD_OUT = Path(__file__).with_name("held_out.json")


def with_held_out(monkeypatch) -> None:
    """``registry.benchmark()`` with the held-out entries added."""
    from benchmark.core import registry

    real = registry.benchmark

    def benchmark() -> dict:
        bench = real()
        extra = json.loads(HELD_OUT.read_text())
        return dict(bench, **{key: bench[key] + extra.get(key, [])
                              for key in ("workloads", "end_to_end", "per_layer")})

    monkeypatch.setattr(registry, "benchmark", benchmark)
