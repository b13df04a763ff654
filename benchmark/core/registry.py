"""Everything of a cell found by name: ``BENCHMARK.json`` names the
workload, its configuration and traffic; the files are

- ``configs/<config>.json`` (as ``BENCHMARK.json``'s ``file`` says),
- ``traffic/<traffic>.json``: the mix's parameters; its ``driver`` names
  the general driver of that family, ``drivers/<driver>.py``,
- ``limits/<workload>.json``: each compared number's limit,
- ``metrics/<metric>.py``: one reader a per-layer metric, with
  ``read(run) -> float | None``.

A later cell, mix or metric is new files and entries; nothing here
changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def mix(name: str) -> dict:
    return load_json(BENCH_DIR / "traffic" / f"{name}.json")


def limits(workload_name: str) -> dict:
    return load_json(BENCH_DIR / "limits" / f"{workload_name}.json")


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py`` (names may hold dots)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def applies(metric: dict, workload_name: str) -> bool:
    return "workloads" not in metric or workload_name in metric["workloads"]


def cell_metrics(bench: dict, workload_name: str, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics (untraced) or per-layer ones (traced)."""
    kind = "per_layer" if traced else "end_to_end"
    return [m for m in bench[kind] if applies(m, workload_name)]
