"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

One process: set-up (load, build, write the cell's traffic from the seed,
warm up every shape the traffic uses), the measured window of
``--seconds``, then the check of what the window produced against the
plain reference (``benchmark/reference``). The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines of
standard error). Everything of a cell is found by name
(``benchmark/core/registry.py``). Without a card, with fewer cards than
the cell asks for, or with a module of JAX or of the JAX package loaded
once the window has closed, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.core import card, registry  # noqa: E402
from benchmark.core.modules import forbidden_loaded  # noqa: E402
from benchmark.core.trace import DeviceTrace  # noqa: E402


class Run:
    """What a metric reader reads: the cell (its spans, counters and
    sizes), the reduced trace, the configuration and the window."""

    def __init__(self, cell, trace: dict | None, config: dict, window_s: float):
        self.cell = cell
        self.trace = trace
        self.config = config
        self.window_s = window_s


def finite(value) -> float:
    """A compared number as JSON can hold it: a missing or mismatched
    answer (inf or nan) reads 1e300, above every limit."""
    value = float(value)
    return value if math.isfinite(value) else 1e300


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(correct, attempted, failed, metrics, device, breakdown, checks) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def main(argv=None) -> int:
    args = parse(argv)
    os.chdir(ROOT)
    bench = registry.benchmark()
    wl = registry.workload(bench, args.workload)
    config = registry.config(bench, wl["config"])
    mix = registry.mix(wl["traffic"])
    limits = registry.limits(wl["name"])
    card.require_cards(wl["chips"])
    card.print_card("at start")
    cell = registry.driver(mix["driver"]).Cell(config=config, mix=mix, seed=args.seed,
                                               traced=bool(args.trace), root=ROOT)
    cell.setup()
    setup_s = time.perf_counter() - T_START
    print(f"set-up {setup_s:.3f} s", file=sys.stderr, flush=True)
    host = card.host_counters()
    with DeviceTrace(bool(args.trace)) as tracer:
        e2e = cell.run_window(args.seconds, tracer)
    card.print_host("over the window", host)
    card.print_card("after the window")
    device = card.device_record(wl["chips"])
    trace = tracer.reduce()
    tracer.prof = None
    window_s = cell.window_s
    cell.release()
    checks = [dict(c, value=finite(c["value"])) for c in cell.check(limits)]

    metrics = {}
    for m in registry.cell_metrics(bench, wl["name"], bool(args.trace)):
        if args.trace:
            value = registry.metric_reader(m["name"])(Run(cell, trace, config, window_s))
        else:
            value = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    breakdown = None
    if trace is not None:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        breakdown = trace["breakdown"]

    loaded = forbidden_loaded()
    if loaded:
        print(f"benchmark: modules of JAX or of the JAX package are loaded: {loaded}",
              file=sys.stderr)
        return 4
    correct = all(c["value"] <= c["limit"] for c in checks)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} against the limit {c['limit']!r} "
              f"({'ok' if c['value'] <= c['limit'] else 'FAILS'})", file=sys.stderr)
    print(result_line(correct, cell.attempted, cell.failed, metrics, device, breakdown,
                      checks), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
