"""A cell's end-to-end metric over many windows after one set-up, to see
how a window's reading spreads at a given length without paying a set-up
for each (the benchmark's own runs are separate processes); for a stream
cell, also the sweep of chunk rates its ``rate`` is fixed from.

    python benchmark/tools/windows.py --workload lite0.stream --seed 7 \
        --seconds 20 --windows 12
    python benchmark/tools/windows.py --workload lite0.stream --seed 7 \
        --seconds 10 --windows 1 --rate 0 --fractions 0.6,0.8,0.9,1.0,1.1

Each window prints one JSON line: its index, the chunk rate, its length
and the cell's end-to-end metric; a stream window adds the chunks a
second, the 50th and 95th percentile latency and how late the last chunk
started against its schedule (a backlog that grows all through the window
means the rate is beyond what the program sustains). ``--rate``
overrides a stream mix's rate for the ``--windows`` windows (0: a closed
loop, chunks back to back); then ``--fractions`` runs one window at each
fraction of the last one's chunks a second, or ``--rates`` at each fixed
rate. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.core import registry  # noqa: E402
from benchmark.core.trace import DeviceTrace  # noqa: E402


def window(cell, seconds: float, index: int) -> dict:
    with DeviceTrace(False) as tracer:
        e2e = cell.run_window(seconds, tracer)
    line = {"window": index, "rate": getattr(cell, "rate", None), "window_s": cell.window_s,
            **e2e}
    if cell.counters.get("latencies"):
        lat = np.asarray(cell.counters["latencies"]) * 1e3
        late = np.asarray(cell.counters["late"] or [0.0]) * 1e3
        line.update(chunks_per_s=len(lat) / cell.window_s, p50_ms=float(np.percentile(lat, 50)),
                    p95_ms=float(np.percentile(lat, 95)), late_last_ms=float(late[-1]),
                    late_max_ms=float(late.max()))
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--windows", type=int, default=12)
    p.add_argument("--rate", type=float, default=None)
    p.add_argument("--fractions", default=None,
                   help="then one window at each of these fractions of the last chunks a second")
    p.add_argument("--rates", default=None, help="then one window at each fixed rate (chunks/s)")
    args = p.parse_args(argv)
    bench = registry.benchmark()
    wl = registry.workload(bench, args.workload)
    mix = registry.mix(wl["traffic"])
    cell = registry.driver(mix["driver"]).Cell(config=registry.config(bench, wl["config"]),
                                               mix=mix, seed=args.seed, traced=False, root=ROOT)
    cell.setup()
    if args.rate is not None:
        cell.rate = args.rate or None
    line = {}
    for i in range(args.windows):
        line = window(cell, args.seconds, i)
        print(json.dumps({"workload": args.workload, **line}), flush=True)
    rates = ([float(x) for x in args.rates.split(",")] if args.rates else
             [float(f) * line["chunks_per_s"] for f in args.fractions.split(",")]
             if args.fractions else [])
    for j, rate in enumerate(rates):
        cell.rate = rate
        print(json.dumps({"workload": args.workload, **window(cell, args.seconds,
                                                              args.windows + j)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
