"""The readings a limit is set from: a cell's compared numbers over many
seeds in one process, with the program as it serves (the lower reading)
or with a control in its place (the upper reading).

    python benchmark/tools/readings.py --workload lite0.stream --seeds 11,12,13 \
        --seconds 3 [--control int8] [--out chiprun_out/readings.jsonl]

Controls: ``int8`` serves the program's own int8 lane
(``DetectionPipeline.calibrate`` on the first batch of the first set), the
nearest precision below the configuration's bf16; ``tf32`` puts the train
reference computed with TF32 on in the program's place, the precision
below float32 with TF32 off; ``half`` plants a fault in the train step
(half of each batch left out, the mean over the rest); ``k3_bf16``
puts the reference tracker's outputs held in bfloat16 in the place of
K3's float32 ones; ``k4_f32`` puts the reference analysis computed in
float32 in the place of K4's float64 one. Each seed prints one
JSON line: the workload, seed, control and each compared number. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.core import registry  # noqa: E402
from benchmark.core.trace import DeviceTrace  # noqa: E402

def _int8(cell) -> None:
    cell.pipeline_hook = lambda pipe, frames: pipe.calibrate(frames)


def _half_batch(cell) -> None:
    """A fault: the step trains on the first half of each batch, its loss
    the mean over those images."""
    def hook(trainer):
        step = trainer.train_step

        def half(state, batch):
            n = batch["images"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})

        trainer.train_step = half
    cell.trainer_hook = hook


def _tf32_reference(cell) -> None:
    """The control of a float32 step: the reference with TF32 on put in
    the program's place, in both stages (the window's from the program's
    state before its last steps)."""
    def swap():
        cell.record, cell.late_record = cell.reference_records(tf32=True)
    cell.after_window = swap


def _bf16(a):
    import torch

    return torch.from_numpy(np.asarray(a, np.float64)).to(torch.bfloat16).double().numpy()


def _k3_bf16(cell) -> None:
    """The control of K3's float32 outputs: the reference tracker's boxes
    and velocities held in bfloat16, put in the program's place."""
    from benchmark.reference.track import host_tracks, tracks_to_data

    def swap():
        fps = cell.mix["fps"]
        for j, item in enumerate(cell.done):
            k, rows, valid, *rest = item
            tracks = host_tracks(rows, valid)
            tracks.update(box=_bf16(tracks["box"]), dxdy=_bf16(tracks["dxdy"]))
            if cell.mix["driver"] == "track":
                cell.done[j] = (k, rows, valid, tracks_to_data(tracks, fps))
            else:
                cell.done[j] = (k, rows, valid, rest[0], tracks)
    cell.after_window = swap


def _k4_f32(cell) -> None:
    """The control of K4's float64 analysis: the reference analysis of the
    program's own scan outputs computed in float32, put in the program's
    place."""
    from benchmark.drivers import _detect
    from benchmark.reference.track import followed_phases, tracks_to_data

    def swap():
        m = cell.mix
        for j, (k, rows, valid, _, tracks) in enumerate(cell.done):
            data = tracks_to_data(_detect.tracks_numpy(tracks, len(rows)), m["fps"])
            phases = followed_phases(data, m["follow_id"], m["plate_diameter"], flush=True,
                                     dtype=np.float32)
            cell.done[j] = (k, rows, valid, phases, tracks)
    cell.after_window = swap


CONTROLS = {"int8": _int8, "half": _half_batch, "tf32": _tf32_reference, "k3_bf16": _k3_bf16,
            "k4_f32": _k4_f32}


def reading(workload: str, seed: int, seconds: float, control: str | None,
            device: str = "cuda", mix_update: dict | None = None) -> tuple[dict, object]:
    """One seed's compared numbers, and the cell that read them."""
    bench = registry.benchmark()
    wl = registry.workload(bench, workload)
    mix = dict(registry.mix(wl["traffic"]), **(mix_update or {}))
    cell = registry.driver(mix["driver"]).Cell(config=registry.config(bench, wl["config"]),
                                               mix=mix, seed=seed, traced=False, root=ROOT)
    cell.device = device
    if control:
        CONTROLS[control](cell)
    t0 = time.perf_counter()
    cell.setup()
    with DeviceTrace(False) as tracer:
        cell.run_window(seconds, tracer)
    cell.release()
    if getattr(cell, "after_window", None):
        cell.after_window()
    limits = registry.limits(workload)
    checks = cell.check(limits)
    return {"workload": workload, "seed": seed, "control": control, "attempted": cell.attempted,
            "seconds": time.perf_counter() - t0, **{c["name"]: c["value"] for c in checks},
            **({"stages": cell.counters["stages"]} if "stages" in cell.counters else {})}, cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", choices=sorted(CONTROLS), default=None)
    p.add_argument("--out", default=None, help="also append the lines to this file")
    p.add_argument("--dump", default=None,
                   help="directory for each seed's first three rows of each side (.npz)")
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers, cell = reading(args.workload, seed, args.seconds, args.control)
        line = json.dumps(numbers)
        print(line, flush=True)
        top = cell.counters.get("top_rows")
        if args.dump and top is not None:
            Path(args.dump).mkdir(parents=True, exist_ok=True)
            np.savez(Path(args.dump) / f"{args.workload}_{seed}_{args.control}.npz",
                     prog=np.concatenate([p for p, _ in top]),
                     ref=np.concatenate([r for _, r in top]))
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
