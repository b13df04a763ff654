"""End-to-end ROM/ACV validation against an analytic ground truth.

Port of the JAX package's ``tools/e2e_acv_check.py``: one body for the CPU
tests and the card. A camera window pans sinusoidally over an annotated
test image (:mod:`.make_demo_video`), which gives the plate's position in
every frame exactly. The whole shipped path (the lite0 checkpoint ->
detection -> the scan tracker -> smoothing -> phase segmentation) runs on
that video, and each concentric rep's ROM and ACV is held against the same
analysis of the analytic trajectory.

- :data:`SCENE_IMAGE` is the JAX tool's pinned scene: the one test image
  with exactly one annotated plate and the lowest noise floor the JAX
  package measured. It is read from :data:`.make_demo_video.DATA`; where
  the reference's test set is absent,
  :func:`vbt_tpu_torch.io.synthetic.write_demo_scene` writes a stand-in
  under that name, and the verdict then describes the stand-in.
- :data:`BUDGET` is 5 % a rep for ROM and ACV. ROM is a path integral of
  the per-frame movement, so the detector's jitter adds to it: the budget
  is a noise floor plus a margin, not an exactness.

On the card the pipeline is bf16 with the NMS kernel K1, and the tracker
the scan kernel K3; ``--device cpu`` runs float32 with the plain versions.

Usage: ``python -m vbt_tpu_torch.tools.e2e_acv_check [--reps 3] [--seconds 9]
[--device cuda] [--out record.json]``, from a directory holding
``reference/data/test/``. Prints a line a rep, then PASS or FAIL against the
budget, and exits 0 or 1 accordingly.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

MODEL = "models/efficientdet_lite0_whole.msgpack"
# The pinned flagship scene: exactly one annotated plate, ample pan range.
SCENE_IMAGE = (
    "Captura-de-Pantalla-2022-07-18-a-las-19-26-59_png"
    ".rf.4128bd7999946b4dc43e908213797f4f.jpg"
)
BUDGET = 0.05  # per-rep ROM and ACV
PLATE_DIAMETER = 0.45


def analytic_phases(traj) -> list:
    """The concentric phases of the analytic trajectory ``traj`` (the dict
    :func:`.make_demo_video.synthesize` returns)."""
    import pandas as pd

    from vbt_tpu_torch.analysis.phase import CONCENTRIC
    from vbt_tpu_torch.cli.plot import analyze_phases, smooth_track_df

    adf = pd.DataFrame(traj).assign(dx=0.0, dy=0.0)[
        ["time", "x", "y", "dx", "dy", "norm_plate_height", "norm_plate_width"]]
    return [p for p in analyze_phases(smooth_track_df(adf), plate_diameter=PLATE_DIAMETER,
                                      engine="host")
            if p.type == CONCENTRIC]


def measured_phases(pipeline, video) -> tuple[int, list]:
    """Track ``video`` with ``pipeline`` and the scan tracker; returns the
    track the plot CLI picks (``max_travel_id``) and its concentric phases."""
    from vbt_tpu_torch.analysis.phase import CONCENTRIC
    from vbt_tpu_torch.cli.plot import analyze_phases, smooth_track_df
    from vbt_tpu_torch.cli.track import track_one
    from vbt_tpu_torch.contract.schema import build_track_df, max_travel_id

    data = track_one(pipeline, video, detection_treshold=0.5, tracker_kind="scan")
    df = build_track_df(data)
    fid = max_travel_id(df)
    phases = analyze_phases(smooth_track_df(df[df["id"] == fid].drop(columns=["id"])),
                            plate_diameter=PLATE_DIAMETER, engine="host")
    return fid, [p for p in phases if p.type == CONCENTRIC]


def compare(truth, measured, reps, budget=BUDGET, verbose=True) -> tuple[bool, list]:
    """Hold each measured rep's ROM and ACV against the analytic one's
    within ``budget``, and both rep counts to ``reps``. Returns (ok,
    per-rep errors)."""
    ok = len(truth) == len(measured) == reps
    if verbose:
        print(f"reps: analytic {len(truth)}, measured {len(measured)} (want {reps})")
    errors = []
    for i, (t, m) in enumerate(zip(truth, measured), 1):
        acv_t, acv_m = t.rom / t.duration, m.rom / m.duration
        rom_err = abs(m.rom - t.rom) / t.rom
        acv_err = abs(acv_m - acv_t) / acv_t
        errors.append({
            "rep": i,
            "rom_true_m": round(float(t.rom), 4),
            "rom_measured_m": round(float(m.rom), 4),
            "rom_err": round(float(rom_err), 4),
            "acv_true_ms": round(float(acv_t), 4),
            "acv_measured_ms": round(float(acv_m), 4),
            "acv_err": round(float(acv_err), 4),
        })
        ok &= rom_err < budget and acv_err < budget
        if verbose:
            print(f"rep {i}: ROM {t.rom:.4f} vs {m.rom:.4f} m ({rom_err * 100:.2f}%)"
                  f"  ACV {acv_t:.4f} vs {acv_m:.4f} m/s ({acv_err * 100:.2f}%)")
    return ok, errors


def run_check(video, traj, reps, budget=BUDGET, pipeline=None, verbose=True):
    """Run the whole shipped path on ``video`` and compare each rep's
    ROM/ACV against the analytic trajectory. ``pipeline`` defaults to the
    shipped lite0 on the card. Returns (ok, per-rep errors)."""
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline

    truth = analytic_phases(traj)
    if pipeline is None:
        pipeline = DetectionPipeline.from_model_arg(MODEL, device="cuda")
    _, measured = measured_phases(pipeline, video)
    return compare(truth, measured, reps, budget, verbose)


def _serving_record(pipeline) -> dict:
    """The lane that was exercised: JAX's keys (``pallas_nms``: whether K1
    served the NMS) and the card's name and power limit."""
    from vbt_tpu_torch.tools._timing import card

    name, limit_w = card(pipeline.device)
    return {
        "platform": "gpu" if pipeline.device.type == "cuda" else pipeline.device.type,
        "dtype": str(pipeline.dtype),
        "pallas_nms": bool(pipeline.use_kernel),
        "device": name,
        "power_limit_w": limit_w,
    }


def synthesize_scene(video, reps, fps, seconds):
    """Render the pinned scene; returns the analytic trajectory."""
    from vbt_tpu_torch.tools.make_demo_video import synthesize

    _, traj, _ = synthesize(video, reps=reps, fps=fps, seconds=seconds, image=SCENE_IMAGE)
    return traj


def run(reps, fps, seconds, model, out, device="cuda") -> int:
    """The body of the CLI: returns its exit code, 0 when every rep is
    within the budget."""
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline
    from vbt_tpu_torch.tools._timing import prepare_device

    dev = prepare_device(device, "e2e_acv_check")
    with tempfile.TemporaryDirectory() as d:
        video = os.path.join(d, "demo.mp4")
        traj = synthesize_scene(video, reps, fps, seconds)
        pipeline = DetectionPipeline.from_model_arg(model, device=dev)
        ok, errors = run_check(video, traj, reps, pipeline=pipeline)
    if out:
        record = {
            "scene": {"image": SCENE_IMAGE, "reps": reps, "fps": fps, "seconds": seconds},
            "model": os.path.basename(model),
            "serving": _serving_record(pipeline),
            "budget": BUDGET,
            "per_rep": errors,
            "pass": bool(ok),
        }
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
        print(f"wrote {out}", file=sys.stderr)
    print(f"PASS (all reps within the {BUDGET:.0%} budget)" if ok else "FAIL")
    return 0 if ok else 1


def make_command():
    """Build the click command (click is imported here, not at import)."""
    import click

    @click.command()
    @click.option("--reps", default=3, type=int)
    @click.option("--fps", default=30.0, type=float)
    @click.option("--seconds", default=9.0, type=float)
    @click.option("--model", default=MODEL, show_default=True)
    @click.option("--out", default=None, help="Write the per-rep record as JSON.")
    @click.option("--device", default="cuda", show_default=True,
                  help="cuda (bf16, kernels K1 and K3) or cpu (float32, plain versions).")
    def command(reps, fps, seconds, model, out, device):
        sys.exit(run(reps, fps, seconds, model, out, device))

    return command


def main(args=None, standalone_mode: bool = True):
    return make_command().main(args=args, standalone_mode=standalone_mode)


if __name__ == "__main__":
    main()
