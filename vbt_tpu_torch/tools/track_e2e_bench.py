"""The track path's wall time from a video file to the dataframe, decode included.

Port of the JAX package's ``tools/track_e2e_bench.py``. The detect bench
measures frames/s of batched detection; what a user of the track CLI waits
for is host video decode -> batched detection on the card -> the scan
tracker -> the dataframe. This tool times that whole path with
``cli/track.py::track_one`` on the demo video of :mod:`.e2e_acv_check`
(:data:`~.e2e_acv_check.SCENE_IMAGE` of :data:`.make_demo_video.DATA`),
and splits it:

- a warm pass first, so the recorded pass finds the kernels built and the
  staging buffers allocated;
- a decode-only pass over the same video with ``VideoReader``: the host's
  floor of the ``decode+detect`` stage, which overlaps decode with the
  card's work by design (``collect_detections``);
- the recorded pass, timed stage by stage with a ``StageTimer``; the card's
  share of the overlapped stage is bounded by ``decode+detect`` less the
  decode-only time.

The record has the JAX tool's keys plus the card's name (``device``) and
power limit (``power_limit_w``). It is printed and written to
:data:`OUT`, relative to the working directory.

Usage: ``python -m vbt_tpu_torch.tools.track_e2e_bench [--seconds 60]
[--device cuda]``, from a directory holding ``reference/data/test/``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

OUT = "out/track_e2e_last.json"


def run(seconds=60.0, fps=30.0, reps=20, batch_size=128,
        model="models/efficientdet_lite0_whole.msgpack", device="cuda") -> dict:
    """Measure, print and write the record; returns it."""
    from vbt_tpu_torch.cli.track import track_one
    from vbt_tpu_torch.io.video import VideoReader
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline
    from vbt_tpu_torch.tools import _timing
    from vbt_tpu_torch.tools.e2e_acv_check import SCENE_IMAGE, synthesize_scene
    from vbt_tpu_torch.tools.make_demo_video import DATA
    from vbt_tpu_torch.utils.profiling import StageTimer

    dev = _timing.prepare_device(device, "track_e2e_bench")
    pipeline = DetectionPipeline.from_model_arg(model, device=dev)

    with tempfile.TemporaryDirectory() as d:
        video = os.path.join(d, "demo.mp4")
        synthesize_scene(video, reps=reps, fps=fps, seconds=seconds)

        # Warm pass: the kernels' first launches and the staging buffers.
        track_one(pipeline, video, detection_treshold=0.5, tracker_kind="scan",
                  batch_size=batch_size, timer=StageTimer())

        # Decode-only pass: the host's floor of the overlapped stage.
        t0 = time.perf_counter()
        n_frames = 0
        reader = VideoReader(video, batch_size=batch_size)
        for _, frame_valid, _ in reader:
            n_frames += int(frame_valid.sum())
        decode_s = time.perf_counter() - t0
        resolution = f"{reader.meta.width}x{reader.meta.height}"

        timer = StageTimer()
        t0 = time.perf_counter()
        data = track_one(pipeline, video, detection_treshold=0.5, tracker_kind="scan",
                         batch_size=batch_size, timer=timer)
        total_s = time.perf_counter() - t0

    name, limit_w = _timing.card(dev)
    stages = {stage: round(s, 4) for stage, s in timer.totals.items()
              if stage in timer.stage_names}
    dd = stages.get("decode+detect", float("nan"))
    record = {
        "video": {"seconds": seconds, "fps": fps, "frames": n_frames,
                  "resolution": resolution, "scene": os.path.join(DATA, SCENE_IMAGE)},
        "batch_size": batch_size,
        "model": os.path.basename(model),
        "wall_s": round(total_s, 4),
        "e2e_fps": round(n_frames / total_s, 1),
        "stages_s": stages,
        "decode_only_s": round(decode_s, 4),
        "decode_only_fps": round(n_frames / decode_s, 1),
        "device_share_of_overlap_s": round(max(0.0, dd - decode_s), 4),
        "df_rows": len(data["id"]),
        "note": ("decode+detect overlaps host decode with the card's work; "
                 "decode_only_s is the host floor measured separately"),
        "device": name,
        "power_limit_w": limit_w,
    }
    print(json.dumps(record, indent=1))
    os.makedirs(os.path.dirname(os.path.abspath(OUT)), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"wrote {OUT}", file=sys.stderr)
    return record


def make_command():
    """Build the click command (click is imported here, not at import)."""
    import click

    @click.command()
    @click.option("--seconds", default=60.0, type=float, show_default=True)
    @click.option("--fps", default=30.0, type=float, show_default=True)
    @click.option("--reps", default=20, type=int, show_default=True)
    @click.option("--batch_size", default=128, type=int, show_default=True)
    @click.option("--model", default="models/efficientdet_lite0_whole.msgpack",
                  show_default=True)
    @click.option("--device", default="cuda", show_default=True,
                  help="cuda (bf16, kernels K1 and K3) or cpu (float32, plain versions).")
    def command(seconds, fps, reps, batch_size, model, device):
        return run(seconds, fps, reps, batch_size, model, device)

    return command


def main(args=None, standalone_mode: bool = True):
    return make_command().main(args=args, standalone_mode=standalone_mode)


if __name__ == "__main__":
    main()
