"""Live streaming session: video in, per-rep ROM / ACV out as reps end.

Port of ``vbt_tpu.cli.stream`` with the same options, names and defaults.
Chunks of frames are decoded into the pipeline's pinned staging buffers,
detected (kernel K1 on the card), tracked with the tracker state carried
from chunk to chunk (kernel K3) and analysed with both analysis carries
carried (kernel K4) by :class:`~vbt_tpu_torch.runtime.streaming.StreamingPipeline`;
each repetition's metrics print the moment its concentric phase completes.

The phase filter is retroactive (a later, larger rep can retire an earlier
candidate), so live lines are provisional: a retired rep is announced, and
the final summary is the offline phase list of the whole set.

Before it serves a model on the card, the session selects the kernel build
cache and probes the card in a deadlined subprocess
(:mod:`vbt_tpu_torch.utils.cache`, :mod:`vbt_tpu_torch.utils.health`), as
the JAX CLI does before its session.

Usage: ``python -m vbt_tpu_torch.cli.stream video.mp4`` (or a camera index
such as ``0``).
"""

from __future__ import annotations

import sys

from vbt_tpu_torch.analysis.phase import CONCENTRIC


def _fmt_rep(i: int, phase) -> str:
    # Two decimals, as the plot CLI's figure labels.
    acv = phase.rom / phase.duration
    return (
        f"rep {i}: t=[{phase.time_start:.2f}s, {phase.time_end:.2f}s] "
        f"ROM {phase.rom:0.2f} m  ACV {acv:0.2f} m/s"
    )


def run_stream(src, model: str, detection_threshold: float, chunk_size: int,
               plate_diameter: float, follow_id: int, out=sys.stdout,
               allow_random: bool = False, detector=None, device="cuda", timing: bool = False):
    """Drive one streaming session; returns the final phase list.

    ``detector`` injects a prebuilt detection pipeline (tests use a
    deterministic pixel detector); by default the shipped weights named by
    ``model`` are served on ``device`` as ``vbt-torch-track`` serves them,
    after the card's health probe (random weights for a missing checkpoint
    only with ``allow_random``). ``timing`` prints the session's stages and
    spans (:class:`~vbt_tpu_torch.utils.profiling.StageTimer`) at its end."""
    from vbt_tpu_torch.io.video import VideoReader
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline
    from vbt_tpu_torch.runtime.streaming import StreamingPipeline
    from vbt_tpu_torch.utils.cache import enable_persistent_cache
    from vbt_tpu_torch.utils.health import require_healthy_device

    if detector is None:
        enable_persistent_cache()
        require_healthy_device(device, context="stream")  # fail fast on a wedged card
        detector = DetectionPipeline.from_model_arg(model, device=device,
                                                    allow_random=allow_random)
    reader = VideoReader(src, batch_size=chunk_size,
                         lend=getattr(detector, "lend_frames", None))
    fps = reader.meta.fps
    if not fps or fps <= 0:
        # Live captures often report no fps; the timestamps need one.
        fps = 30.0
        print("source reports no fps; assuming 30.0", file=out, flush=True)
    pipe = StreamingPipeline(detector=detector, fps=fps, detection_threshold=detection_threshold,
                             plate_diameter=plate_diameter, follow_id=follow_id)

    live = LiveReps(out)
    for frames, frame_valid, _ in reader:
        keep = int(frame_valid.sum())
        if keep == 0:
            continue
        # The whole (lent) batch is uploaded; only its first `keep` frames count.
        pipe.process_frames(frames, keep)
        live.update(pipe.phases(include_open=False))
    phases = pipe.phases()
    live.summary(phases)
    if timing:
        print(pipe.timer.report(), file=out, flush=True)
    return phases


class LiveReps:
    """The lines of a session: each concentric phase as it completes, each
    printed rep that a later, larger one retires, and the final summary.
    Reps are keyed by their start time; live numbers follow the order of
    announcement, the summary renumbers."""

    def __init__(self, out=sys.stdout):
        self.out = out
        self.announced: dict[float, int] = {}
        self.next_rep = 1

    def _print(self, line: str) -> None:
        print(line, file=self.out, flush=True)

    def update(self, phases) -> None:
        conc = [p for p in phases if p.type == CONCENTRIC]
        current = {p.time_start for p in conc}
        for gone in [t for t in self.announced if t not in current]:
            self._print(f"(rep {self.announced[gone]} at t={gone:.2f}s retired by a larger rep)")
            del self.announced[gone]
        for p in conc:
            if p.time_start not in self.announced:
                self.announced[p.time_start] = self.next_rep
                self._print(_fmt_rep(self.next_rep, p))
                self.next_rep += 1

    def summary(self, phases) -> None:
        conc = [p for p in phases if p.type == CONCENTRIC]
        self._print(f"session complete: {len(conc)} reps")
        for i, p in enumerate(conc, 1):
            self._print(_fmt_rep(i, p))


def make_command():
    """Build the click command (click is imported here, not at import)."""
    import click

    @click.command()
    @click.argument("src")
    @click.option("--model", default="models/efficientdet_lite0_whole.msgpack",
                  show_default=True,
                  help="Spec name, .msgpack checkpoint, or reference-style "
                       ".tflite path (resolved like track.py --model).")
    @click.option("--detection_treshold", default=0.5, show_default=True,
                  help="Score threshold (reference track.py:69 spelling).")
    @click.option("--chunk_size", default=64, show_default=True,
                  help="Frames per streamed device chunk.")
    @click.option("--plate_diameter", default=0.45, show_default=True,
                  help="Weight-plate diameter in meters (plot.py:54).")
    @click.option("--follow_id", default=1, show_default=True,
                  help="Track id to analyze (OC-SORT's stable identity is 1).")
    @click.option("--timing", is_flag=True,
                  help="Print per-stage and per-span wall-clock accounting at the end.")
    def command(src, model, detection_treshold, chunk_size, plate_diameter, follow_id, timing):
        """Stream SRC (a video file path, or a camera index like '0') through
        detect -> track -> phase analysis, printing per-rep ROM / ACV live."""
        if src.isdigit():  # a camera index, as cv2.VideoCapture takes it
            src = int(src)
        run_stream(src, model, detection_treshold, chunk_size, plate_diameter, follow_id,
                   timing=timing)

    return command


def main(args=None, standalone_mode: bool = True):
    """Console entry point (``vbt-torch-stream``)."""
    return make_command().main(args=args, standalone_mode=standalone_mode)


if __name__ == "__main__":
    main()
