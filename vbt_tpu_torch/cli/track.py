"""Track weight plates in videos: detection + host OC-SORT -> dataframe.

Port of ``vbt_tpu.cli.track`` with the same options, names and defaults,
dataframe schema and filename grammar, except:

- ``--tracker`` defaults to ``host``, the reference-exact per-frame OC-SORT
  loop; ``--tracker scan`` (the batched scan tracker) comes with ROADMAP
  Queue 1 item 8 and is refused until then;
- ``--multi_clip`` and ``--time_shard`` come with Queue 1 item 10, and
  ``--profile_dir`` (a device trace) with item 15; each is refused with a
  usage error naming its item;
- the detector runs on CUDA, bf16, with the NMS kernel
  (:mod:`vbt_tpu_torch.runtime.pipeline`); without a card it raises.

click, cv2 and pandas are imported only where they are used, so the
library functions here (:func:`collect_detections`,
:func:`run_host_tracker`, :func:`tracks_to_data`) run without them.

Usage: ``python -m vbt_tpu_torch.cli.track --df_dir dfs/ video.mp4``
"""

from __future__ import annotations

import os

import numpy as np

from vbt_tpu_torch.contract.schema import build_df_filename, build_track_df, max_travel_id
from vbt_tpu_torch.io.video import VideoReader, VideoWriter, draw_bar_path, draw_bounding_box
from vbt_tpu_torch.tracking import OCSort
from vbt_tpu_torch.utils.profiling import StageTimer

MAX_AGE = 30
COLORS = [(115, 3, 252), (255, 255, 255)]
D_CAP = 25  # detections per frame (NMS contract)
TRACK_SLOTS = 16  # tracks reported per frame, as the JAX CLI's trackers

NOT_PORTED = {
    "--tracker scan": "ROADMAP.md Queue 1 item 8 (scan tracker)",
    "--multi_clip": "ROADMAP.md Queue 1 item 10 (multi-clip and multi-GPU)",
    "--time_shard": "ROADMAP.md Queue 1 item 10 (multi-clip and multi-GPU)",
    "--profile_dir": "ROADMAP.md Queue 1 item 15 (operational shell: profiling)",
}


def collect_detections(detector, src: str, threshold: float, batch_size: int = 64):
    """Pass 1: decode + batched detection over the whole video.

    Returns (dets (T, 25, 6) normalized, valid (T, 25), meta). Up to 8
    batches are queued on the device before the oldest is read back, so
    decoding overlaps device work while resident inputs stay bounded.
    """
    reader = VideoReader(src, batch_size=batch_size)
    max_in_flight = 8
    pending: list = []
    all_rows, all_valid = [], []

    def _drain_one():
        det, keep = pending.pop(0)
        rows, valid = detector.detections_to_tracker_inputs(det, threshold)
        all_rows.append(rows[:keep])
        all_valid.append(valid[:keep])

    for frames, frame_valid, _ in reader:
        pending.append((detector.detect_batch(frames), int(frame_valid.sum())))
        if len(pending) > max_in_flight:
            _drain_one()
    while pending:
        _drain_one()
    if not all_rows:
        return np.zeros((0, D_CAP, 6)), np.zeros((0, D_CAP), bool), reader.meta
    return np.concatenate(all_rows), np.concatenate(all_valid), reader.meta


def run_host_tracker(dets: np.ndarray, valid: np.ndarray) -> dict:
    """Reference-exact per-frame OC-SORT loop (max_age 30, DIoU, IoU 0.1)."""
    tracker = OCSort(max_age=MAX_AGE, asso_func="diou", iou_threshold=0.1)
    t_frames = dets.shape[0]
    s = TRACK_SLOTS
    report = np.zeros((t_frames, s), bool)
    box = np.zeros((t_frames, s, 4))
    track_id = np.zeros((t_frames, s), np.int32)
    conf = np.zeros((t_frames, s))
    dxdy = np.zeros((t_frames, s, 2))
    for t in range(t_frames):
        rows = dets[t][valid[t]]
        if rows.shape[0] == 0:
            continue  # empty frames never touch the tracker
        out = tracker.update(rows, [])
        for k, r in enumerate(out[:s]):
            x1, y1, x2, y2, tid, _cls, score = r
            trk = next(t_ for t_ in tracker.trackers if t_.id == int(tid) - 1)
            report[t, k] = True
            box[t, k] = [x1, y1, x2, y2]
            track_id[t, k] = int(tid)
            conf[t, k] = score
            dxdy[t, k] = trk.kf.x.flatten()[4:6]
    return {"report": report, "box": box, "track_id": track_id, "conf": conf, "dxdy": dxdy}


def tracks_to_data(tracks: dict, fps: float, frame_offset: int = 0) -> dict:
    """Per-frame tracker outputs -> the columnar capture dict; rows within a
    frame by descending track id."""
    data = {
        "id": [], "time": [], "x": [], "y": [], "dx": [], "dy": [],
        "norm_plate_height": [], "norm_plate_width": [],
    }
    for t in range(tracks["report"].shape[0]):
        slots = np.nonzero(tracks["report"][t])[0]
        slots = slots[np.argsort(-tracks["track_id"][t][slots], kind="stable")]
        time = (frame_offset + t + 1) / fps  # frame_count starts at 1
        for s in slots:
            x1, y1, x2, y2 = tracks["box"][t, s]
            data["id"].append(int(tracks["track_id"][t, s]))
            data["time"].append(time)
            data["x"].append((x1 + x2) / 2)
            data["y"].append((y1 + y2) / 2)
            data["dx"].append(float(tracks["dxdy"][t, s, 0]))
            data["dy"].append(float(tracks["dxdy"][t, s, 1]))
            data["norm_plate_height"].append(abs(y2 - y1))
            data["norm_plate_width"].append(abs(x2 - x1))
    return data


def render_annotated_video(src: str, tracks: dict, video_path: str, display: bool):
    """Pass 3 (only when exporting video): re-decode and draw boxes and bar
    paths; frames without reported tracks are skipped."""
    del display  # accepted for CLI compatibility; no GUI here
    reader = VideoReader(src, batch_size=8)
    writer = VideoWriter(video_path, reader.meta.fps, reader.meta.width, reader.meta.height)
    bar_paths: dict[int, np.ndarray] = {}
    for frames, frame_valid, start in reader:
        for i in range(int(frame_valid.sum())):
            t = start + i
            if t >= tracks["report"].shape[0] or not tracks["report"][t].any():
                continue
            img = frames[i].copy()
            slots = np.nonzero(tracks["report"][t])[0]
            slots = slots[np.argsort(-tracks["track_id"][t][slots], kind="stable")]
            for s in slots:
                x1, y1, x2, y2 = tracks["box"][t, s]
                tid = int(tracks["track_id"][t, s])
                draw_bounding_box(img, tid, [y1, x1, y2, x2], tracks["conf"][t, s], COLORS[1])
                center = np.array(
                    [((x1 + x2) / 2) * img.shape[1], ((y1 + y2) / 2) * img.shape[0]],
                    dtype=np.int32,
                )
                if tid in bar_paths:
                    bar_paths[tid] = np.concatenate([bar_paths[tid], [center]])
                else:
                    bar_paths[tid] = np.array([center], np.int32)
                draw_bar_path(img, bar_paths[tid].astype(np.int32), COLORS[1])
            writer.write_rgb(img)
    writer.release()


def track_one(
    detector,
    src: str,
    detection_treshold: float,
    tracker_kind: str = "host",
    video_path: str | None = None,
    display: bool = False,
    frame_stride: int = 1,
    batch_size: int = 64,
    timer: StageTimer | None = None,
) -> dict:
    """One video -> the columnar capture dict (see :func:`tracks_to_data`)."""
    if tracker_kind != "host":
        raise NotImplementedError(
            f"tracker {tracker_kind!r} is not ported yet: {NOT_PORTED['--tracker scan']}")
    timer = timer if timer is not None else StageTimer()
    with timer.stage("decode+detect"):
        dets, valid, meta = collect_detections(detector, src, detection_treshold, batch_size)
    if frame_stride > 1:
        # Keep frames where the 1-based frame count is a multiple of the stride.
        keep = (np.arange(dets.shape[0]) + 1) % frame_stride == 0
        dets, valid = dets[keep], valid[keep]
    with timer.stage(f"tracker[{tracker_kind}]"):
        tracks = run_host_tracker(dets, valid)
    if video_path is not None:
        with timer.stage("annotate+encode"):
            render_annotated_video(src, tracks, video_path, display)
    fps = meta.fps / frame_stride if frame_stride > 1 else meta.fps
    with timer.stage("dataframe"):
        return tracks_to_data(tracks, fps)


def run(src, model, detection_treshold, df_dir, video_dir, display, frame_stride,
        batch_size, timing, device="cuda"):
    """The body of the CLI, callable without click."""
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline

    if df_dir is not None:
        os.makedirs(df_dir, exist_ok=True)
    if video_dir is not None:
        os.makedirs(video_dir, exist_ok=True)
    detector = DetectionPipeline.from_model_arg(model, device=device)
    timer = StageTimer()
    for s in src:
        if not os.path.isfile(s):
            raise FileNotFoundError(s)
        video_path = None
        if video_dir is not None:
            video_path = os.path.join(video_dir, f"{os.path.basename(s).split('.')[0]}.mp4")
        data = track_one(detector, s, detection_treshold, tracker_kind="host",
                         video_path=video_path, display=display,
                         frame_stride=frame_stride, batch_size=batch_size, timer=timer)
        if df_dir is not None and data["id"]:
            df = build_track_df(data)
            df.to_pickle(os.path.join(df_dir, build_df_filename(s, max_travel_id(df), model)))
    if timing:
        print(timer.report())


def make_command():
    """Build the click command (click is imported here, not at import)."""
    import click

    @click.command()
    @click.argument("src", type=str, nargs=-1)
    @click.option("--model", default="models/efficientdet_lite0_whole.tflite",
                  type=str, show_default=True,
                  help="Model used for object detection (spec name, .msgpack checkpoint, or reference-style .tflite path).")
    @click.option("--detection_treshold", default=0.5, type=float, show_default=True,
                  help="Object detection threshold.")
    @click.option("--display_image_height", default=720, type=int, show_default=True,
                  help="Displayed image height in pixels. Image width will be calculated to keep the same ratio as the original capture source.")
    @click.option("--df_dir", default=None, show_default=True,
                  help="Directory for exporting the dataframes. If not set the dataframe won't be exported.")
    @click.option("--video_dir", default=None, show_default=True,
                  help="Directory for exporting the video with tracked objects and bar path. If not set the videos with tracking won't be exported.")
    @click.option("--threads", default=4, show_default=True,
                  help="Kept for CLI compatibility (the reference's TFLite interpreter thread count); ignored.")
    @click.option("--tracker", default="host", type=click.Choice(["scan", "host"]),
                  show_default=True,
                  help="Reference-exact host OC-SORT loop; 'scan' is not ported yet.")
    @click.option("--display", is_flag=True, help="Show frames while tracking (requires a GUI).")
    @click.option("--frame_stride", default=1, type=int, show_default=True,
                  help="Process every Nth frame (the reference's %16 perf hack; golden dataframes use 1).")
    @click.option("--batch_size", default=64, type=int, show_default=True,
                  help="Device frame batch size.")
    @click.option("--profile_dir", default=None, show_default=True,
                  help="Device trace directory (not ported yet).")
    @click.option("--timing", is_flag=True, help="Print per-stage wall-clock accounting.")
    @click.option("--multi_clip", is_flag=True,
                  help="Track all SRC videos in one batched program (not ported yet).")
    @click.option("--time_shard", is_flag=True,
                  help="Shard each video's frame axis over devices (not ported yet).")
    def command(src, model, detection_treshold, display_image_height, df_dir, video_dir,
                threads, tracker, display, frame_stride, batch_size, profile_dir, timing,
                multi_clip, time_shard):
        """Visualize the object detection model for barbell tracking on a video
        and create a dataframe containing the detected objects their raw
        and filtered positions and velocities at specific times in the video."""
        del display_image_height, threads
        refused = {
            "--tracker scan": tracker == "scan",
            "--multi_clip": multi_clip,
            "--time_shard": time_shard,
            "--profile_dir": profile_dir is not None,
        }
        for flag, given in refused.items():
            if given:
                raise click.UsageError(f"{flag} is not ported yet: {NOT_PORTED[flag]}")
        run(src, model, detection_treshold, df_dir, video_dir, display, frame_stride,
            batch_size, timing)

    return command


def main(args=None, standalone_mode: bool = True):
    """Console entry point (``vbt-torch-track``)."""
    return make_command().main(args=args, standalone_mode=standalone_mode)


if __name__ == "__main__":
    main()
