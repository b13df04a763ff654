"""Track weight plates in videos: detection + scan tracker -> dataframe.

Port of ``vbt_tpu.cli.track`` with the same options, names and defaults,
dataframe schema and filename grammar:

- ``--tracker scan`` (the default) runs the whole video through the batched
  OC-SORT scan in float32 on the pipeline's device: kernel K3
  (``csrc/track_scan.cu``) on the card, its plain version on the CPU.
  ``--tracker host`` is the reference-exact per-frame OC-SORT loop;
- ``--multi_clip`` tracks every SRC in one scan a device (one K3 launch, a
  warp a clip), the clips axis padded to a multiple of the device count and
  split over the devices (:func:`runtime.batch_runner.shard_clips`);
- ``--time_shard`` cuts each video's frame axis into one chunk a device and
  relays the tracker state from chunk to chunk
  (:mod:`vbt_tpu_torch.parallel.time_shard`), with output equal to one scan;
  the devices are every card of the machine (:func:`parallel.mesh.make_mesh`),
  in one process;
- the detector runs on CUDA, bf16, with the NMS kernel
  (:mod:`vbt_tpu_torch.runtime.pipeline`); without a card it raises;
- before it touches the card, :func:`run` selects the kernel build cache
  and probes the card in a deadlined subprocess
  (:mod:`vbt_tpu_torch.utils.cache`, :mod:`vbt_tpu_torch.utils.health`);
- ``--profile_dir DIR`` records the tracking of every SRC with
  ``torch.profiler`` (:func:`vbt_tpu_torch.utils.profiling.trace`) into a
  TensorBoard-loadable trace in DIR, the kernels' launches included.

Precision: as in the JAX CLI, the scan runs in float32, so the exported
``dx, dy`` carry an early-track Kalman transient against a float64 run
(the huge initial covariances cancel in float32); ids, positions and plate
sizes are unaffected, and nothing downstream reads ``dx``.

click, cv2 and pandas are imported only where they are used, so the
library functions here (:func:`collect_detections`,
:func:`run_scan_tracker`, :func:`run_host_tracker`, :func:`tracks_to_data`)
run without them.

Usage: ``python -m vbt_tpu_torch.cli.track --df_dir dfs/ video.mp4``
"""

from __future__ import annotations

import os

import numpy as np
import torch

from vbt_tpu_torch.contract.schema import build_df_filename, build_track_df, max_travel_id
from vbt_tpu_torch.io.video import VideoReader, VideoWriter, draw_bar_path, draw_bounding_box
from vbt_tpu_torch.tracking import OCSort
from vbt_tpu_torch.tracking.scan import ScanTrackerConfig, track_video
from vbt_tpu_torch.utils.profiling import StageTimer, span, trace

MAX_AGE = 30
COLORS = [(115, 3, 252), (255, 255, 255)]
D_CAP = 25  # detections per frame (NMS contract)
TRACK_SLOTS = 16  # tracks reported per frame, as the JAX CLI's trackers

def scan_config() -> ScanTrackerConfig:
    """The reference's tracker: OC-SORT, max_age 30, DIoU, IoU 0.1, 16 slots."""
    return ScanTrackerConfig.ocsort(max_age=MAX_AGE, asso="diou", iou_threshold=0.1,
                                    max_tracks=TRACK_SLOTS)


def job_devices(device) -> list[torch.device]:
    """The devices a sharded job runs over: every card when the detector is
    on one, else the detector's device alone."""
    from vbt_tpu_torch.parallel.mesh import make_mesh

    device = torch.device(device)
    return make_mesh() if device.type == "cuda" else [device]


def _tracks_numpy(out) -> dict:
    return {"report": out.report.cpu().numpy(), "box": out.box.cpu().numpy(),
            "track_id": out.track_id.cpu().numpy(), "conf": out.conf.cpu().numpy(),
            "dxdy": out.dxdy.cpu().numpy()}


def collect_detections(detector, src: str, threshold: float, batch_size: int = 64):
    """Pass 1: decode + batched detection over the whole video.

    Returns (dets (T, 25, 6) normalized, valid (T, 25), meta). Frames are
    decoded straight into the pipeline's pinned staging buffers. Up to 8
    batches are queued on the device before the oldest is read back, so
    decoding overlaps device work while resident inputs stay bounded.
    Spans (into the caller's open stage): ``decode`` a batch from the
    reader, ``drain`` a batch read back into tracker rows, and the
    pipeline's own ``detect.*`` spans.
    """
    reader = VideoReader(src, batch_size=batch_size, lend=detector.lend_frames)
    max_in_flight = 8
    pending: list = []
    all_rows, all_valid = [], []

    def _drain_one():
        with span("drain"):
            det, keep = pending.pop(0)
            rows, valid = detector.detections_to_tracker_inputs(det, threshold)
            all_rows.append(rows[:keep])
            all_valid.append(valid[:keep])

    batches = iter(reader)
    while True:
        with span("decode"):
            batch = next(batches, None)
        if batch is None:
            break
        frames, frame_valid, _ = batch
        pending.append((detector.detect_batch(frames), int(frame_valid.sum())))
        if len(pending) > max_in_flight:
            _drain_one()
    while pending:
        _drain_one()
    if not all_rows:
        return np.zeros((0, D_CAP, 6)), np.zeros((0, D_CAP), bool), reader.meta
    return np.concatenate(all_rows), np.concatenate(all_valid), reader.meta


def run_scan_tracker(dets: np.ndarray, valid: np.ndarray, device="cuda",
                     time_shard: bool = False, cfg=None) -> dict:
    """Pass 2: one scan over the frame axis in float32 on ``device`` (kernel
    K3 on the card, the plain version on the CPU) with ``cfg`` (default
    :func:`scan_config`, the CLI's OC-SORT). With ``time_shard`` the frame
    axis is cut into one chunk for each of :func:`job_devices` and the
    tracker state relayed from chunk to chunk; the output is the same."""
    cfg = cfg or scan_config()
    if time_shard:
        from vbt_tpu_torch.parallel.time_shard import track_video_time_sharded

        out = track_video_time_sharded(cfg, torch.as_tensor(dets, dtype=torch.float32),
                                       torch.as_tensor(valid), job_devices(device))
    else:
        out = track_video(cfg,
                          torch.as_tensor(dets, dtype=torch.float32, device=device),
                          torch.as_tensor(valid, device=device))
    return _tracks_numpy(out)


def run_host_tracker(dets: np.ndarray, valid: np.ndarray, tracker=None) -> dict:
    """Reference-exact per-frame loop of a host tracker with the
    ``update(dets, _)`` surface; by default the CLI's OC-SORT (max_age 30,
    DIoU, IoU 0.1)."""
    tracker = tracker or OCSort(max_age=MAX_AGE, asso_func="diou", iou_threshold=0.1)
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


def track_many(detector, sources: list[str], detection_treshold: float, batch_size: int = 64,
               timer: StageTimer | None = None) -> dict[str, dict]:
    """Track several videos in one scan a device: detections are collected
    per clip and padded to a common length; with several
    :func:`job_devices` the clips axis is padded with inert clips to a
    multiple of their count and split over them, and each device's clips
    run in one launch of kernel K3 (a warp a clip). Returns
    {src: data dict}."""
    from vbt_tpu_torch.runtime.batch_runner import pad_clips, shard_clips, track_clips

    timer = timer if timer is not None else StageTimer()
    per_dets, per_valid, metas = [], [], []
    with timer.stage("decode+detect"):
        for s in sources:
            dets, valid, meta = collect_detections(detector, s, detection_treshold, batch_size)
            per_dets.append(dets)
            per_valid.append(valid)
            metas.append(meta)
    with timer.stage("tracker[multi-clip]"):
        arrays = pad_clips(per_dets, per_valid)
        devices = job_devices(detector.device)
        pad = -len(sources) % len(devices)  # inert clips: no valid frame
        arrays = [np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)]) for a in arrays]
        arrays[0] = arrays[0].astype(np.float32)
        shares = [_tracks_numpy(track_clips(scan_config(), *share))
                  for share in shard_clips(devices, *arrays)]
        out = {k: np.concatenate([s[k] for s in shares]) for k in shares[0]}
    results = {}
    with timer.stage("dataframe"):
        for i, s in enumerate(sources):
            t = per_dets[i].shape[0]
            results[s] = tracks_to_data({k: v[i][:t] for k, v in out.items()}, metas[i].fps)
    return results


def track_one(
    detector,
    src: str,
    detection_treshold: float,
    tracker_kind: str = "scan",
    video_path: str | None = None,
    display: bool = False,
    frame_stride: int = 1,
    batch_size: int = 64,
    timer: StageTimer | None = None,
    time_shard: bool = False,
) -> dict:
    """One video -> the columnar capture dict (see :func:`tracks_to_data`).
    ``time_shard`` as in :func:`run_scan_tracker`."""
    if tracker_kind not in ("scan", "host"):
        raise ValueError(f"tracker_kind must be 'scan' or 'host', got {tracker_kind!r}")
    timer = timer if timer is not None else StageTimer()
    with timer.stage("decode+detect"):
        dets, valid, meta = collect_detections(detector, src, detection_treshold, batch_size)
    if frame_stride > 1:
        # Keep frames where the 1-based frame count is a multiple of the stride.
        keep = (np.arange(dets.shape[0]) + 1) % frame_stride == 0
        dets, valid = dets[keep], valid[keep]
    with timer.stage(f"tracker[{tracker_kind}]"):
        if tracker_kind == "scan":
            tracks = run_scan_tracker(dets, valid, detector.device, time_shard=time_shard)
        else:
            tracks = run_host_tracker(dets, valid)
    if video_path is not None:
        with timer.stage("annotate+encode"):
            render_annotated_video(src, tracks, video_path, display)
    fps = meta.fps / frame_stride if frame_stride > 1 else meta.fps
    with timer.stage("dataframe"):
        return tracks_to_data(tracks, fps)


def _export_df(data: dict, src: str, model: str, df_dir: str) -> None:
    df = build_track_df(data)
    df.to_pickle(os.path.join(df_dir, build_df_filename(src, max_travel_id(df), model)))


def run(src, model, detection_treshold, df_dir, video_dir, display, frame_stride,
        batch_size, timing, tracker="scan", multi_clip=False, device="cuda",
        time_shard=False, profile_dir=None):
    """The body of the CLI, callable without click. ``multi_clip`` and
    ``time_shard`` split over :func:`job_devices`. Each SRC is checked when
    its turn comes, so the videos before a missing one are tracked and
    exported; ``multi_clip`` checks them all first. With ``profile_dir``
    the tracking is traced into that directory."""
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline
    from vbt_tpu_torch.utils.cache import enable_persistent_cache
    from vbt_tpu_torch.utils.health import require_healthy_device

    enable_persistent_cache()
    require_healthy_device(device, context="track")  # fail fast on a wedged card
    if df_dir is not None:
        os.makedirs(df_dir, exist_ok=True)
    if video_dir is not None:
        os.makedirs(video_dir, exist_ok=True)
    detector = DetectionPipeline.from_model_arg(model, device=device)
    timer = StageTimer()
    with trace(profile_dir):
        if multi_clip and len(src) > 1:
            for s in src:
                if not os.path.isfile(s):
                    raise FileNotFoundError(s)
            results = track_many(detector, list(src), detection_treshold,
                                 batch_size=batch_size, timer=timer)
            if df_dir is not None:
                for s, data in results.items():
                    if data["id"]:
                        _export_df(data, s, model, df_dir)
        else:
            for s in src:
                if not os.path.isfile(s):
                    raise FileNotFoundError(s)
                video_path = None
                if video_dir is not None:
                    video_path = os.path.join(video_dir,
                                              f"{os.path.basename(s).split('.')[0]}.mp4")
                data = track_one(detector, s, detection_treshold, tracker_kind=tracker,
                                 video_path=video_path, display=display,
                                 frame_stride=frame_stride, batch_size=batch_size, timer=timer,
                                 time_shard=time_shard)
                if df_dir is not None and data["id"]:
                    _export_df(data, s, model, df_dir)
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
    @click.option("--tracker", default="scan", type=click.Choice(["scan", "host"]),
                  show_default=True,
                  help="Batched scan tracker (kernel K3 on the card) or reference-exact host loop.")
    @click.option("--display", is_flag=True, help="Show frames while tracking (requires a GUI).")
    @click.option("--frame_stride", default=1, type=int, show_default=True,
                  help="Process every Nth frame (the reference's %16 perf hack; golden dataframes use 1).")
    @click.option("--batch_size", default=64, type=int, show_default=True,
                  help="Device frame batch size.")
    @click.option("--profile_dir", default=None, show_default=True,
                  help="Device trace directory (torch.profiler, TensorBoard-loadable).")
    @click.option("--timing", is_flag=True, help="Print per-stage wall-clock accounting.")
    @click.option("--multi_clip", is_flag=True,
                  help="Track all SRC videos in one scan a card, a warp a clip, the clips split over the cards (no per-video video export in this mode).")
    @click.option("--time_shard", is_flag=True,
                  help="Cut each video's frame axis into one chunk per card; the tracker state is relayed from chunk to chunk (bit-equal output).")
    def command(src, model, detection_treshold, display_image_height, df_dir, video_dir,
                threads, tracker, display, frame_stride, batch_size, profile_dir, timing,
                multi_clip, time_shard):
        """Visualize the object detection model for barbell tracking on a video
        and create a dataframe containing the detected objects their raw
        and filtered positions and velocities at specific times in the video."""
        del display_image_height, threads
        run(src, model, detection_treshold, df_dir, video_dir, display, frame_stride,
            batch_size, timing, tracker=tracker, multi_clip=multi_clip, time_shard=time_shard,
            profile_dir=profile_dir)

    return command


def main(args=None, standalone_mode: bool = True):
    """Console entry point (``vbt-torch-track``)."""
    return make_command().main(args=args, standalone_mode=standalone_mode)


if __name__ == "__main__":
    main()
