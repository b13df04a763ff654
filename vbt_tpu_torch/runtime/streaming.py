"""Streaming pipeline: chunked decode -> detect -> track -> phases.

Port of ``vbt_tpu.runtime.streaming``. The tracker state and the analysis
carries persist across chunks, so a set of any length streams in O(1)
memory, and every chunk runs the same step functions as the offline path:
what the stream reports equals the offline analysis of everything seen so
far.

Each chunk is one tracker scan and one analysis scan on the pipeline's
device:

- :func:`track_chunk`: kernel K3 (``csrc/track_scan.cu``) with the tracker
  state in and out on the card, float32; its plain version on the CPU, in
  the state's dtype;
- :func:`analysis_chunk`: the causal smoother and the phase state machine
  fused, kernel K4 (``csrc/analysis_scan.cu``) on the card, its plain
  version on the CPU, float64 both.

``_CausalSmoother`` is the float64 host oracle of the smoothing, for tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from vbt_tpu_torch.analysis.phase import Phase
from vbt_tpu_torch.analysis.smoother_scan import initial_smoother
from vbt_tpu_torch.analysis.velocity_torch import (
    EventRecord,
    VelocityCarry,
    finalize_events,
    flush_event,
    initial_carry,
    to_phase_list,
    velocity_step,
)
from vbt_tpu_torch.ops.analysis_scan_cuda import (
    analysis_chunk_plain,
    analysis_scan,
    stack_events,
)
from vbt_tpu_torch.tracking.scan import (
    FrameTracks,
    ScanTrackerConfig,
    TrackerState,
    init_state,
    scan_clips,
)
from vbt_tpu_torch.utils.device import resolve_device
from vbt_tpu_torch.utils.profiling import StageTimer, to_host

__all__ = ["track_chunk", "velocity_chunk", "analysis_chunk", "analysis_chunk_plain",
           "StreamingAnalyzer", "StreamingPipeline"]


def track_chunk(cfg: ScanTrackerConfig, state: TrackerState, dets, valid,
                skip_empty_frames: bool = True) -> tuple[TrackerState, FrameTracks]:
    """Advance one video's tracker over a chunk of frames, carrying state:
    ``state`` a one-clip ``TrackerState`` (``init_state(cfg, 1, ...)``),
    ``dets`` (T, D, 6), ``valid`` (T, D) on the state's device -> (final
    state, FrameTracks (T, S, ...)). K3 on the card, the plain scan on the
    CPU."""
    dets = torch.as_tensor(dets)
    valid = torch.as_tensor(valid)
    frames = torch.ones((1, dets.shape[0]), dtype=torch.bool, device=dets.device)
    state, out = scan_clips(cfg, dets[None].contiguous(), valid[None].contiguous(), frames,
                            skip_empty_frames, state=state, return_state=True)
    return state, FrameTracks(*(f[0] for f in out))


def velocity_chunk(plate_diameter, carry: VelocityCarry, inputs):
    """Advance the phase state machine over one chunk of pre-smoothed
    samples: ``inputs`` = (time, dy, x, y, width, height), each (N,) ->
    (carry, EventRecord (N,) each field)."""
    events = []
    for i in range(inputs[0].shape[0]):
        carry, ev = velocity_step(plate_diameter, carry, tuple(col[i] for col in inputs))
        events.append(ev)
    return carry, stack_events(events, inputs[0].device)


def analysis_chunk(plate_diameter, smoother, carry: VelocityCarry, inputs):
    """Smoothing and the phase state machine fused over one chunk:
    ``inputs`` = (time, x, y, dy_raw, nph, npw), each (N,) float64 ->
    (smoother, carry, events). K4 on the card, one launch; the plain loop on
    the CPU."""
    return analysis_scan(plate_diameter, smoother, carry, inputs)


class _CausalSmoother:
    """The plot CLI's smoothing, one sample at a time, in float64 on the host."""

    def __init__(self):
        self.win_x: list[float] = []
        self.win_y: list[float] = []
        self.exp_h_sum = 0.0
        self.exp_w_sum = 0.0
        self.exp_n = 0
        self.ra_buf: list[float] = []  # shared interleaved width/height window
        self.ra_total = 0.0
        self.y_prev: float | None = None

    def _ra_update(self, value: float) -> float:
        self.ra_buf.append(value)
        self.ra_total += value
        if len(self.ra_buf) >= 30:
            out = self.ra_total / 30
            self.ra_total -= self.ra_buf.pop(0)
            return out
        return self.ra_total / len(self.ra_buf)

    def push(self, x, y, dy_raw, nph, npw):
        """Returns (x_s, y_s, dy_eff, w_ra, h_ra) for one raw sample."""
        self.win_x.append(x)
        self.win_y.append(y)
        if len(self.win_x) > 5:
            self.win_x.pop(0)
            self.win_y.pop(0)
        x_s = sum(self.win_x) / len(self.win_x)
        y_s = sum(self.win_y) / len(self.win_y)

        self.exp_h_sum += nph
        self.exp_w_sum += npw
        self.exp_n += 1
        h_e = self.exp_h_sum / self.exp_n
        w_e = self.exp_w_sum / self.exp_n

        w_ra = self._ra_update(w_e)
        h_ra = self._ra_update(h_e)

        dy_eff = dy_raw if self.y_prev is None else y_s - self.y_prev
        self.y_prev = y_s
        return x_s, y_s, dy_eff, w_ra, h_ra


@dataclass
class StreamingAnalyzer:
    """Phase analysis of one followed track, fed in chunks of raw samples
    (time, x, y, dy, norm_plate_height, norm_plate_width); ``phases()`` at
    any point equals the offline analysis of everything pushed so far. The
    carries live on ``device`` (K4 on the card); reading which samples
    ended a phase costs one sync a chunk. Every read of the card is a
    ``to_host`` (the spans ``analysis.readback`` and ``phases.readback``)."""

    plate_diameter: float = 0.45
    diff_threshold: float = 0.6
    min_distance: float = 0.1
    dtype: torch.dtype = torch.float64
    device: str | torch.device = "cuda"

    _carry: VelocityCarry | None = None
    _events: list = field(default_factory=list)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._carry = initial_carry(self.dtype, self.device)
        self._smoother = initial_smoother(self.dtype, self.device)
        self._pd = torch.tensor(self.plate_diameter, dtype=self.dtype, device=self.device)

    def push_chunk(self, time, x, y, dy, nph, npw) -> None:
        n = len(time)
        if n == 0:
            return
        host = np.stack([np.asarray(c, np.float64) for c in (time, x, y, dy, nph, npw)])
        cols = torch.from_numpy(host).to(device=self.device, dtype=self.dtype)
        self._smoother, self._carry, events = analysis_chunk(
            self._pd, self._smoother, self._carry, tuple(cols))
        fired = to_host(events.fired, "analysis")
        if fired.any():
            rows = {k: to_host(v, "analysis") for k, v in events._asdict().items()}
            for i in np.nonzero(fired)[0]:
                self._events.append({k: rows[k][i] for k in rows})

    def phases(self, include_open: bool = True) -> list[Phase]:
        """The current phase list. ``include_open`` adds what the end of the
        stream would flush now (the final summary wants it; live lines pass
        False so that only completed phases print)."""
        carry, flush = flush_event(self._carry)
        records = list(self._events)
        flush_host = {k: to_host(v, "phases") for k, v in flush._asdict().items()}
        if include_open and bool(flush_host["fired"]):
            records.append(flush_host)
        if not records:
            return []
        events = EventRecord(**{k: torch.from_numpy(np.stack([r[k] for r in records]))
                                for k in records[0]})
        final_max = torch.from_numpy(to_host(carry.max_y_diff, "phases"))
        pa = finalize_events(events, final_max, self.diff_threshold, self.min_distance)
        return to_phase_list(pa)


def _reference_tracker() -> ScanTrackerConfig:
    return ScanTrackerConfig.ocsort(max_age=30, asso="diou", iou_threshold=0.1, max_tracks=16)


@dataclass
class StreamingPipeline:
    """Frames in, phases out: detect, track and analyse chunk by chunk.

    Follows one track id (1 by default, OC-SORT's stable identity on one
    plate); ``analyzer.phases()`` gives the reps so far. Everything runs on
    the detector's device: on the card the tracker is K3 in float32
    (``tracker_dtype`` must be float32 there) and the analysis K4; on the
    CPU the plain versions, the tracker in ``tracker_dtype`` (float64 by
    default, as the JAX package asks).

    ``timer`` adds each chunk's host-clock stages: ``detect`` (the batch and
    the readback of its detections), ``track`` (K3 and the readback of its
    outputs), ``select`` (the followed id's rows, numpy), ``analysis`` (K4
    and the readback of which samples ended a phase) and ``phases``. Each
    ends in a readback, so each holds its device work. The spans below them
    record into it too: ``detect.upload``, ``detect.forward``,
    ``detect.postprocess``, and ``<stage>.readback`` for each tensor read
    (:func:`~vbt_tpu_torch.utils.profiling.to_host`): 3 a chunk in
    ``detect``, 4 in ``track``, 1 in ``analysis`` (10 where a phase ended)
    and 10 a ``phases()`` (9 while there is no phase to list).

    On the card, every chunk of one shape from a pipeline's third on (the
    first ran eagerly, the second captured; a padded last chunk has the
    same shape) is detected by replaying the pipeline's CUDA graph of its
    detect chain (:meth:`DetectionPipeline.detect_batch
    <vbt_tpu_torch.runtime.pipeline.DetectionPipeline.detect_batch>`):
    ``detect.forward`` then times the copy into the graph's input and the
    replay, ``detect.replay`` the replay alone, ``detect.postprocess`` the
    copy of the detections out of the graph, each once a chunk. A chunk's
    detections are tensors of its own, which no later chunk overwrites."""

    detector: object
    fps: float
    detection_threshold: float = 0.5
    plate_diameter: float = 0.45
    follow_id: int = 1
    tracker_cfg: ScanTrackerConfig = field(default_factory=_reference_tracker)
    tracker_dtype: torch.dtype | None = None
    timer: StageTimer = field(default_factory=StageTimer)

    def __post_init__(self):
        dev = torch.device(getattr(self.detector, "device", "cpu"))
        if self.tracker_dtype is None:
            self.tracker_dtype = torch.float32 if dev.type == "cuda" else torch.float64
        self._tracker_state = init_state(self.tracker_cfg, 1, self.tracker_dtype, dev)
        self.analyzer = StreamingAnalyzer(plate_diameter=self.plate_diameter, device=dev)
        self._frame_count = 0

    def process_frames(self, frames_uint8, n_frames: int | None = None) -> None:
        """Detect, track and analyse one chunk. ``n_frames`` (all by default)
        are real; frames after them are padding of a fixed-size batch, which
        is detected but neither tracked nor counted."""
        with self.timer.stage("detect"):
            det = self.detector.detect_batch(frames_uint8)
            rows, valid = self.detector.detections_to_tracker_inputs(
                det, self.detection_threshold)
        if n_frames is not None:
            rows, valid = rows[:n_frames], valid[:n_frames]
        with self.timer.stage("track"):
            dev = self._tracker_state.x.device
            self._tracker_state, out = track_chunk(
                self.tracker_cfg, self._tracker_state,
                torch.as_tensor(rows, dtype=self.tracker_dtype, device=dev),
                torch.as_tensor(valid, device=dev))
            report = to_host(out.report, "track")
            boxes = to_host(out.box, "track")
            ids = to_host(out.track_id, "track")
            dy = to_host(out.dxdy[..., 1], "track")
        with self.timer.stage("select"):
            # The followed id's rows in frame order, then slot order; centers
            # and sizes in the boxes' dtype, as the offline dataframe has them.
            t_idx, s_idx = np.nonzero(report & (ids == self.follow_id))
            x1, y1, x2, y2 = np.moveaxis(boxes[t_idx, s_idx], -1, 0)
            time = (self._frame_count + 1 + t_idx) / self.fps
            self._frame_count += rows.shape[0]
            samples = (time, (x1 + x2) / 2, (y1 + y2) / 2, dy[t_idx, s_idx], np.abs(y2 - y1),
                       np.abs(x2 - x1))
        with self.timer.stage("analysis"):
            self.analyzer.push_chunk(*samples)

    def phases(self, include_open: bool = True) -> list[Phase]:
        with self.timer.stage("phases"):
            return self.analyzer.phases(include_open=include_open)
