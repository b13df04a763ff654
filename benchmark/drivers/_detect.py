"""What the detection cells share: the served pipeline, a pass-through
that keeps the tracker rows the program made, and the comparisons.

Compared numbers (a larger one is worse). In each judged frame the
program's first detection (the highest score after K1) is paired with
the plain float32 detector's detection of the same object, the one of
its rows that overlaps it most (so two boxes whose order of score a
rounding swaps are not compared with each other):

- ``box_gap``: each frame's widest gap of the pair's four corners
  (normalized: position and size); for each slot of a batch (the frame's
  index in its video or session modulo the batch), the median over the
  frames in that slot; the widest of those medians. A fault in one slot of
  every batch, a steady offset or scaled boxes raise it.
- ``box_gap_p90``: the 90th percentile of the frames' corner gaps, so a
  fault in a tenth of the frames shows wherever it falls. A higher
  quantile does not tell bf16 from int8: in 1-3% of frames both lie
  0.01-0.04 from float32 at a clear score margin (PERF.md).
- ``motion_gap``: over every pair of consecutive judged frames, how far
  the move of the program's box center lies from its pair's move; the
  median over the pairs. Velocity is made from these moves.
- ``valid_gap``: the frames in which the program's count of valid rows
  (``slot < count and score >= threshold``) differs from the reference's,
  leaving out frames in which a reference score lies within
  ``VALID_MARGIN`` of the threshold; an exact comparison.
- ``track_gap``: the program's capture dict against the reference's host
  OC-SORT (float64) run on the rows the program fed its own tracker: ids
  and times equal row for row, else 1e300; then the widest gap of x, y
  and the plate's height and width (normalized).
- ``phase_gap``: the program's phases against the reference's analysis of
  the same scan outputs: types and start and end frames equal phase for
  phase, else 1e300; then the widest relative gap of y_start, y_end and
  ROM.
"""

from __future__ import annotations

import numpy as np

TRACK_COLS = ("x", "y", "norm_plate_height", "norm_plate_width")
# Frames with a reference score this near the threshold may count a row
# either way in bf16 (the top box's score moves up to 0.012, PERF.md).
VALID_MARGIN = 0.05
DETECTION_NUMBERS = ("box_gap", "box_gap_p90", "motion_gap", "valid_gap")


def build_pipeline(config: dict, root, device: str = "cuda"):
    """The pipeline ``vbt-torch-track`` serves (bf16 on the card, K1), its
    kernels built into the checkout's fixed build directory. ``device``
    "cpu" is the CPU lane, for the benchmark's own tests."""
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline
    from vbt_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache(root / "build" / "vbt_tpu_torch")
    return DetectionPipeline.from_model_arg(str(root / config["checkpoint"]), device=device)


class Recorder:
    """The pipeline, passed through; while ``rows`` is a list, every
    ``detections_to_tracker_inputs`` result is appended to it."""

    def __init__(self, pipe):
        self._pipe = pipe
        self.rows = None

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def detections_to_tracker_inputs(self, det, threshold):
        rows, valid = self._pipe.detections_to_tracker_inputs(det, threshold)
        if self.rows is not None:
            self.rows.append((rows, valid))
        return rows, valid


def _iou(box, boxes):
    """IoU of (N, 4) boxes with each of (N, D, 4), corners x1, y1, x2, y2."""
    lo = np.maximum(box[:, None, :2], boxes[..., :2])
    hi = np.minimum(box[:, None, 2:], boxes[..., 2:])
    inter = np.clip(hi - lo, 0, None).prod(-1)
    area = lambda b: np.clip(b[..., 2:] - b[..., :2], 0, None).prod(-1)  # noqa: E731
    return inter / np.maximum(area(box)[:, None] + area(boxes) - inter, 1e-12)


def _centers(b):
    return np.stack([b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]], 1) / 2


def paired(prog_rows: np.ndarray, ref_rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each frame's first program box and the reference box it overlaps
    most. Rows (N, D, 6) [x1, y1, x2, y2, score, class] -> two (N, 4)."""
    prog = prog_rows[:, 0, :4]
    iou = _iou(prog, ref_rows[..., :4])
    iou[ref_rows[..., 4] <= 0] = -1.0  # empty slots
    return prog, ref_rows[np.arange(len(ref_rows)), iou.argmax(1), :4]


class DetectionGaps:
    """The judged sessions' per-frame gaps against the reference, and the
    compared numbers made from them (module docstring). ``batch`` is the
    frames a batch (or chunk) of the timed path."""

    def __init__(self, batch: int, threshold: float):
        self.batch, self.threshold = batch, threshold
        self.box, self.slot, self.motion = [], [], []
        self.valid = 0
        self.top_rows = []  # the three first rows of each side, for tools/readings.py

    def add(self, rows, valid, ref_rows, ref_valid) -> None:
        prog, pair = paired(rows, ref_rows)
        self.box.append(np.abs(prog - pair).max(axis=1))
        self.slot.append(np.arange(len(rows)) % self.batch)
        self.motion.append(np.abs(np.diff(_centers(prog) - _centers(pair), axis=0)).max(axis=1))
        near = (np.abs(ref_rows[..., 4] - self.threshold) < VALID_MARGIN).any(axis=1)
        self.valid += int(((valid.sum(1) != ref_valid.sum(1)) & ~near).sum())
        self.top_rows.append((rows[:, :3, :5], ref_rows[:, :3, :5]))

    def checks(self, limits: dict) -> list[dict]:
        box, slot = np.concatenate(self.box), np.concatenate(self.slot)
        per_slot = [np.median(box[slot == s]) for s in np.unique(slot)]
        return [check("box_gap", float(max(per_slot)), limits),
                check("box_gap_p90", float(np.percentile(box, 90)), limits),
                check("motion_gap", float(np.median(np.concatenate(self.motion))), limits),
                check("valid_gap", float(self.valid), limits)]


def tracks_numpy(frame_tracks, frames: int) -> dict:
    """The program's scan outputs of a session's chunks (``FrameTracks``
    on the device) as the host arrays the capture dict is made from (a
    dict of them already is returned as it is)."""
    if isinstance(frame_tracks, dict):
        return frame_tracks
    return {k: np.concatenate([getattr(f, k).cpu().numpy() for f in frame_tracks])[:frames]
            for k in ("report", "box", "track_id", "conf", "dxdy")}


def track_gap(prog: dict, ref: dict) -> float:
    if prog["id"] != ref["id"] or prog["time"] != ref["time"]:
        return float("inf")
    if not prog["id"]:
        return 0.0
    return max(float(np.abs(np.subtract(prog[c], ref[c])).max()) for c in TRACK_COLS)


def phase_gap(prog: list, ref: list, fps: float) -> float:
    def key(p):
        return int(p.type), round(float(p.time_start) * fps), round(float(p.time_end) * fps)

    if len(prog) != len(ref) or any(key(a) != key(b) for a, b in zip(prog, ref)):
        return float("inf")
    gap = 0.0
    for a, b in zip(prog, ref):
        for f in ("y_start", "y_end", "rom"):
            want = getattr(b, f)
            gap = max(gap, abs(getattr(a, f) - want) / max(abs(want), 1e-12))
    return gap


def check(name: str, value: float, limits: dict) -> dict:
    return {"name": name, "value": value, "limit": limits[name]}
