"""The plain tracker and phase analysis: the host OC-SORT (numpy, float64)
over per-frame detection rows, the capture dict the track CLI writes, and
the plot CLI's smoothing and phase segmentation of one followed track.

Frozen copies of the port's host lanes (``cli/track.py::run_host_tracker``
and ``tracks_to_data``, ``tracking/ocsort.py``, ``analysis/velocity.py``),
which tests held against the JAX package and the card's kernels against;
they import nothing of the program.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.analysis.smoothing import expanding_mean_np, rolling_mean_np
from benchmark.reference.analysis.velocity import VelocityTracker
from benchmark.reference.tracking.ocsort import OCSort

MAX_AGE = 30
TRACK_SLOTS = 16


def host_tracks(dets: np.ndarray, valid: np.ndarray) -> dict:
    """The reference's OC-SORT (max_age 30, DIoU, IoU 0.1), frame by frame,
    16 slots reported a frame."""
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
    data = {"id": [], "time": [], "x": [], "y": [], "dx": [], "dy": [],
            "norm_plate_height": [], "norm_plate_width": []}
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


def followed_phases(data: dict, follow_id: int, plate_diameter: float, flush: bool,
                    dtype=np.float64) -> list:
    """The plot CLI's analysis of the rows of ``follow_id``: 5-sample
    trailing means of x, y, dx, dy, expanding means of the plate's size,
    then the phase state machine; ``flush`` ends an open phase as the end of
    a stream does. ``dtype`` float32 computes it all in float32 (numpy
    scalars of that type through the state machine), the control of the
    configuration's float64 analysis."""
    ids = np.asarray(data["id"])
    keep = ids == follow_id
    cols = [np.asarray(data[c], np.float64)[keep] for c in
            ("time", "x", "y", "dx", "dy", "norm_plate_height", "norm_plate_width")]
    t, x, y, dx, dy, h, w = cols
    smoothed = [t, *(rolling_mean_np(a, 5) for a in (x, y, dx, dy)),
                expanding_mean_np(h), expanding_mean_np(w)]
    if dtype != np.float64:
        cols = [c.astype(dtype) for c in cols]
        t, x, y, dx, dy, h, w = cols
        n = np.minimum(np.arange(1, len(t) + 1), 5).astype(dtype)
        roll = [np.stack([np.concatenate([np.zeros(k, dtype), a[:len(a) - k]])
                          for k in range(5)]).sum(0, dtype=dtype) / n for a in (x, y, dx, dy)]
        grow = np.arange(1, len(t) + 1, dtype=dtype)
        smoothed = [t, *roll, np.cumsum(h, dtype=dtype) / grow, np.cumsum(w, dtype=dtype) / grow]
    vt = VelocityTracker(dtype(plate_diameter))
    for row in zip(*smoothed):
        vt.process_measurements(*row)
    if flush:
        vt.end_processing()
    return list(vt.phases)
