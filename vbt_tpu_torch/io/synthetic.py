"""Synthetic lifting scenes in numpy, made from a seed.

:func:`plate_frames`: a dark bumper-plate-like disc (rim, inner ring,
bright hub) on a bar moves vertically over a blocky textured background.
The shipped lite0 detector finds the disc with a high score, so the scene
drives detection and tracking end to end without video files or OpenCV:
``chip_smoke.py`` feeds its frames straight to the pipeline, and the tests
write them to a video.

:func:`plate_boxes` is the disc's analytic box in each of those frames,
the ground truth of the detector's evaluation on them; :func:`write_voc`
writes such frames and boxes as a PASCAL-VOC directory (JPG and XML, cv2
imported inside) for the evaluation and training CLIs.
:func:`write_demo_scene` writes one still image of a smaller disc with its
XML, the stand-in scene of the end-to-end tools (``tools/make_demo_video``
pans a window over it).
:func:`plate_track_data` is the disc's exact track as the track CLI's
capture dict, a stand-in for a tracked video's dataframe.
:func:`plate_track_meters` is the disc's trajectory in meters, which
:func:`write_kinovea_export` and :func:`write_qualisys_export` write in the
two ground-truth formats of the validation CLIs.

:func:`plate_detections` and :func:`crossing_detections` are tracker
inputs without a detector: per-frame detection rows of plates moving up
and down side by side (with misses, dropout and jitter; the scenes of
tests/test_tracker_scan.py) or crossing each other, padded to a fixed
number of rows a frame.
"""

from __future__ import annotations

import numpy as np

PLATE_AMPLITUDE = 0.15  # of the frame height: the disc's center moves +-0.15 H
PLATE_RADIUS = 0.3  # of the frame height
DEMO_DIAMETER = 0.2  # of the height: the disc of write_demo_scene


def plate_frames(n: int, height: int, width: int, seed: int = 0,
                 period: int = 32) -> np.ndarray:
    """``n`` uint8 RGB frames (n, height, width, 3); the disc's center
    moves as ``0.5 + PLATE_AMPLITUDE sin(2 pi t / period)`` of the height."""
    bg = _background(height, width, np.random.default_rng(seed))
    out = np.empty((n, height, width, 3), np.uint8)
    for t in range(n):
        cy = height * (0.5 + PLATE_AMPLITUDE * np.sin(2 * np.pi * t / period))
        out[t] = _draw_plate(bg.copy(), cy, width / 2, PLATE_RADIUS * height)
    return out


def _background(height: int, width: int, rng) -> np.ndarray:
    """Blocks of random grey-ish colour, a thirtieth of the height wide."""
    cell = max(1, height // 30)
    bg = rng.integers(90, 170, size=(-(-height // cell), -(-width // cell), 3), dtype=np.uint8)
    return np.repeat(np.repeat(bg, cell, 0), cell, 1)[:height, :width]


def _draw_plate(img: np.ndarray, cy: float, cx: float, r: float) -> np.ndarray:
    """Draw the bar through ``cy`` and the disc of radius ``r`` at (cy, cx)
    into ``img``; returns it."""
    height, width = img.shape[:2]
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    ring = max(1.0, height / 240)
    img[np.abs(yy - cy) <= height / 80] = 200  # the bar
    d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    img[d <= r] = 20
    img[d <= 0.55 * r] = 40
    img[np.abs(d - 0.55 * r) <= ring] = 90
    img[d <= 0.12 * r] = 220
    return img


def plate_boxes(n: int, height: int, width: int, period: int = 32) -> np.ndarray:
    """The disc's box ``[cy - r, cx - r, cy + r, cx + r]`` in pixels (float64)
    in each of the ``n`` frames :func:`plate_frames` draws at this size."""
    t = np.arange(n)
    cy = height * (0.5 + PLATE_AMPLITUDE * np.sin(2 * np.pi * t / period))
    cx = np.full(n, width / 2)
    r = PLATE_RADIUS * height
    return np.stack([cy - r, cx - r, cy + r, cx + r], axis=1)


def write_voc(root, sizes, n: int = 2, period: int = 5) -> None:
    """Write ``n`` plate frames at each (height, width) of ``sizes`` into
    the directory ``root`` as ``plate_{h}x{w}_{i}.jpg``, each with an XML
    holding the analytic plate box (label ``barbell``) and a box of another
    label (``person``)."""
    import os

    import cv2

    for h, w in sizes:
        frames = plate_frames(n, h, w, seed=h + w, period=period)
        boxes = np.rint(plate_boxes(n, h, w, period=period)).astype(int)
        for i, (img, box) in enumerate(zip(frames, boxes)):
            name = f"plate_{h}x{w}_{i}"
            cv2.imwrite(os.path.join(root, f"{name}.jpg"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            _write_voc_xml(os.path.join(root, f"{name}.xml"), f"{name}.jpg",
                           (("barbell", box), ("person", [0, 0, h // 4, w // 4])))


def _write_voc_xml(path, filename: str, objects) -> None:
    """A VOC annotation of the image ``filename``: one object a (label,
    [ymin, xmin, ymax, xmax]) of ``objects``."""
    body = "".join(
        f"<object><name>{label}</name><bndbox><xmin>{b[1]}</xmin><ymin>{b[0]}</ymin>"
        f"<xmax>{b[3]}</xmax><ymax>{b[2]}</ymax></bndbox></object>"
        for label, b in objects)
    with open(path, "w") as f:
        f.write(f"<annotation><filename>{filename}</filename>{body}</annotation>")


def write_demo_scene(root, name: str, size: int = 416, seed: int = 0) -> np.ndarray:
    """Write the demo video's stand-in scene into the directory ``root``:
    the RGB JPEG ``name`` (``size`` x ``size``), one disc of diameter
    ``DEMO_DIAMETER`` of the height at the centre on a textured background
    with a bar, and the VOC XML beside it (the image's stem) with that
    disc's box, label ``barbell``. Returns the box ``[ymin, xmin, ymax,
    xmax]`` in pixels (int).

    The disc leaves room for ``make_demo_video``'s pan: its box is under
    0.35 of the height and the window of 0.55 of the height moves it over
    about 0.35 of the height less 10 pixels. :func:`write_voc`'s plates,
    0.6 of the height, leave none."""
    import os

    import cv2

    c, r = size / 2, DEMO_DIAMETER * size / 2
    img = _draw_plate(_background(size, size, np.random.default_rng(seed)), c, c, r)
    box = np.rint([c - r, c - r, c + r, c + r]).astype(int)
    cv2.imwrite(os.path.join(root, name), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    _write_voc_xml(os.path.join(root, os.path.splitext(name)[0] + ".xml"), name,
                   (("barbell", box),))
    return box


def plate_track_data(n: int, height: int, width: int, period: int = 32,
                     fps: float = 30.0) -> dict:
    """The disc's exact track (id 1) over the ``n`` frames :func:`plate_frames`
    draws at this size, as the columnar capture dict that
    ``contract.schema.build_track_df`` takes: centers and box sizes
    normalized by the frame, velocities the change from the frame before
    (0 in the first), frame ``t`` at ``(t + 1) / fps`` seconds."""
    boxes = plate_boxes(n, height, width, period)
    x = (boxes[:, 1] + boxes[:, 3]) / 2 / width
    y = (boxes[:, 0] + boxes[:, 2]) / 2 / height
    return {"id": [1] * n, "time": ((np.arange(n) + 1) / fps).tolist(),
            "x": x.tolist(), "y": y.tolist(),
            "dx": np.diff(x, prepend=x[0]).tolist(), "dy": np.diff(y, prepend=y[0]).tolist(),
            "norm_plate_height": ((boxes[:, 2] - boxes[:, 0]) / height).tolist(),
            "norm_plate_width": ((boxes[:, 3] - boxes[:, 1]) / width).tolist()}


def plate_track_meters(time: np.ndarray, height: int, width: int, period: int = 32,
                       fps: float = 30.0, plate_diameter: float = 0.45):
    """The disc's center in meters, y up, at ``time`` seconds on a tracking
    dataframe's clock (frame ``t`` at ``(t + 1) / fps``) of the frames
    :func:`plate_frames` draws at this size; the disc's diameter is
    ``plate_diameter``. Returns (x, y), float64."""
    t = np.asarray(time, np.float64) * fps - 1
    cy = height * (0.5 + PLATE_AMPLITUDE * np.sin(2 * np.pi * t / period))
    meters = plate_diameter / (2 * PLATE_RADIUS * height)  # per pixel
    return np.full_like(cy, width / 2 * meters), -cy * meters


def write_kinovea_export(path, time, x, y) -> None:
    """A Kinovea trajectory export of (time s, x m, y m): ``#`` comments,
    space-delimited ``T X Y`` rows, x and y in centimetres with comma
    decimals."""
    with open(path, "w") as f:
        f.write("# Kinovea Trajectory data export\n# T X Y\n")
        for t, xv, yv in zip(time, x, y):
            cm = f"{100 * xv:.6f} {100 * yv:.6f}".replace(".", ",")
            f.write(f"{t:.6f} {cm}\n")


def write_qualisys_export(path, time, x, y, frequency: int = 100) -> None:
    """A Qualisys motion-capture tsv of (time s, x m, y m) for the marker
    ``Osa L``: 11 header rows, tab-delimited, millimetres, x negated, y the
    Z column."""
    header = [("NO_OF_FRAMES", len(time)), ("NO_OF_CAMERAS", 12), ("NO_OF_MARKERS", 1),
              ("FREQUENCY", frequency), ("NO_OF_ANALOG", 0), ("ANALOG_FREQUENCY", 0),
              ("DESCRIPTION", "--"), ("TIME_STAMP", "2026-01-01, 00:00:00"),
              ("DATA_INCLUDED", "3D"), ("MARKER_NAMES", "Osa L"),
              ("TRAJECTORY_TYPES", "Measured")]
    with open(path, "w") as f:
        for key, value in header:
            f.write(f"{key}\t{value}\n")
        f.write("Frame\tTime\tOsa L X\tOsa L Y\tOsa L Z\n")
        for i, (t, xv, yv) in enumerate(zip(time, x, y)):
            f.write(f"{i + 1}\t{t:.5f}\t{-1000 * xv:.4f}\t250.0000\t{1000 * yv:.4f}\n")


def pad_detections(frames: list[np.ndarray], d_cap: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-frame (n_i, 6) rows -> (T, d_cap, 6) float64 and the (T, d_cap) mask."""
    dets = np.zeros((len(frames), d_cap, 6))
    valid = np.zeros((len(frames), d_cap), bool)
    for t, f in enumerate(frames):
        n = min(len(f), d_cap)
        dets[t, :n] = f[:n]
        valid[t, :n] = True
    return dets, valid


def plate_detections(n_frames: int = 60, n_obj: int = 2, miss=(), jitter: float = 0.004,
                     seed: int = 0, dropout: float = 0.0,
                     d_cap: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Rows [x1, y1, x2, y2, score, 0] of ``n_obj`` plates side by side, each
    moving as ``0.3 + 0.3 sin``; no rows on the frames in ``miss``, each row
    dropped with probability ``dropout``, Gaussian jitter on the boxes."""
    rng = np.random.default_rng(seed)
    frames = []
    for f in range(n_frames):
        rows = []
        if f not in miss:
            for k in range(n_obj):
                if dropout and rng.uniform() < dropout:
                    continue
                x0 = 0.1 + 0.35 * k
                y0 = 0.3 + 0.3 * np.sin(2 * np.pi * (f / n_frames + k * 0.3))
                rows.append([x0, y0, x0 + 0.18, y0 + 0.15, 0.5 + 0.4 * rng.uniform(), 0])
        rows = np.asarray(rows).reshape(-1, 6)
        if jitter and len(rows):
            rows[:, :4] += rng.normal(0, jitter, size=rows[:, :4].shape)
        frames.append(rows)
    return pad_detections(frames, d_cap)


def crossing_detections(n_frames: int = 70, seed: int = 0,
                        d_cap: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Two plates crossing each other horizontally, their boxes overlapping
    midway, listed in a random order each frame."""
    rng = np.random.default_rng(seed)
    frames = []
    for f in range(n_frames):
        a = 0.05 + 0.6 * f / n_frames
        b = 0.65 - 0.6 * f / n_frames
        rows = np.array([[a, 0.40, a + 0.2, 0.60, 0.9, 0], [b, 0.42, b + 0.2, 0.62, 0.8, 0]])
        rows[:, :4] += rng.normal(0, 0.003, size=(2, 4))
        frames.append(rows[rng.permutation(2)])
    return pad_detections(frames, d_cap)


def tracker_cases(d_cap: int = 8) -> dict:
    """The tracker's test scenes: {name: (config kind, config kwargs, (dets,
    valid), skip_empty_frames)}: SORT and OC-SORT, misses and dropout (OCR,
    ORU), crossing plates, more births than slots, empty frames with the
    skip on and off."""
    ocsort = dict(max_age=30, asso="diou", iou_threshold=0.1, max_tracks=d_cap)
    scene = lambda **kw: plate_detections(d_cap=d_cap, **kw)  # noqa: E731
    return {
        "sort_simple": ("sort", dict(max_age=30, iou_threshold=0.1, max_tracks=d_cap),
                        scene(n_frames=50, n_obj=2, seed=1), False),
        "sort_dropout": ("sort", dict(max_age=5, iou_threshold=0.2, max_tracks=d_cap),
                         scene(n_frames=80, n_obj=3, seed=2, dropout=0.15), False),
        "ocsort_simple": ("ocsort", ocsort, scene(n_frames=50, n_obj=2, seed=3), False),
        "ocsort_gap_ocr_oru": ("ocsort", ocsort,
                               scene(n_frames=60, n_obj=1, miss=set(range(20, 28)), seed=4),
                               False),
        "ocsort_gap_skip_empty": ("ocsort", ocsort,
                                  scene(n_frames=60, n_obj=1, miss=set(range(20, 28)), seed=4),
                                  True),
        "ocsort_noisy_dropout": ("ocsort", dict(ocsort, max_age=10),
                                 scene(n_frames=100, n_obj=3, seed=5, dropout=0.1,
                                       jitter=0.006), True),
        "ocsort_crossing": ("ocsort", ocsort, crossing_detections(70, seed=6, d_cap=d_cap),
                            True),
        "ocsort_births_beyond_slots": ("ocsort", dict(ocsort, max_age=10, max_tracks=4),
                                       scene(n_frames=60, n_obj=6, seed=7, dropout=0.2,
                                             jitter=0.01), True),
    }


def ragged_clips(d_cap: int = 8) -> list[tuple[np.ndarray, np.ndarray]]:
    """Four clips of 50, 72, 31 and 64 frames, with dropout and misses."""
    return [plate_detections(n, k, seed=s, dropout=0.1, miss={12, 13} if s % 2 else (),
                             d_cap=d_cap)
            for n, k, s in [(50, 2, 10), (72, 1, 11), (31, 3, 12), (64, 2, 13)]]
