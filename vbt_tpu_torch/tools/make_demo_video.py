"""Compose a demo exercise video, with its analytic ground truth, from an
annotated test image.

Port of the JAX package's ``tools/make_demo_video.py`` with the same
picker, window arithmetic, time convention, returned tuple, options and
printed line. A camera window pans sinusoidally over the image, so the
annotated barbell plate moves vertically through the frame like reps; the
detector then tracks a real plate end to end. The pan is programmed, so
the plate's trajectory in frame coordinates is known exactly:
``--trajectory_out`` writes it as CSV (time, x, y, norm_plate_height,
norm_plate_width in the track dataframe's convention), and
:mod:`.e2e_acv_check` holds the whole pipeline's ROM/ACV against it.

:data:`DATA` is the reference project's test set, relative to the working
directory (the repository root; :data:`._reference.TEST_DIR`). Where it
is absent, :func:`vbt_tpu_torch.io.synthetic.write_demo_scene` writes a
stand-in scene into such a directory.

Usage: ``python -m vbt_tpu_torch.tools.make_demo_video OUT.mp4 [--reps 4]
[--fps 30] [--trajectory_out traj.csv]``
"""

from __future__ import annotations

import os

import numpy as np

from vbt_tpu_torch.contract.parsers import read_voc_annotations
from vbt_tpu_torch.tools._reference import TEST_DIR as DATA


def synthesize(out, reps=4, fps=30.0, seconds=12.0, trajectory_out=None, image=None):
    """Render the pan video; return (n_frames, analytic trajectory dict,
    (file name, plate box, (width, height))).

    The trajectory is exact by construction: the plate's annotated box is
    fixed in the source image and the window origin y0(t) is scripted, so
    the plate centre in frame coordinates is (box centre - origin) and the
    plate size is constant.

    ``image`` pins a file of :data:`DATA` instead of the first picker
    match. As in the JAX tool, when no image passes the picker the last
    image read is used.
    """
    import cv2

    annotations = read_voc_annotations(DATA)
    if image is not None:
        annotations = {image: annotations[image]}
    # Pick an image whose plate box leaves room to pan vertically.
    for fname, boxes in sorted(annotations.items()):
        img = cv2.imread(os.path.join(DATA, fname))
        if img is None or len(boxes) == 0:
            continue
        h, w, _ = img.shape
        ymin, xmin, ymax, xmax = boxes[0]
        box_h = ymax - ymin
        if h - (ymax - ymin) > h * 0.5 and box_h < h * 0.35 and w >= 400:
            break

    win_h = int(h * 0.55)
    # Pan range keeping the plate fully inside the window.
    lo = max(0, ymax - win_h + 5)
    hi = min(h - win_h, max(lo, ymin - 5))
    frames = int(seconds * fps)
    writer = cv2.VideoWriter(out, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, win_h))
    cx = (xmin + xmax) / 2.0
    cy = (ymin + ymax) / 2.0
    traj = {"time": [], "x": [], "y": [], "norm_plate_height": [], "norm_plate_width": []}
    for t in range(frames):
        phase = reps * 2 * np.pi * t / frames
        y0 = int(lo + (0.5 - 0.5 * np.cos(phase)) * (hi - lo))
        writer.write(img[y0 : y0 + win_h])
        # The track CLI's convention: time = frame_count / fps, frame_count from 1.
        traj["time"].append((t + 1) / fps)
        traj["x"].append(cx / w)
        traj["y"].append((cy - y0) / win_h)
        traj["norm_plate_height"].append((ymax - ymin) / win_h)
        traj["norm_plate_width"].append((xmax - xmin) / w)
    writer.release()

    if trajectory_out:
        import pandas as pd

        pd.DataFrame(traj).to_csv(trajectory_out, index=False)
    return frames, traj, (fname, boxes[0], (w, win_h))


def make_command():
    """Build the click command (click is imported here, not at import)."""
    import click

    @click.command()
    @click.argument("out", type=str)
    @click.option("--reps", default=4, type=int)
    @click.option("--fps", default=30.0, type=float)
    @click.option("--seconds", default=12.0, type=float)
    @click.option("--trajectory_out", default=None, type=str,
                  help="CSV path for the analytic plate trajectory.")
    def command(out, reps, fps, seconds, trajectory_out):
        frames, _, (fname, box, dims) = synthesize(out, reps, fps, seconds, trajectory_out)
        print(f"{out}: {frames} frames {dims[0]}x{dims[1]} from {fname} (plate box {box})")

    return command


def main(args=None, standalone_mode: bool = True):
    return make_command().main(args=args, standalone_mode=standalone_mode)


if __name__ == "__main__":
    main()
