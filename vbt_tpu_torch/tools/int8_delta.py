"""The int8 shipping gate: COCO AP of a checkpoint's int8 lane against its
float lane.

Port of the JAX package's ``tools/int8_delta.py`` with the same arguments,
defaults (but ``--data_dir``'s, as in :mod:`.ckpt_sweep`), printed lines
and exit codes. The int8 lane
(``DetectionPipeline.calibrate``, post-training quantization of every dense
convolution) stands in for the original project's int8 TFLite model, and a
checkpoint ships only if its int8 AP75 stays within ``--budget`` of the
float lane's. Calibration uses the first ``--calib_n`` readable train JPGs
in sorted order, resized to the model's input with cv2 as the JAX tool
does; the set is printed so any capture of the tool pins it. Both lanes
are evaluated on ``DATA_DIR/test`` in float32 (JAX's default dtype).

Exit code 1 when ``AP75_int8 - AP75_float < -budget``; a gain above the
budget is noted on stderr and not gated.

Usage: ``python -m vbt_tpu_torch.tools.int8_delta models/efficientdet_lite1_whole.msgpack``
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np
import torch

from vbt_tpu_torch.tools.ckpt_sweep import DEFAULT_DATA_DIR, format_metrics


def calibration_frames(data_dir: str, calib_n: int, size: int, err=None):
    """(calib_n, size, size, 3) uint8 RGB frames of the first ``calib_n``
    readable ``train/*.jpg`` in sorted order, and their names. Raises
    ``SystemExit`` when there are fewer."""
    import cv2

    err = err or sys.stderr
    train_jpgs = sorted(glob.glob(os.path.join(data_dir, "train", "*.jpg")))
    if not train_jpgs:
        raise SystemExit(f"no train images under {data_dir}/train")
    frames, names = [], []
    for p in train_jpgs:
        if len(frames) >= calib_n:
            break
        img = cv2.imread(p)
        if img is None:
            print(f"WARNING: skipping unreadable calibration image {p}", file=err)
            continue
        frames.append(cv2.resize(cv2.cvtColor(img, cv2.COLOR_BGR2RGB), (size, size)))
        names.append(os.path.basename(p))
    if len(frames) < calib_n:
        raise SystemExit(f"only {len(frames)} readable calibration images (need {calib_n})")
    return np.stack(frames), names


def gate(m_float: dict, m_int8: dict, budget: float, out=None, err=None) -> int:
    """Print both lanes' metrics and their deltas; 1 when int8 loses more
    than ``budget`` of AP75, else 0 (after ``OK``)."""
    out, err = out or sys.stdout, err or sys.stderr
    print(f"float: {format_metrics(m_float)}", file=out)
    print(f"int8 : {format_metrics(m_int8)}", file=out)
    delta75 = m_int8["AP75"] - m_float["AP75"]
    print(f"delta: AP {m_int8['AP'] - m_float['AP']:+.4f} "
          f"AP50 {m_int8['AP50'] - m_float['AP50']:+.4f} "
          f"AP75 {delta75:+.4f} (budget -{budget})", file=out)
    # Only a regression is gated: an int8 lane that gains AP75 is fine.
    if delta75 < -budget:
        print("FAIL: int8 AP75 regression exceeds budget", file=err)
        return 1
    if delta75 > budget:
        print(f"note: int8 improves AP75 by {delta75:+.4f} (> budget "
              "magnitude) — unusual but not gated", file=err)
    print("OK", file=out)
    return 0


def int8_delta(checkpoint: str, data_dir: str = DEFAULT_DATA_DIR, calib_n: int = 8,
               budget: float = 0.01, device="cuda", out=None, err=None) -> tuple[int, dict, dict]:
    """The body of the CLI: probe the card, calibrate, evaluate both lanes,
    gate. Returns (exit code, float metrics, int8 metrics)."""
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline
    from vbt_tpu_torch.train.evaluate import evaluate_model
    from vbt_tpu_torch.utils.cache import enable_persistent_cache
    from vbt_tpu_torch.utils.health import require_healthy_device

    out = out or sys.stdout
    enable_persistent_cache()
    require_healthy_device(device, context="int8_delta")  # a CPU device skips
    pipe = DetectionPipeline.from_model_arg(checkpoint, device=device, dtype=torch.float32)
    test_dir = os.path.join(data_dir, "test")
    frames, names = calibration_frames(data_dir, calib_n, pipe.spec.input_size, err)
    print(f"calib set ({len(names)}): {' '.join(names)}", file=out)
    m_float = evaluate_model(pipe, test_dir)
    m_int8 = evaluate_model(pipe.calibrate(frames), test_dir)
    return gate(m_float, m_int8, budget, out, err), m_float, m_int8


def make_command():
    """Build the click command (click is imported here, not at import)."""
    import click

    @click.command()
    @click.argument("checkpoint")
    @click.option("--data_dir", default=DEFAULT_DATA_DIR, show_default=True)
    @click.option("--calib_n", default=8, show_default=True,
                  help="Calibration images sampled from the train split.")
    @click.option("--budget", default=0.01, show_default=True,
                  help="Allowed |AP75_int8 - AP75_float| (absolute).")
    def command(checkpoint, data_dir, calib_n, budget):
        """COCO-metric delta of the int8 lane against float for one checkpoint."""
        sys.exit(int8_delta(checkpoint, data_dir, calib_n, budget)[0])

    return command


def main(args=None, standalone_mode: bool = True):
    return make_command().main(args=args, standalone_mode=standalone_mode)


if __name__ == "__main__":
    main()
