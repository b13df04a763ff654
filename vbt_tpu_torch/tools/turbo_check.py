"""Prove or retire the turbo backbone (kernel K2) on the card.

Port of the JAX package's ``tools/turbo_check.py``:

1. **Numerics**: the shipped lite0 checkpoint over the reference's test
   images (:func:`test_images`: every ``reference/data/test/*.jpg`` under
   the working directory, read as JAX's tool reads the reference's test
   set at its absolute location) or, where that directory holds none,
   over ``--n_images`` synthetic plate images (:func:`plate_images`, from
   ``io/synthetic.py``) after a line that says so, with the ``xla``
   backbone and the ``turbo`` one, in the device's serving dtype (bf16 and
   the kernels on the card). Rows are greedily IoU-matched in score order
   per image (:func:`compare`, JAX's loop): counts must be equal, every
   confident row (score > ``CONFIDENT``) must match at IoU >= 0.5 within
   ``BUDGET_BOX`` and ``BUDGET_SCORE``; the sub-threshold tail is reported,
   not gated. The ``images:`` line and the JSON record name the source
   (the directory, or ``synthetic``).
2. **Speed**: the marginal ms of the whole ``detect_batch`` (JAX's 4/12
   loops, 3 trials; :mod:`._timing`) at B = 64 and 128, xla against turbo.

Exit code 1 when the numerics diverge beyond the budget.

Usage: ``python -m vbt_tpu_torch.tools.turbo_check [--n_images 32] [--batches 64 128] [--device cpu]``
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from vbt_tpu_torch.tools._reference import TEST_DIR

BUDGET_BOX = 1e-2  # normalized coordinates; one bf16 step is 2^-8 ~ 4e-3
# bf16 reorders the convolutions' sums through ~40 backbone layers; a ~0.1
# logit divergence maps to <= 5e-2 through the sigmoid.
BUDGET_SCORE = 5e-2
CONFIDENT = 0.3  # rows above this score must match 1:1 at IoU >= 0.5
N_IMAGES = 32  # synthetic plates where TEST_DIR holds no image
BATCHES = (64, 128)
# The speed half's loops (JAX's tool: 4 and 12 calls, 3 trials).
N_SHORT, N_LONG, TRIALS = 4, 12, 3


def _iou_one_to_many(a, b):
    y1 = np.maximum(a[0], b[:, 0])
    x1 = np.maximum(a[1], b[:, 1])
    y2 = np.minimum(a[2], b[:, 2])
    x2 = np.minimum(a[3], b[:, 3])
    inter = np.clip(y2 - y1, 0, None) * np.clip(x2 - x1, 0, None)
    aa = (a[2] - a[0]) * (a[3] - a[1])
    bb = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(aa + bb - inter, 1e-9)


def plate_images(n: int, size: int) -> np.ndarray:
    """``n`` uint8 RGB (size, size) images of the synthetic plate: four
    backgrounds (seeds 0-3), the disc at as many heights a background."""
    from vbt_tpu_torch.io.synthetic import plate_frames

    per = -(-n // 4)
    return np.concatenate([plate_frames(per, size, size, seed=s, period=per)
                           for s in range(4)])[:n]


def test_images(size: int) -> tuple[np.ndarray, int]:
    """Every ``*.jpg`` of :data:`TEST_DIR` in sorted order, read as JAX's tool
    reads them (``tools/turbo_check.py:107-111``: cv2, BGR to RGB, resized
    to (size, size) with ``INTER_LINEAR``), stacked as uint8 RGB, and the
    file count; ``(0, size, size, 3)`` and 0 when there is none."""
    files = sorted(glob.glob(os.path.join(TEST_DIR, "*.jpg")))
    if not files:
        return np.zeros((0, size, size, 3), np.uint8), 0
    import cv2

    imgs = [cv2.resize(cv2.cvtColor(cv2.imread(f), cv2.COLOR_BGR2RGB), (size, size),
                       interpolation=cv2.INTER_LINEAR) for f in files]
    return np.stack(imgs), len(files)


def numerics_images(n_images: int, size: int) -> tuple[np.ndarray, str]:
    """The numerics' images and their source: :func:`test_images` of
    :data:`TEST_DIR`, or, where it holds none, ``n_images`` synthetic
    plates (:func:`plate_images`) after a line that says so."""
    images, n = test_images(size)
    if n:
        return images, TEST_DIR
    print(f"{TEST_DIR}: no *.jpg, the numerics run on {n_images} synthetic plate images",
          flush=True)
    return plate_images(n_images, size), "synthetic"


def detections(pipes: dict, frames) -> tuple[dict, dict, dict]:
    """(counts, boxes, scores) of each pipeline's ``detect_batch`` as numpy
    (float32 boxes and scores)."""
    det = {k: p.detect_batch(frames) for k, p in pipes.items()}
    return ({k: v.count.cpu().numpy() for k, v in det.items()},
            {k: v.boxes.float().cpu().numpy() for k, v in det.items()},
            {k: v.scores.float().cpu().numpy() for k, v in det.items()})


def compare(counts: dict, boxes: dict, scores: dict) -> dict:
    """JAX's greedy IoU matching of the turbo rows to the xla ones, in the
    xla score order, image by image (``tools/turbo_check.py:117-156``)."""
    ref, other = "xla", "turbo"
    n_img = len(counts[ref])
    count_match = int((counts[ref] == counts[other]).sum())
    smax = bmax = 0.0  # confident rows, gated
    tail_bmax = 0.0  # the sub-threshold tail, reported
    unmatched_tail = unmatched_conf = 0
    for i in range(n_img):
        n = int(counts[ref][i])
        used = np.zeros(n, bool)
        for j in range(n):
            confident = scores[ref][i, j] > CONFIDENT
            ious = _iou_one_to_many(boxes[ref][i, j], boxes[other][i, :n])
            ious[used] = -1.0
            k = int(np.argmax(ious)) if n else 0
            if n == 0 or ious[k] < 0.5:
                if confident:
                    unmatched_conf += 1
                else:
                    unmatched_tail += 1
                continue
            used[k] = True
            bd = float(np.abs(boxes[ref][i, j] - boxes[other][i, k]).max())
            if confident:
                bmax = max(bmax, bd)
                smax = max(smax, float(abs(scores[ref][i, j] - scores[other][i, k])))
            else:
                tail_bmax = max(tail_bmax, bd)
    ok = (count_match == n_img and unmatched_conf == 0 and smax <= BUDGET_SCORE
          and bmax <= BUDGET_BOX)
    return {"numerics_ok": ok, "images": n_img, "count_match": count_match,
            "score_delta": smax, "box_delta": bmax, "unmatched_confident": unmatched_conf,
            "unmatched_tail": unmatched_tail, "tail_box_delta": tail_bmax}


def speed(pipes: dict, batches, size: int, device, trials: int | None = None) -> dict:
    """Marginal ``detect_batch`` ms and frames/s of each pipeline at each
    batch, over 4 distinct uint8 batches from seed 0 on ``device``
    (``trials`` short/long pairs, :data:`TRIALS` by default)."""
    from vbt_tpu_torch.bench import frame_batches
    from vbt_tpu_torch.tools import _timing

    rng = np.random.default_rng(0)
    out = {}
    for batch in batches:
        frames = frame_batches(rng, batch, size, device, n=4)
        for name, p in pipes.items():
            ms = _timing.marginal_ms(lambda i, p=p: p.detect_batch(frames[i % len(frames)]),
                                     n_short=N_SHORT, n_long=N_LONG,
                                     trials=TRIALS if trials is None else trials)
            out[f"{name}_b{batch}_ms"] = ms
            out[f"{name}_b{batch}_fps"] = batch / ms * 1e3
            print(f"detect {name:6s} b{batch}: {ms:8.3f} ms/batch {batch / ms * 1e3:9.1f} "
                  "frames/s", flush=True)
    return out


def pipelines(device, **by_name) -> dict:
    """The shipped lite0 pipeline once for each ``name=kwargs``."""
    from vbt_tpu_torch.bench import CKPT
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline

    return {name: DetectionPipeline.from_model_arg(CKPT, device=device, **kw)
            for name, kw in by_name.items()}


def parse(argv, doc: str) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    parser.add_argument("--n_images", type=int, default=N_IMAGES,
                        help="synthetic plate images when the test directory holds none")
    parser.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    from vbt_tpu_torch.tools._timing import prepare_device

    args = parse(argv, __doc__)
    dev = prepare_device(args.device, "turbo_check")
    pipes = pipelines(dev, xla={"backbone": "xla"}, turbo={"backbone": "turbo"})
    size = pipes["xla"].spec.input_size
    images, source = numerics_images(args.n_images, size)
    report = compare(*detections(pipes, images))
    report["source"] = source
    print(f"images: {report['images']} ({source})", flush=True)
    print(f"numerics: {report['count_match']}/{report['images']} images count-equal; "
          f"confident (> {CONFIDENT}) IoU-matched max|score delta| {report['score_delta']:.2e}, "
          f"max|box delta| {report['box_delta']:.2e} (budget {BUDGET_SCORE:.0e}/"
          f"{BUDGET_BOX:.0e}); unmatched rows: {report['unmatched_confident']} confident, "
          f"{report['unmatched_tail']} tail (tail matched max|box delta| "
          f"{report['tail_box_delta']:.2e})", flush=True)
    report.update(speed(pipes, args.batches, size, dev))
    print("JSON:", json.dumps(report))
    return 0 if report["numerics_ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
