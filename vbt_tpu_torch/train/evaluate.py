"""COCO-style detector evaluation on a VOC directory, in original pixels.

Port of ``vbt_tpu.train.evaluate``. :func:`evaluate_model` reads every
annotated JPG (cv2, imported inside), resizes it to the model input on the
host, detects in batches of 32 (the last padded with its final image) and
scores the detections, scaled back to each image's pixels, with
:func:`~vbt_tpu_torch.train.coco_eval.coco_metrics`.
:func:`detect_images` is the in-memory lane the eval CLI takes: each RGB
image at its own size, batch 1, resized by the pipeline on its device.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from vbt_tpu_torch.contract.parsers import read_voc_annotations
from vbt_tpu_torch.train.coco_eval import coco_metrics

EVAL_BATCH = 32


def _to_pixels(det, j: int, hw: tuple[int, int]) -> dict:
    """Image ``j`` of a Detections batch: its valid boxes in pixels of an
    (h, w) image (float64) and their scores (float64)."""
    h, w = hw
    n = int(det.count[j])
    boxes = det.boxes[j, :n].cpu().numpy().astype(np.float64) * np.array([h, w, h, w])
    return {"boxes": boxes, "scores": det.scores[j, :n].cpu().numpy().astype(np.float64)}


def detect_resized(pipeline, images: list[np.ndarray],
                   dims: list[tuple[int, int]]) -> list[dict]:
    """Detections of uint8 RGB images already at the model input size, in
    batches of ``EVAL_BATCH`` (the last padded with its final image), each
    scaled to the pixels of its original ``dims`` (h, w)."""
    detections = []
    for i in range(0, len(images), EVAL_BATCH):
        chunk = images[i:i + EVAL_BATCH]
        frames = np.stack(chunk + [chunk[-1]] * (EVAL_BATCH - len(chunk)))
        det = pipeline.detect_batch(frames)
        detections += [_to_pixels(det, j, dims[i + j]) for j in range(len(chunk))]
    return detections


def detect_images(pipeline, images: list[np.ndarray]) -> list[dict]:
    """Detections of uint8 RGB images of any size, one at a time (batch 1,
    resized on the pipeline's device), in each image's pixels."""
    return [_to_pixels(pipeline.detect_batch(img[None]), 0, img.shape[:2]) for img in images]


def evaluate_model(pipeline, data_dir: str, label: str = "barbell") -> dict:
    """COCO AP / AP50 / AP75 of ``pipeline`` over every annotated JPG of
    ``data_dir``, in the images' own pixels."""
    import cv2

    annotations = read_voc_annotations(data_dir, label=label)
    jpgs = {os.path.basename(p): p for p in glob.glob(os.path.join(data_dir, "*.jpg"))}
    size = pipeline.spec.input_size
    images, dims, ground_truths = [], [], []
    for fname, gt in sorted(annotations.items()):
        if fname not in jpgs:
            continue
        img = cv2.cvtColor(cv2.imread(jpgs[fname]), cv2.COLOR_BGR2RGB)
        dims.append(img.shape[:2])
        images.append(cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR))
        ground_truths.append(gt.astype(np.float64))
    return coco_metrics(detect_resized(pipeline, images, dims), ground_truths)
