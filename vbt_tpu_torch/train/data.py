"""PASCAL-VOC detection dataset loading and batching (host side).

Port of ``vbt_tpu.train.data``: images resize to the model's square input
(cv2, imported inside the functions that use it), boxes scale along, and
ground truth is padded to a fixed per-image capacity so batches have static
shapes. :func:`raw_batches` feeds the device augmentation
(:mod:`vbt_tpu_torch.train.augment`); :func:`batches` is the host lane with
per-image flip and cv2 scale jitter.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass

import numpy as np

from vbt_tpu_torch.contract.parsers import read_voc_annotations
from vbt_tpu_torch.ops.preprocess import MEAN_RGB, STDDEV_RGB


@dataclass
class DetectionDataset:
    images: np.ndarray  # (N, S, S, 3) uint8
    boxes: np.ndarray  # (N, G, 4) float32 [ymin,xmin,ymax,xmax] in input px
    valid: np.ndarray  # (N, G) bool
    names: list[str]

    def __len__(self):
        return self.images.shape[0]


def load_voc_dataset(data_dir: str, input_size: int, max_boxes: int = 16,
                     label: str = "barbell") -> DetectionDataset:
    import cv2

    annotations = read_voc_annotations(data_dir, label=label)
    jpgs = {os.path.basename(p): p for p in glob.glob(os.path.join(data_dir, "*.jpg"))}

    images, boxes, valid, names = [], [], [], []
    for fname, gt in sorted(annotations.items()):
        if fname not in jpgs:
            continue
        img = cv2.cvtColor(cv2.imread(jpgs[fname]), cv2.COLOR_BGR2RGB)
        h, w, _ = img.shape
        img = cv2.resize(img, (input_size, input_size), interpolation=cv2.INTER_LINEAR)
        scale = np.array([input_size / h, input_size / w, input_size / h, input_size / w])
        gt_scaled = gt.astype(np.float32) * scale.astype(np.float32)
        b = np.zeros((max_boxes, 4), np.float32)
        v = np.zeros((max_boxes,), bool)
        n = min(len(gt_scaled), max_boxes)
        b[:n] = gt_scaled[:n]
        v[:n] = True
        images.append(img)
        boxes.append(b)
        valid.append(v)
        names.append(fname)
    return DetectionDataset(images=np.stack(images), boxes=np.stack(boxes),
                            valid=np.stack(valid), names=names)


def normalize_images(images_uint8: np.ndarray) -> np.ndarray:
    return (images_uint8.astype(np.float32) - MEAN_RGB) / STDDEV_RGB


def _epoch_indices(n: int, batch_size: int, rng: np.random.Generator, drop_remainder: bool):
    """One shuffled epoch of index batches; a short last batch (kept when
    ``drop_remainder`` is false) is filled from the start of the order."""
    order = rng.permutation(n)
    stop = n - (n % batch_size) if drop_remainder else n
    for i in range(0, stop, batch_size):
        idx = order[i:i + batch_size]
        if len(idx) < batch_size:
            idx = np.concatenate([idx, order[:batch_size - len(idx)]])
        yield idx


def raw_batches(ds: DetectionDataset, batch_size: int, rng: np.random.Generator,
                drop_remainder: bool = True):
    """Shuffled epoch of raw uint8 batches for the device augmentation:
    host work is just an index gather."""
    for idx in _epoch_indices(len(ds), batch_size, rng, drop_remainder):
        yield ds.images[idx], ds.boxes[idx], ds.valid[idx]


def _hflip_one(image, boxes, size):
    flipped = boxes.copy()
    flipped[:, 1] = size - boxes[:, 3]
    flipped[:, 3] = size - boxes[:, 1]
    return image[:, ::-1, :], flipped


def _scale_jitter_one(image, boxes, valid, size, rng, lo=0.6, hi=1.4):
    """Random resize + crop/pad back to ``size``. Boxes are clipped; boxes
    that collapse are invalidated."""
    import cv2

    scale = rng.uniform(lo, hi)
    new = max(int(round(size * scale)), 8)
    resized = cv2.resize(image, (new, new), interpolation=cv2.INTER_LINEAR)
    out = np.zeros_like(image)
    b = boxes * scale
    if new >= size:
        y0 = rng.integers(0, new - size + 1)
        x0 = rng.integers(0, new - size + 1)
        out[:, :, :] = resized[y0:y0 + size, x0:x0 + size]
        b = b - np.array([y0, x0, y0, x0], np.float32)
    else:
        y0 = rng.integers(0, size - new + 1)
        x0 = rng.integers(0, size - new + 1)
        out[y0:y0 + new, x0:x0 + new] = resized
        b = b + np.array([y0, x0, y0, x0], np.float32)
    b = np.clip(b, 0, size)
    still = valid & ((b[:, 2] - b[:, 0]) > 2) & ((b[:, 3] - b[:, 1]) > 2)
    return out, b.astype(np.float32), still


def batches(ds: DetectionDataset, batch_size: int, rng: np.random.Generator,
            augment: bool = True, drop_remainder: bool = True):
    """Shuffled epoch of dicts {images, gt_boxes, gt_valid} (static shapes),
    images NHWC float32 normalized. Train-time augmentation: per-image
    horizontal flip (p = 0.5) and scale jitter + crop/pad (p = 0.5)."""
    size = ds.images.shape[1]
    for idx in _epoch_indices(len(ds), batch_size, rng, drop_remainder):
        imgs = ds.images[idx].copy()
        boxes = ds.boxes[idx].copy()
        valid = ds.valid[idx].copy()
        if augment:
            for j in range(len(idx)):
                if rng.uniform() < 0.5:
                    imgs[j], boxes[j] = _hflip_one(imgs[j], boxes[j], size)
                if rng.uniform() < 0.5:
                    imgs[j], boxes[j], valid[j] = _scale_jitter_one(
                        imgs[j], boxes[j], valid[j], size, rng)
        yield {"images": normalize_images(imgs), "gt_boxes": boxes, "gt_valid": valid}
