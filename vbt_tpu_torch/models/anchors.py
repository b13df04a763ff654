"""Multi-scale anchors (numpy) and box decode (torch).

Copy of ``vbt_tpu.models.anchors``: RetinaNet-style anchors over pyramid
levels 3-7, 3 octave scales x 3 aspect ratios per cell (9 anchors/cell),
level-major, row-major, per-cell anchor fastest — the order the detector's
head flatten produces (:mod:`vbt_tpu_torch.models.efficientdet`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

MIN_LEVEL = 3
MAX_LEVEL = 7
NUM_SCALES = 3
ASPECT_RATIOS = (1.0, 2.0, 0.5)
ANCHORS_PER_CELL = NUM_SCALES * len(ASPECT_RATIOS)


@dataclass(frozen=True)
class AnchorConfig:
    input_size: int
    anchor_scale: float = 3.0  # lite family default
    min_level: int = MIN_LEVEL
    max_level: int = MAX_LEVEL
    num_scales: int = NUM_SCALES
    aspect_ratios: tuple[float, ...] = ASPECT_RATIOS


def feat_sizes(input_size: int, min_level: int = MIN_LEVEL, max_level: int = MAX_LEVEL):
    """Spatial size per level from successive halving (ceil), e.g.
    320 -> {3:40, 4:20, 5:10, 6:5, 7:3}."""
    sizes = {}
    size = input_size
    for level in range(1, max_level + 1):
        size = (size + 1) // 2
        if level >= min_level:
            sizes[level] = size
    return sizes


def generate_anchors(cfg: AnchorConfig) -> np.ndarray:
    """All anchors as an (N, 4) float32 array of [ycenter, xcenter, h, w] in
    pixels, level-major then row-major then (scale, ratio)."""
    sizes = feat_sizes(cfg.input_size, cfg.min_level, cfg.max_level)
    boxes = []
    for level in range(cfg.min_level, cfg.max_level + 1):
        stride = 2**level
        fs = sizes[level]
        base = cfg.anchor_scale * stride
        shapes = []
        for s in range(cfg.num_scales):
            octave = 2 ** (s / cfg.num_scales)
            for ratio in cfg.aspect_ratios:
                shapes.append((base * octave / math.sqrt(ratio),
                               base * octave * math.sqrt(ratio)))
        shapes = np.array(shapes, dtype=np.float32)  # (A, 2) = (h, w)

        yc = (np.arange(fs, dtype=np.float32) + 0.5) * stride
        xc = (np.arange(fs, dtype=np.float32) + 0.5) * stride
        yy, xx = np.meshgrid(yc, xc, indexing="ij")
        centers = np.stack([yy, xx], axis=-1).reshape(-1, 1, 2)
        hw = np.broadcast_to(shapes[None], (fs * fs, shapes.shape[0], 2))
        level_boxes = np.concatenate(
            [np.broadcast_to(centers, hw.shape), hw], axis=-1
        ).reshape(-1, 4)
        boxes.append(level_boxes)
    return np.concatenate(boxes, axis=0)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Decode (ty, tx, th, tw) deltas against [yc, xc, h, w] anchors into
    [ymin, xmin, ymax, xmax] in the anchors' pixel units. Broadcasts over
    leading dims."""
    anchors = anchors.to(deltas.dtype)
    ya, xa, ha, wa = anchors.unbind(-1)
    ty, tx, th, tw = deltas.unbind(-1)
    yc = ty * ha + ya
    xc = tx * wa + xa
    h = torch.exp(th) * ha
    w = torch.exp(tw) * wa
    return torch.stack([yc - h / 2, xc - w / 2, yc + h / 2, xc + w / 2], dim=-1)
