"""Box affinity measures and direction consistency for track association.

Copy of ``vbt_tpu.tracking.association``; array-namespace generic
(``xp``, numpy on the host), with ``*_torch`` counterparts for the batched
scan tracker that broadcast over leading (clips) axes. Implements the
affinity family the reference's OC-SORT dependency exposes via
``asso_func`` — the reference selects ``"diou"`` (track.py:157) — plus the
observation-centric momentum term (direction consistency) from the OC-SORT
paper (Cao et al., 2022).

All functions take boxes as [x1, y1, x2, y2] rows and return (N, M) matrices
for N detections x M tracks.
"""

from __future__ import annotations

import numpy as np
import torch


def iou_batch(dets, trks, xp=np, eps=1e-10):
    d = xp.expand_dims(xp.asarray(dets), 1)  # (N,1,4)
    t = xp.expand_dims(xp.asarray(trks), 0)  # (1,M,4)
    xx1 = xp.maximum(d[..., 0], t[..., 0])
    yy1 = xp.maximum(d[..., 1], t[..., 1])
    xx2 = xp.minimum(d[..., 2], t[..., 2])
    yy2 = xp.minimum(d[..., 3], t[..., 3])
    inter = xp.maximum(0.0, xx2 - xx1) * xp.maximum(0.0, yy2 - yy1)
    area_d = (d[..., 2] - d[..., 0]) * (d[..., 3] - d[..., 1])
    area_t = (t[..., 2] - t[..., 0]) * (t[..., 3] - t[..., 1])
    return inter / (area_d + area_t - inter + eps)


def giou_batch(dets, trks, xp=np, eps=1e-10):
    d = xp.expand_dims(xp.asarray(dets), 1)
    t = xp.expand_dims(xp.asarray(trks), 0)
    iou = iou_batch(dets, trks, xp, eps)
    # smallest enclosing box
    ex1 = xp.minimum(d[..., 0], t[..., 0])
    ey1 = xp.minimum(d[..., 1], t[..., 1])
    ex2 = xp.maximum(d[..., 2], t[..., 2])
    ey2 = xp.maximum(d[..., 3], t[..., 3])
    area_e = (ex2 - ex1) * (ey2 - ey1)
    area_d = (d[..., 2] - d[..., 0]) * (d[..., 3] - d[..., 1])
    area_t = (t[..., 2] - t[..., 0]) * (t[..., 3] - t[..., 1])
    xx1 = xp.maximum(d[..., 0], t[..., 0])
    yy1 = xp.maximum(d[..., 1], t[..., 1])
    xx2 = xp.minimum(d[..., 2], t[..., 2])
    yy2 = xp.minimum(d[..., 3], t[..., 3])
    inter = xp.maximum(0.0, xx2 - xx1) * xp.maximum(0.0, yy2 - yy1)
    union = area_d + area_t - inter
    giou = iou - (area_e - union) / (area_e + eps)
    # normalized to [0, 1] as in the OC-SORT association utilities
    return (giou + 1.0) / 2.0


def diou_batch(dets, trks, xp=np, eps=1e-10):
    """Distance-IoU: IoU minus squared center distance over enclosing
    diagonal, normalized to [0, 1]."""
    d = xp.expand_dims(xp.asarray(dets), 1)
    t = xp.expand_dims(xp.asarray(trks), 0)
    iou = iou_batch(dets, trks, xp, eps)
    dcx = (d[..., 0] + d[..., 2]) / 2.0
    dcy = (d[..., 1] + d[..., 3]) / 2.0
    tcx = (t[..., 0] + t[..., 2]) / 2.0
    tcy = (t[..., 1] + t[..., 3]) / 2.0
    center_dist = (dcx - tcx) ** 2 + (dcy - tcy) ** 2
    ex1 = xp.minimum(d[..., 0], t[..., 0])
    ey1 = xp.minimum(d[..., 1], t[..., 1])
    ex2 = xp.maximum(d[..., 2], t[..., 2])
    ey2 = xp.maximum(d[..., 3], t[..., 3])
    diag = (ex2 - ex1) ** 2 + (ey2 - ey1) ** 2
    diou = iou - center_dist / (diag + eps)
    return (diou + 1.0) / 2.0


ASSO_FUNCS = {"iou": iou_batch, "giou": giou_batch, "diou": diou_batch}


def speed_direction(box1, box2, xp=np, eps=1e-6):
    """Unit direction (dy, dx) from box1's center to box2's center."""
    b1 = xp.asarray(box1)
    b2 = xp.asarray(box2)
    cx1, cy1 = (b1[..., 0] + b1[..., 2]) / 2.0, (b1[..., 1] + b1[..., 3]) / 2.0
    cx2, cy2 = (b2[..., 0] + b2[..., 2]) / 2.0, (b2[..., 1] + b2[..., 3]) / 2.0
    dy = cy2 - cy1
    dx = cx2 - cx1
    norm = xp.sqrt(dx**2 + dy**2) + eps
    return xp.stack([dy / norm, dx / norm], axis=-1)


def direction_consistency(dets, prev_obs, velocities, xp=np, eps=1e-6):
    """OC-SORT momentum term: (pi/2 - |angle diff|)/pi per (det, track) pair.

    ``prev_obs`` (M, >=5) are each track's reference observations (negative
    rows mean "no observation yet" and are masked out); ``velocities`` (M, 2)
    are the tracks' historical unit directions (dy, dx).
    """
    d = xp.asarray(dets)[:, None, :]  # (N,1,4+)
    p = xp.asarray(prev_obs)[None, :, :]  # (1,M,5)
    dcx, dcy = (d[..., 0] + d[..., 2]) / 2.0, (d[..., 1] + d[..., 3]) / 2.0
    pcx, pcy = (p[..., 0] + p[..., 2]) / 2.0, (p[..., 1] + p[..., 3]) / 2.0
    dy = dcy - pcy
    dx = dcx - pcx
    norm = xp.sqrt(dx**2 + dy**2) + eps
    dy, dx = dy / norm, dx / norm  # (N,M)

    v = xp.asarray(velocities)
    cos = v[None, :, 0] * dy + v[None, :, 1] * dx
    cos = xp.clip(cos, -1.0, 1.0)
    angle = (np.pi / 2.0 - xp.abs(xp.arccos(cos))) / np.pi
    valid = xp.asarray(prev_obs)[None, :, 4] >= 0
    return xp.where(valid, angle, 0.0)


# -- torch counterparts: (..., N, 4) dets x (..., M, 4) tracks -> (..., N, M) ---


def iou_batch_torch(dets, trks, eps=1e-10):
    d = dets[..., :, None, :]
    t = trks[..., None, :, :]
    xx1 = torch.maximum(d[..., 0], t[..., 0])
    yy1 = torch.maximum(d[..., 1], t[..., 1])
    xx2 = torch.minimum(d[..., 2], t[..., 2])
    yy2 = torch.minimum(d[..., 3], t[..., 3])
    inter = torch.clamp(xx2 - xx1, min=0.0) * torch.clamp(yy2 - yy1, min=0.0)
    area_d = (d[..., 2] - d[..., 0]) * (d[..., 3] - d[..., 1])
    area_t = (t[..., 2] - t[..., 0]) * (t[..., 3] - t[..., 1])
    return inter / (area_d + area_t - inter + eps)


def diou_batch_torch(dets, trks, eps=1e-10):
    d = dets[..., :, None, :]
    t = trks[..., None, :, :]
    iou = iou_batch_torch(dets, trks, eps)
    dcx = (d[..., 0] + d[..., 2]) / 2.0
    dcy = (d[..., 1] + d[..., 3]) / 2.0
    tcx = (t[..., 0] + t[..., 2]) / 2.0
    tcy = (t[..., 1] + t[..., 3]) / 2.0
    center_dist = (dcx - tcx) * (dcx - tcx) + (dcy - tcy) * (dcy - tcy)
    ex1 = torch.minimum(d[..., 0], t[..., 0])
    ey1 = torch.minimum(d[..., 1], t[..., 1])
    ex2 = torch.maximum(d[..., 2], t[..., 2])
    ey2 = torch.maximum(d[..., 3], t[..., 3])
    diag = (ex2 - ex1) * (ex2 - ex1) + (ey2 - ey1) * (ey2 - ey1)
    diou = iou - center_dist / (diag + eps)
    return (diou + 1.0) / 2.0


# The scan tracker's affinities: IoU (SORT) and DIoU (the reference's OC-SORT).
ASSO_FUNCS_TORCH = {"iou": iou_batch_torch, "diou": diou_batch_torch}


def speed_direction_torch(box1, box2, eps=1e-6):
    """Unit direction (dy, dx) from box1's center to box2's center."""
    cx1, cy1 = (box1[..., 0] + box1[..., 2]) / 2.0, (box1[..., 1] + box1[..., 3]) / 2.0
    cx2, cy2 = (box2[..., 0] + box2[..., 2]) / 2.0, (box2[..., 1] + box2[..., 3]) / 2.0
    dy = cy2 - cy1
    dx = cx2 - cx1
    norm = torch.sqrt(dx * dx + dy * dy) + eps
    return torch.stack([dy / norm, dx / norm], dim=-1)


def direction_consistency_torch(dets, prev_obs, velocities, eps=1e-6):
    """:func:`direction_consistency` for (..., N, 4+) dets, (..., M, 5)
    reference observations and (..., M, 2) velocities -> (..., N, M)."""
    d = dets[..., :, None, :]
    p = prev_obs[..., None, :, :]
    dcx, dcy = (d[..., 0] + d[..., 2]) / 2.0, (d[..., 1] + d[..., 3]) / 2.0
    pcx, pcy = (p[..., 0] + p[..., 2]) / 2.0, (p[..., 1] + p[..., 3]) / 2.0
    dy = dcy - pcy
    dx = dcx - pcx
    norm = torch.sqrt(dx * dx + dy * dy) + eps
    dy, dx = dy / norm, dx / norm
    v = velocities[..., None, :, :]
    cos = torch.clamp(v[..., 0] * dy + v[..., 1] * dx, -1.0, 1.0)
    angle = (np.pi / 2.0 - torch.abs(torch.arccos(cos))) / np.pi
    valid = prev_obs[..., None, :, 4] >= 0
    return torch.where(valid, angle, 0.0)
