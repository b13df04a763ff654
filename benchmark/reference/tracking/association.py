"""Association costs of the host trackers (IoU, GIoU, DIoU) and OC-SORT's
momentum terms, on numpy arrays.

Benchmark copy of the port's ``tracking/association.py``: only the parts
the plain reference runs are kept.
"""

from __future__ import annotations

import numpy as np


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
