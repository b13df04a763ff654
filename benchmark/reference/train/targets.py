"""Anchor target assignment for detection training.

Port of ``vbt_tpu.train.targets``, batched over images where the JAX
package ``vmap``s one image: anchors with best IoU >= 0.5 are positive,
< 0.4 negative, in between ignored; the best anchor of every valid
ground-truth box is forced positive (``argmax``'s first index on ties), and
invalid (padded) rows take no part.

When two valid GT boxes share one best anchor, JAX's ``.at[...].set(...,
mode="drop")`` writes that anchor twice, and XLA on the CPU keeps the last
write: the higher GT index. A scatter with duplicate indices is unordered
on CUDA, so the port takes that index as a ``scatter_reduce`` maximum,
which is the same answer on every device.
"""

from __future__ import annotations

import torch

from benchmark.reference.model.anchors import encode_boxes

POS_IOU = 0.5
NEG_IOU = 0.4


def _corners(anchors: torch.Tensor) -> torch.Tensor:
    """[yc, xc, h, w] -> [ymin, xmin, ymax, xmax]."""
    yc, xc, h, w = anchors.unbind(-1)
    return torch.stack([yc - h / 2, xc - w / 2, yc + h / 2, xc + w / 2], dim=-1)


def _pairwise_iou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """(N, 4) x (B, G, 4) corner boxes -> (B, N, G)."""
    a = a[None, :, None, :]
    b = b[:, None, :, :]
    ih = torch.clamp(torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]),
                     min=0.0)
    iw = torch.clamp(torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]),
                     min=0.0)
    inter = ih * iw
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter + eps)


def assign_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                   num_classes: int = 1):
    """Per-anchor labels of a batch.

    anchors (N, 4) [yc, xc, h, w]; gt_boxes (B, G, 4) [ymin, xmin, ymax,
    xmax], padded; gt_valid (B, G) bool. Returns (box_targets (B, N, 4),
    cls_targets (B, N, C), positive (B, N), ignore (B, N)).
    """
    anchors = anchors.to(gt_boxes.dtype)
    b, g = gt_valid.shape
    n = anchors.shape[0]
    iou = _pairwise_iou(_corners(anchors), gt_boxes)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)

    best_gt = torch.argmax(iou, dim=2)  # (B, N)
    best_iou = torch.amax(iou, dim=2)
    positive = best_iou >= POS_IOU
    ignore = (best_iou >= NEG_IOU) & (best_iou < POS_IOU)

    # Force-match the best anchor of each valid GT box (ties to the first
    # anchor); on a shared anchor the higher GT index wins. Invalid rows
    # scatter -1, which the maximum ignores.
    best_anchor_per_gt = torch.argmax(iou, dim=1)  # (B, G)
    gt_index = torch.arange(g, device=gt_valid.device).expand(b, g)
    forced_gt = torch.full((b, n), -1, dtype=torch.int64, device=gt_valid.device).scatter_reduce(
        1, best_anchor_per_gt, torch.where(gt_valid, gt_index, -1), reduce="amax")
    forced = forced_gt >= 0
    best_gt = torch.where(forced, forced_gt, best_gt)
    positive = positive | forced
    ignore = ignore & ~forced

    matched = torch.gather(gt_boxes, 1, best_gt[..., None].expand(b, n, 4))
    box_targets = torch.where(positive[..., None], encode_boxes(matched, anchors), 0.0)

    # Single-class one-hot (class 0 == barbell).
    cls_targets = torch.zeros((b, n, num_classes), dtype=torch.float32, device=gt_boxes.device)
    cls_targets[..., 0] = positive.float()
    return box_targets, cls_targets, positive, ignore
