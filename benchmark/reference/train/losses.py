"""Detection losses: sigmoid focal + Huber box regression.

Port of ``vbt_tpu.train.losses``: the RetinaNet/EfficientDet recipe (alpha
0.25, gamma 1.5, Huber delta 0.1, box weight 50), float32. optax's
``sigmoid_binary_cross_entropy`` is written out through ``logsigmoid``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ALPHA = 0.25
GAMMA = 1.5
HUBER_DELTA = 0.1
BOX_LOSS_WEIGHT = 50.0


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = ALPHA,
               gamma: float = GAMMA) -> torch.Tensor:
    """Per-element sigmoid focal loss. ``targets`` in {0, 1}."""
    p = torch.clamp(logits.float(), -30, 30)
    ce = -targets * F.logsigmoid(p) - (1.0 - targets) * F.logsigmoid(-p)
    prob = torch.exp(-ce)  # = p_t, the probability of the true class
    alpha_t = targets * alpha + (1 - targets) * (1 - alpha)
    return alpha_t * (1 - prob) ** gamma * ce


def huber_loss(pred: torch.Tensor, target: torch.Tensor,
               delta: float = HUBER_DELTA) -> torch.Tensor:
    err = torch.abs(pred - target)
    quad = torch.clamp(err, max=delta)
    return 0.5 * quad**2 + delta * (err - quad)


def detection_loss(deltas, logits, box_targets, cls_targets, positive, ignore):
    """Total loss and the metrics dict, normalized by the positive count.

    deltas (B, N, 4), logits (B, N, C), box_targets (B, N, 4), cls_targets
    (B, N, C) one-hot, positive (B, N) bool (matched to a GT), ignore
    (B, N) bool (excluded from the class loss). Every value is a 0-d
    tensor on the inputs' device."""
    num_pos = torch.clamp(positive.sum().float(), min=1.0)

    cls_l = focal_loss(logits, cls_targets)
    cls_l = torch.where(ignore[..., None], 0.0, cls_l).sum() / num_pos

    box_l = huber_loss(deltas.float(), box_targets)
    box_l = torch.where(positive[..., None], box_l, 0.0).sum() / (num_pos * 4.0)

    total = cls_l + BOX_LOSS_WEIGHT * box_l
    return total, {"loss": total, "cls_loss": cls_l, "box_loss": box_l, "num_pos": num_pos}
