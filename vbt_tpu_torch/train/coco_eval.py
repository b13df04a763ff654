"""Single-class COCO-style average precision (numpy).

Copy of ``vbt_tpu.train.coco_eval``: the AP / AP50 / AP75 the reference
logs from its COCO evaluator, by greedy score-ordered matching at each IoU
threshold of 0.50:0.95:0.05 and 101-point interpolated precision.
"""

from __future__ import annotations

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    ih = np.maximum(0.0, np.minimum(a[:, None, 2], b[None, :, 2])
                    - np.maximum(a[:, None, 0], b[None, :, 0]))
    iw = np.maximum(0.0, np.minimum(a[:, None, 3], b[None, :, 3])
                    - np.maximum(a[:, None, 1], b[None, :, 1]))
    inter = ih * iw
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def average_precision(detections: list[dict], ground_truths: list[np.ndarray],
                      iou_threshold: float) -> float:
    """AP at one IoU threshold. ``detections[i]``: ``{'boxes': (D, 4),
    'scores': (D,)}`` of image i; ``ground_truths[i]``: (G, 4). Boxes are
    ``[ymin, xmin, ymax, xmax]``."""
    num_gt = sum(len(g) for g in ground_truths)
    if num_gt == 0:
        return 0.0

    rows = []  # (score, is_tp)
    for det, gt in zip(detections, ground_truths):
        boxes, scores = det["boxes"], det["scores"]
        order = np.argsort(-scores, kind="stable")
        iou = _iou_matrix(np.asarray(boxes), np.asarray(gt))
        taken = np.zeros(len(gt), bool)
        for d in order:
            best, best_iou = -1, iou_threshold
            for g in range(len(gt)):
                if not taken[g] and iou[d, g] >= best_iou:
                    best, best_iou = g, iou[d, g]
            if best >= 0:
                taken[best] = True
            rows.append((scores[d], best >= 0))

    if not rows:
        return 0.0
    rows.sort(key=lambda r: -r[0])
    tp = np.cumsum([r[1] for r in rows])
    fp = np.cumsum([not r[1] for r in rows])
    recall = tp / num_gt
    precision = tp / np.maximum(tp + fp, 1e-9)
    # Monotone precision envelope + 101-point interpolation (COCO).
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    interp = np.zeros_like(RECALL_POINTS)
    idx = np.searchsorted(recall, RECALL_POINTS, side="left")
    ok = idx < len(precision)
    interp[ok] = precision[idx[ok]]
    return float(interp.mean())


def coco_metrics(detections: list[dict], ground_truths: list[np.ndarray]) -> dict:
    """``{"AP": mean over 0.50:0.95, "AP50", "AP75"}``."""
    aps = {t: average_precision(detections, ground_truths, t) for t in IOU_THRESHOLDS}
    return {
        "AP": float(np.mean(list(aps.values()))),
        "AP50": aps[IOU_THRESHOLDS[0]],
        "AP75": aps[IOU_THRESHOLDS[5]],
    }
