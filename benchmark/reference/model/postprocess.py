"""Detection postprocess: top-K prefilter, anchor decode, class-aware
greedy NMS, as the JAX package's XLA path.

The prefilter is a *stable* descending sort (``lax.top_k`` puts the lower
anchor index first among equal values, and the NMS tie-break depends on
that order). Benchmark copy of the port's ``ops/postprocess.py``: only the
parts the plain reference runs are kept.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.model.anchors import decode_boxes

# Prefilter width shared by every lane (as in the JAX package).
NUM_CANDIDATES = 512


class Detections(NamedTuple):
    """Fixed-capacity detections with a leading batch dim."""

    count: torch.Tensor  # (B,) int32 — number of valid rows
    scores: torch.Tensor  # (B, D) f32
    classes: torch.Tensor  # (B, D) int32
    boxes: torch.Tensor  # (B, D, 4) normalized [ymin, xmin, ymax, xmax]


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of [ymin,xmin,ymax,xmax] sets (..., N, 4) x (..., M, 4)
    -> (..., N, M), 0 where the union is not positive."""
    a = a.unsqueeze(-2)
    b = b.unsqueeze(-3)
    inter_h = torch.clamp(torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]), min=0.0)
    inter_w = torch.clamp(torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]), min=0.0)
    inter = inter_h * inter_w
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def top_k_candidates(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along the last dim, ties in ascending index order (the
    ``lax.top_k`` order)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def approx_top_k(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``"approx"`` prefilter. JAX's is ``lax.approx_max_k``, which
    computes the exact top-K on every backend but the TPU (its ``"approx"``
    equals its ``"exact"`` bit for bit on the CPU), and the port has no
    approximate top-K kernel: so this is :func:`top_k_candidates`."""
    return top_k_candidates(values, k)


def prefilter_candidates(values: torch.Tensor, k: int,
                         prefilter: str = "exact") -> tuple[torch.Tensor, torch.Tensor]:
    """The top ``k`` candidates by the named prefilter: ``"approx"`` is
    :func:`approx_top_k`, any other name the exact :func:`top_k_candidates`."""
    if prefilter == "approx":
        return approx_top_k(values, k)
    return top_k_candidates(values, k)


def gather_decode(deltas: torch.Tensor, anchors: torch.Tensor, idx: torch.Tensor,
                  input_size: int) -> torch.Tensor:
    """Gather the (B, K) candidates' deltas and anchors, decode only those,
    normalize by ``input_size`` -> (B, K, 4) f32."""
    top_deltas = torch.gather(deltas.float(), 1, idx.unsqueeze(-1).expand(-1, -1, 4))
    top_anchors = anchors.float()[idx]
    return decode_boxes(top_deltas, top_anchors) / input_size


def detection_postprocess(
    deltas: torch.Tensor,  # (B, N, 4)
    logits: torch.Tensor,  # (B, N, C)
    anchors: torch.Tensor,  # (N, 4) [yc, xc, h, w] pixels
    input_size: int,
    max_detections: int = 25,
    iou_threshold: float = 0.5,
    score_threshold: float = 0.0,
    num_candidates: int = NUM_CANDIDATES,
    prefilter: str = "exact",
) -> Detections:
    """Class-aware decode + greedy NMS, mirroring the JAX XLA path, with
    the candidates of :func:`prefilter_candidates`."""
    scores_all = torch.sigmoid(logits.float())  # (B, N, C)
    best_score, best_class = scores_all.max(dim=-1)
    best_class = best_class.to(torch.int32)
    k = min(num_candidates, best_score.shape[1])
    top_scores, top_idx = prefilter_candidates(best_score, k, prefilter)
    top_classes = torch.gather(best_class, 1, top_idx)
    boxes = gather_decode(deltas, anchors, top_idx, input_size)  # (B, K, 4)

    ious = iou_matrix(boxes, boxes)  # (B, K, K)
    same_class = top_classes[:, :, None] == top_classes[:, None, :]
    suppress_pair = (ious > iou_threshold) & same_class
    valid = top_scores >= score_threshold

    bsz = deltas.shape[0]
    dev = deltas.device
    rows = torch.arange(bsz, device=dev)
    suppressed = torch.zeros(bsz, k, dtype=torch.bool, device=dev)
    count = torch.zeros(bsz, dtype=torch.int32, device=dev)
    out_s = torch.zeros(bsz, max_detections, dtype=torch.float32, device=dev)
    out_c = torch.zeros(bsz, max_detections, dtype=torch.int32, device=dev)
    out_b = torch.zeros(bsz, max_detections, 4, dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    for i in range(max_detections):
        cand = torch.where(valid & ~suppressed, top_scores, neg_inf)
        best = cand.argmax(dim=1)  # first maximal index, as jnp.argmax
        found = cand[rows, best] > float("-inf")
        suppressed = suppressed | (found[:, None] & suppress_pair[rows, best])
        suppressed[rows, best] |= found
        count += found.to(torch.int32)
        out_s[:, i] = torch.where(found, top_scores[rows, best], 0.0)
        out_c[:, i] = torch.where(found, top_classes[rows, best], 0)
        out_b[:, i] = torch.where(found[:, None], boxes[rows, best], 0.0)
    return Detections(count=count, scores=out_s, classes=out_c, boxes=out_b)
