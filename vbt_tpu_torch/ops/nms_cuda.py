"""Greedy NMS on Hopper: the wrapper of ``csrc/nms.cu`` and the postprocess
driver around it.

Replaces ``vbt_tpu/ops/nms_pallas.py`` (kernel ``_nms_kernel``, driver
``detection_postprocess_pallas``). :func:`detection_postprocess_cuda` runs
the stable top-K prefilter, the gather and ``decode_boxes / input_size`` as
torch ops, as the JAX driver ran them in XLA outside Pallas, then calls
:func:`nms`.

:func:`nms` takes its plain version (:func:`ops.postprocess.nms_plain`)
only for tensors on the CPU. For CUDA tensors it launches the kernel or
raises; there is no fallback. ``nms.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vbt_tpu_torch.ops import _build
from vbt_tpu_torch.ops.postprocess import (
    NUM_CANDIDATES,
    Detections,
    gather_decode,
    nms_plain,
    prefilter_candidates,
)

MAX_CANDIDATES = 512  # candidates an image's warps hold in registers (csrc/nms.cu kMaxCandidates)


@functools.cache
def _launcher():
    """``vbt_nms_launch`` of the built library, its C signature declared."""
    fn = _build.load("nms").vbt_nms_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def nms(
    logits_k: torch.Tensor,  # (B, K) f32, -inf pads
    boxes_k: torch.Tensor,  # (B, K, 4) f32 normalized [ymin, xmin, ymax, xmax]
    max_detections: int = 25,
    iou_threshold: float = 0.5,
    score_threshold: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (count (B,) int32, scores (B, D) f32, boxes (B, D, 4) f32)."""
    if logits_k.dim() != 2 or boxes_k.shape != (*logits_k.shape, 4):
        raise ValueError(f"want logits (B, K) and boxes (B, K, 4), got "
                         f"{tuple(logits_k.shape)} and {tuple(boxes_k.shape)}")
    if logits_k.dtype != torch.float32 or boxes_k.dtype != torch.float32:
        raise TypeError(f"want float32, got {logits_k.dtype} and {boxes_k.dtype}")
    if logits_k.device != boxes_k.device:
        raise ValueError(f"inputs on {logits_k.device} and {boxes_k.device}")
    if logits_k.device.type == "cpu":
        return nms_plain(logits_k, boxes_k, max_detections, iou_threshold, score_threshold)
    if logits_k.device.type != "cuda":
        raise ValueError(f"unsupported device {logits_k.device}")
    b, k = logits_k.shape
    if not 0 < k <= MAX_CANDIDATES or b == 0 or max_detections <= 0:
        raise ValueError(f"kernel takes 0 < K <= {MAX_CANDIDATES}, B > 0, D > 0; "
                         f"got B={b}, K={k}, D={max_detections}")
    if not (logits_k.is_contiguous() and boxes_k.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    dev = logits_k.device
    count = torch.empty(b, dtype=torch.int32, device=dev)
    scores = torch.empty(b, max_detections, dtype=torch.float32, device=dev)
    boxes = torch.empty(b, max_detections, 4, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(
            logits_k.data_ptr(), boxes_k.data_ptr(), count.data_ptr(),
            scores.data_ptr(), boxes.data_ptr(), b, k, max_detections,
            iou_threshold, score_threshold, stream,
        )
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed: cudaError {err}")
    nms.launches += 1
    return count, scores, boxes


nms.launches = 0


def detection_postprocess_cuda(
    deltas: torch.Tensor,  # (B, N, 4)
    logits: torch.Tensor,  # (B, N, 1) — single class
    anchors: torch.Tensor,  # (N, 4) [yc, xc, h, w] pixels
    input_size: int,
    max_detections: int = 25,
    iou_threshold: float = 0.5,
    score_threshold: float = 0.0,
    num_candidates: int = NUM_CANDIDATES,
    prefilter: str = "exact",
) -> Detections:
    """Top-K prefilter (:func:`~vbt_tpu_torch.ops.postprocess.prefilter_candidates`
    by ``prefilter``) + decode + NMS kernel; the contract of
    ``detection_postprocess_pallas``, single class."""
    if logits.shape[-1] != 1:
        raise ValueError("the NMS kernel is single-class; use detection_postprocess")
    k = min(num_candidates, logits.shape[1])
    top_logits, top_idx = prefilter_candidates(logits[..., 0].float(), k, prefilter)
    boxes_k = gather_decode(deltas, anchors, top_idx, input_size)
    count, scores, boxes = nms(top_logits.contiguous(), boxes_k.contiguous(),
                               max_detections, iou_threshold, score_threshold)
    classes = torch.zeros(scores.shape, dtype=torch.int32, device=scores.device)
    return Detections(count=count, scores=scores, classes=classes, boxes=boxes)
