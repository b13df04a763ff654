"""The detection pipeline: uint8 frames -> fixed-capacity detections.

Port of ``vbt_tpu.runtime.pipeline``. One call of
:meth:`DetectionPipeline.detect_batch` uploads a uint8 frame batch once and
runs preprocess, the EfficientDet forward and the postprocess on the
pipeline's device. The weights are moved to the device once, at
construction.

Serving policy (:func:`serving_config`): on CUDA, bf16 with the NMS kernel
(``use_kernel``, always for a single-class model); on the CPU, f32 with
the plain class-aware postprocess, as the JAX package served f32 with its
XLA path on the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from vbt_tpu_torch.models import EfficientDet, ModelSpec, get_model_spec
from vbt_tpu_torch.models.anchors import generate_anchors
from vbt_tpu_torch.ops.nms_cuda import detection_postprocess_cuda
from vbt_tpu_torch.ops.postprocess import Detections, detection_postprocess
from vbt_tpu_torch.ops.preprocess import preprocess_frames
from vbt_tpu_torch.runtime.checkpoint import load_checkpoint, load_into
from vbt_tpu_torch.utils.device import resolve_device, serving_dtype

MAX_DETECTIONS = 25  # the TFLite postprocess contract


def serving_config(device: str | torch.device = "cuda") -> tuple[torch.device, torch.dtype]:
    """The one serving policy: ``(device, dtype)``, bf16 on CUDA and f32 on
    the CPU. Raises if CUDA is asked for and absent."""
    dev = resolve_device(device)
    return dev, serving_dtype(dev)


def resolve_model(model: str) -> tuple[ModelSpec, str | None]:
    """Map a --model argument to (spec, checkpoint path or None): a spec
    name, a ``.msgpack`` checkpoint, or a ``.tflite`` path whose sibling
    ``.msgpack`` holds the weights."""
    base = os.path.basename(model).split(".")[0]
    spec = get_model_spec(base)
    if os.path.isfile(model) and not model.endswith(".tflite"):
        return spec, model
    sibling = os.path.splitext(model)[0] + ".msgpack"
    if os.path.isfile(sibling):
        return spec, sibling
    return spec, None


class DetectionPipeline:
    """A model with its weights resident on one device, and batch detection."""

    def __init__(self, spec: ModelSpec, state_dict: dict,
                 device: str | torch.device = "cuda", dtype: torch.dtype | None = None):
        self.spec = spec
        self.device, default_dtype = serving_config(device)
        self.dtype = default_dtype if dtype is None else dtype
        # The NMS kernel is single-class; every shipped model has one class.
        self.use_kernel = self.device.type == "cuda" and spec.num_classes == 1
        model = EfficientDet(spec)
        load_into(model, state_dict)
        self.model = model.eval().to(device=self.device, dtype=self.dtype)
        self.anchors = torch.from_numpy(generate_anchors(spec.anchor_config)).to(self.device)

    @classmethod
    def from_model_arg(cls, model: str, device: str | torch.device = "cuda",
                       dtype: torch.dtype | None = None) -> "DetectionPipeline":
        spec, ckpt = resolve_model(model)
        if ckpt is None:
            raise FileNotFoundError(
                f"No trained weights found for --model {model!r}: expected a "
                f".msgpack checkpoint at that path or a sibling of it.")
        return cls(spec, load_checkpoint(ckpt), device=device, dtype=dtype)

    # -- inference ------------------------------------------------------------
    def _frames(self, frames) -> torch.Tensor:
        x = torch.from_numpy(frames) if isinstance(frames, np.ndarray) else frames
        if x.dtype != torch.uint8 or x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"want uint8 (B, H, W, 3) frames, got {x.dtype} {tuple(x.shape)}")
        return x.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def forward(self, frames) -> tuple[torch.Tensor, torch.Tensor]:
        """uint8 (B, H, W, 3) -> head outputs (deltas, logits) in ``dtype``."""
        images = preprocess_frames(self._frames(frames), self.spec.input_size, self.dtype)
        return self.model(images)

    @torch.inference_mode()
    def postprocess(self, deltas: torch.Tensor, logits: torch.Tensor,
                    score_threshold: float = 0.0) -> Detections:
        fn = detection_postprocess_cuda if self.use_kernel else detection_postprocess
        return fn(deltas, logits, self.anchors, input_size=self.spec.input_size,
                  max_detections=MAX_DETECTIONS, score_threshold=score_threshold)

    def detect_batch(self, frames, score_threshold: float = 0.0) -> Detections:
        """uint8 RGB (B, H, W, 3) -> Detections on the pipeline's device."""
        deltas, logits = self.forward(frames)
        return self.postprocess(deltas, logits, score_threshold)

    def detections_to_tracker_inputs(self, det: Detections,
                                     threshold: float) -> tuple[np.ndarray, np.ndarray]:
        """Detections -> (B, D, 6) float64 tracker rows [x1, y1, x2, y2,
        score, class] (normalized) and the (B, D) valid mask
        ``slot < count and score >= threshold``."""
        boxes = det.boxes.cpu().numpy().astype(np.float64)  # (B, D, 4) y1x1y2x2
        scores = det.scores.cpu().numpy().astype(np.float64)
        counts = det.count.cpu().numpy()
        b, d, _ = boxes.shape
        rows = np.zeros((b, d, 6), np.float64)
        rows[..., 0] = boxes[..., 1]
        rows[..., 1] = boxes[..., 0]
        rows[..., 2] = boxes[..., 3]
        rows[..., 3] = boxes[..., 2]
        rows[..., 4] = scores
        slot = np.arange(d)[None, :]
        valid = (slot < counts[:, None]) & (scores >= threshold)
        return rows, valid
