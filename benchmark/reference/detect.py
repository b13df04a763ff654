"""The plain detector: float32 EfficientDet-Lite and the class-aware
postprocess, from the frozen copies in :mod:`benchmark.reference.model`.

It reads the same checkpoint file as the program and the same uint8
frames, and derives everything else itself (weights on its device,
anchors, the resize). TF32 is off, so a float32 product is float32.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.model.anchors import generate_anchors
from benchmark.reference.model.checkpoint import load_checkpoint, load_into
from benchmark.reference.model.efficientdet import EfficientDet, get_model_spec
from benchmark.reference.model.postprocess import detection_postprocess
from benchmark.reference.model.preprocess import preprocess_frames

MAX_DETECTIONS = 25  # the TFLite postprocess contract
BLOCK = 32  # frames a forward


class PlainDetector:
    """``spec_name`` with the weights of ``checkpoint`` on ``device``, in
    ``dtype`` (float32 unless a control asks for less)."""

    def __init__(self, spec_name: str, checkpoint: str, device, dtype=torch.float32):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.spec = get_model_spec(spec_name)
        self.device = torch.device(device)
        self.dtype = dtype
        state = {k: v for k, v in load_checkpoint(checkpoint).items()
                 if not k.endswith("act_scale")}
        model = load_into(EfficientDet(self.spec), state).eval()
        self.model = model.to(self.device, dtype)
        self.anchors = torch.from_numpy(generate_anchors(self.spec.anchor_config)).to(self.device)

    @torch.no_grad()
    def rows(self, frames: np.ndarray, threshold: float) -> tuple[np.ndarray, np.ndarray]:
        """uint8 RGB (N, H, W, 3) -> tracker rows (N, 25, 6) [x1, y1, x2, y2,
        score, class] normalized, float64, and the valid mask (slot < count
        and score >= threshold), in blocks of ``BLOCK`` frames."""
        out_rows, out_valid = [], []
        for i in range(0, len(frames), BLOCK):
            x = torch.from_numpy(np.ascontiguousarray(frames[i:i + BLOCK])).to(self.device)
            images = preprocess_frames(x, self.spec.input_size, self.dtype)
            deltas, logits = self.model(images)
            det = detection_postprocess(deltas.float(), logits.float(), self.anchors,
                                        input_size=self.spec.input_size,
                                        max_detections=MAX_DETECTIONS)
            boxes = det.boxes.cpu().numpy().astype(np.float64)
            scores = det.scores.cpu().numpy().astype(np.float64)
            counts = det.count.cpu().numpy()
            rows = np.zeros(boxes.shape[:2] + (6,))
            rows[..., 0], rows[..., 1] = boxes[..., 1], boxes[..., 0]
            rows[..., 2], rows[..., 3] = boxes[..., 3], boxes[..., 2]
            rows[..., 4] = scores
            slot = np.arange(rows.shape[1])[None, :]
            out_rows.append(rows)
            out_valid.append((slot < counts[:, None]) & (scores >= threshold))
        return np.concatenate(out_rows), np.concatenate(out_valid)

    def free(self) -> None:
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
