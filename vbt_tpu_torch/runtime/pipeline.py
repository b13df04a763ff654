"""The detection pipeline: uint8 frames -> fixed-capacity detections.

Port of ``vbt_tpu.runtime.pipeline``. One call of
:meth:`DetectionPipeline.detect_batch` uploads a uint8 frame batch once and
runs preprocess, the EfficientDet forward and the postprocess on the
pipeline's device. The weights are moved to the device once, at
construction.

Uploads go through a ring of pinned staging buffers per batch shape
(:class:`~vbt_tpu_torch.runtime.upload.StagingRing`): the copy runs on a
copy stream and the forward waits for it on the device, not the host. The
video reader decodes straight into a buffer the pipeline lends it
(:meth:`DetectionPipeline.lend_frames`); any other numpy batch is copied
into a staging buffer first. The pipeline keeps the rings of the
``MAX_RINGS`` batch shapes used last: evaluation feeds every image at its
own size, and each ring pins three buffers.

Serving policy (:func:`serving_config`): on CUDA, bf16 with the NMS kernel
(``use_kernel``, always for a single-class model); on the CPU, f32 with
the plain class-aware postprocess, as the JAX package served f32 with its
XLA path on the CPU.

``backbone="turbo"`` runs the backbone as :class:`TurboBackbone` (fused
MBConv blocks: the CUDA kernel on the card, its plain version on the CPU)
instead of the module's convolutions; the rest of the path is the same.

``prefilter`` is the JAX package's name for the candidate prefilter,
``"exact"`` (the default) or ``"approx"``; :meth:`DetectionPipeline.postprocess`
hands it to either postprocess
(:func:`~vbt_tpu_torch.ops.postprocess.prefilter_candidates`). JAX's
``"approx"`` is ``lax.approx_max_k``, which computes the exact top-K on
every backend but the TPU, so the port serves it with the exact top-K. As
in JAX, no name is refused, and :meth:`DetectionPipeline.calibrate`'s int8
pipeline takes the default.

:meth:`DetectionPipeline.init_variables` is the random-initialization
fallback where no checkpoint is at hand (the bench, ``entry.py``, the
health probe): flax's initializers drawn from a seeded ``torch.Generator``.

``quant="int8"`` runs every dense convolution in int8
(:mod:`vbt_tpu_torch.models.quant`) with the activation scales of a prior
:meth:`DetectionPipeline.calibrate`, the stand-in for the reference's
post-training-int8 TFLite artifact. As in the JAX package, int8 needs the
``"xla"`` backbone (the fused blocks have no int8 path) and calibrated
scales; both refusals raise.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from vbt_tpu_torch.models import EfficientDet, ModelSpec, get_model_spec
from vbt_tpu_torch.models import quant as q
from vbt_tpu_torch.models.anchors import generate_anchors
from vbt_tpu_torch.models.efficientdet import init_parameters
from vbt_tpu_torch.models.turbo import TurboBackbone, turbo_forward
from vbt_tpu_torch.ops.nms_cuda import detection_postprocess_cuda
from vbt_tpu_torch.ops.postprocess import Detections, detection_postprocess
from vbt_tpu_torch.ops.preprocess import preprocess_frames
from vbt_tpu_torch.runtime.checkpoint import load_checkpoint, load_into
from vbt_tpu_torch.runtime.upload import StagingRing
from vbt_tpu_torch.utils.device import resolve_device, serving_dtype

MAX_DETECTIONS = 25  # the TFLite postprocess contract
BACKBONES = ("xla", "turbo")  # the JAX package's names: module convolutions, fused blocks
QUANT = (q.OFF, q.INT8)
MAX_RINGS = 4  # staging rings (batch shapes) a pipeline keeps


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
    """A model with its weights resident on one device, and batch detection.

    ``state_dict`` is the float32 state (as :func:`load_checkpoint` gives
    it, with ``<conv>.act_scale`` entries for an int8 pipeline); the
    pipeline keeps it as ``weights`` for :meth:`calibrate`."""

    def __init__(self, spec: ModelSpec, state_dict: dict,
                 device: str | torch.device = "cuda", dtype: torch.dtype | None = None,
                 backbone: str = "xla", quant: str = q.OFF, prefilter: str = "exact"):
        if backbone not in BACKBONES:
            raise ValueError(f"backbone must be one of {BACKBONES}, got {backbone!r}")
        if quant not in QUANT:
            raise ValueError(f"quant must be one of {QUANT}, got {quant!r}")
        if backbone != "xla" and quant != q.OFF:
            # The fused blocks have no int8 path: the pipeline would serve
            # float while it reports quant='int8' (the JAX package's refusal).
            raise ValueError(f"quant={quant!r} requires backbone='xla', got backbone={backbone!r}")
        self.spec = spec
        self.quant = quant
        self.prefilter = prefilter
        self.weights = state_dict
        self.device, default_dtype = serving_config(device)
        self.dtype = default_dtype if dtype is None else dtype
        # The NMS kernel is single-class; every shipped model has one class.
        self.use_kernel = self.device.type == "cuda" and spec.num_classes == 1
        model = EfficientDet(spec)
        q.make_room_for_scales(model, state_dict)
        load_into(model, state_dict)
        if quant == q.INT8:
            q.set_mode(model, q.INT8)  # quantizes the f32 weights, before the cast
        # Folded from the f32 weights, before the model is cast to the working dtype.
        self.turbo = (TurboBackbone(model.backbone, (spec.input_size, spec.input_size),
                                    self.dtype, self.device)
                      if backbone == "turbo" else None)
        self.model = q.cast_model(model.eval(), self.device, self.dtype)
        self.anchors = torch.from_numpy(generate_anchors(spec.anchor_config)).to(self.device)
        self.rings: OrderedDict[tuple[int, ...], StagingRing] = OrderedDict()

    @classmethod
    def from_model_arg(cls, model: str, device: str | torch.device = "cuda",
                       dtype: torch.dtype | None = None,
                       backbone: str = "xla", prefilter: str = "exact") -> "DetectionPipeline":
        spec, ckpt = resolve_model(model)
        if ckpt is None:
            raise FileNotFoundError(
                f"No trained weights found for --model {model!r}: expected a "
                f".msgpack checkpoint at that path or a sibling of it.")
        return cls(spec, load_checkpoint(ckpt), device=device, dtype=dtype, backbone=backbone,
                   prefilter=prefilter)

    @staticmethod
    def init_variables(spec: ModelSpec, seed: int = 0,
                       dtype: torch.dtype = torch.float32) -> "OrderedDict[str, torch.Tensor]":
        """A state dict in the serving layout (the keys and shapes of
        ``convert_flax_variables`` of JAX's ``init_variables(spec)``) from
        flax's initializers, drawn on the CPU from ``seed``; JAX's random
        stream is not reproduced. ``dtype`` is that of every tensor."""
        model = init_parameters(EfficientDet(spec), torch.Generator().manual_seed(seed))
        return OrderedDict((k, v.to(dtype)) for k, v in model.state_dict().items())

    # -- upload -----------------------------------------------------------------
    def staging(self, shape: tuple[int, ...]) -> StagingRing:
        """The staging ring of one batch shape, made at first use. Beyond
        ``MAX_RINGS`` shapes the ring used longest ago is closed (after its
        copies have completed) and dropped."""
        shape = tuple(shape)
        if shape in self.rings:
            self.rings.move_to_end(shape)
            return self.rings[shape]
        while len(self.rings) >= MAX_RINGS:
            self.rings.popitem(last=False)[1].close()
        ring = self.rings[shape] = StagingRing(shape, self.device)
        return ring

    def lend_frames(self, shape: tuple[int, ...]) -> np.ndarray:
        """A staging buffer of ``shape`` for the caller to fill with a uint8
        (B, H, W, 3) batch and pass to :meth:`detect_batch` before it asks
        for more buffers than the ring holds."""
        return self.staging(shape).lend()

    def _frames(self, frames) -> torch.Tensor:
        if isinstance(frames, torch.Tensor) and frames.device.type != "cpu":
            x = frames
        else:
            x = frames.numpy() if isinstance(frames, torch.Tensor) else np.asarray(frames)
        if x.dtype not in (torch.uint8, np.uint8) or x.ndim != 4 or x.shape[-1] != 3:
            raise ValueError(f"want uint8 (B, H, W, 3) frames, got {x.dtype} {tuple(x.shape)}")
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return self.staging(x.shape).upload(x)

    # -- inference ------------------------------------------------------------

    @torch.inference_mode()
    def forward(self, frames) -> tuple[torch.Tensor, torch.Tensor]:
        """uint8 (B, H, W, 3) -> head outputs (deltas, logits) in ``dtype``."""
        images = preprocess_frames(self._frames(frames), self.spec.input_size, self.dtype)
        return self.run_model(images)

    def run_model(self, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Normalized NCHW images -> (deltas, logits), through the chosen backbone."""
        if self.turbo is not None:
            return turbo_forward(self.model, self.turbo, images)
        return self.model(images)

    # -- int8 -----------------------------------------------------------------

    def calibrate(self, frames) -> "DetectionPipeline":
        """Record every dense conv's activation scale over the uint8 frames
        (B, H, W, 3), preprocessed as :meth:`detect_batch` does and run in
        the working dtype, and return a new pipeline serving int8 with them."""
        if self.turbo is not None:
            raise ValueError("int8 calibration requires the 'xla' backbone, not 'turbo': the "
                             "fused blocks have no int8 path")
        with torch.inference_mode():
            images = preprocess_frames(self._frames(frames), self.spec.input_size, self.dtype)
            scales = q.calibrate(self.model, [images])
        state = dict(self.weights)
        state.update({k: v.to(device="cpu", dtype=torch.float32) for k, v in scales.items()})
        return DetectionPipeline(self.spec, state, device=self.device, dtype=self.dtype,
                                 quant=q.INT8)

    @torch.inference_mode()
    def postprocess(self, deltas: torch.Tensor, logits: torch.Tensor,
                    score_threshold: float = 0.0) -> Detections:
        fn = detection_postprocess_cuda if self.use_kernel else detection_postprocess
        return fn(deltas, logits, self.anchors, input_size=self.spec.input_size,
                  max_detections=MAX_DETECTIONS, score_threshold=score_threshold,
                  prefilter=self.prefilter)

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
