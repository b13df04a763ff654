"""The plain train step: one device, float32, TF32 off.

A frozen copy of the port's ``train/train_step.py`` single-device path
(the optax chain of the JAX package written on tensors, the EMA) over the
copies of the model (train-mode BatchNorm with flax's statistics),
targets, losses and augmentation in this directory. It starts from the
same checkpoint file and draws the augmentation from a generator seeded
as the program's, so it works out the program's batches itself.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from benchmark.reference.model.anchors import generate_anchors
from benchmark.reference.model.checkpoint import load_checkpoint, load_into
from benchmark.reference.model.efficientdet import EfficientDet, get_model_spec
from benchmark.reference.train.augment import augment_mosaic_and_normalize, draw_mosaic
from benchmark.reference.train.losses import detection_loss
from benchmark.reference.train.targets import assign_targets

MAX_GRAD_NORM = 10.0
MOMENTUM = 0.9
WEIGHT_DECAY = 4e-5


def warmup_cosine_decay_schedule(peak_value: float, warmup_steps: int, decay_steps: int):
    """optax's ``warmup_cosine_decay_schedule(0, peak, warmup, decay, 0)``,
    in float32 step for step."""
    cosine_steps = decay_steps - warmup_steps
    f32 = np.float32

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
            return float(f32(0.0 - peak_value) * frac + f32(peak_value))
        t = f32(min(count - warmup_steps, cosine_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t / f32(cosine_steps)))
        return float(f32(peak_value) * (f32(1.0) * cosine + f32(0.0)))

    return schedule


def _decayed(key: str, param: torch.Tensor) -> bool:
    return key.endswith(".weight") and param.ndim == 4


class PlainTrainer:
    """The step of ``Trainer(spec, base_lr, total_steps, warmup_steps)``
    with the whole model trainable, from ``checkpoint``."""

    def __init__(self, spec_name: str, checkpoint: str, base_lr: float, total_steps: int,
                 warmup_steps: int, device, dtype=torch.float32):
        self.spec = get_model_spec(spec_name)
        self.device = torch.device(device)
        self.dtype = dtype
        state = {k: v for k, v in load_checkpoint(checkpoint).items()
                 if not k.endswith("act_scale")}
        self.model = load_into(EfficientDet(self.spec), state).to(self.device, dtype)
        self.param_keys = [k for k, _ in self.model.named_parameters()]
        sd = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        self.params = {k: sd[k] for k in self.param_keys}
        self.stats = {k: v for k, v in sd.items() if k not in self.params}
        self.trace = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.ema = {k: v.clone() for k, v in self.params.items()}
        self.count = 0
        self.schedule = warmup_cosine_decay_schedule(base_lr, max(warmup_steps, 1),
                                                     max(total_steps, 2))
        self.anchors = torch.from_numpy(generate_anchors(self.spec.anchor_config)).to(self.device)

    def state(self) -> dict:
        """The parameters, their EMA and the BatchNorm statistics as they
        stand (each step makes new tensors)."""
        return {"params": self.params, "ema": self.ema, "stats": self.stats}

    def load_state(self, params: dict, stats: dict, trace: dict, ema: dict, count: int) -> None:
        """Start from a given state (copied in this trainer's dtype), where
        the reference follows a stage from the program's own state."""
        def copy(d):
            return {k: d[k].detach().to(self.device, self.dtype).clone() for k in self.params}

        stats = {k: stats[k].detach().to(self.device, self.dtype).clone() for k in self.stats}
        self.params, self.trace, self.ema = copy(params), copy(trace), copy(ema)
        self.stats, self.count = stats, int(count)

    def step(self, images, boxes, valid) -> dict:
        """One step on a normalized batch; returns the loss and the first
        gradient as the optimizer took it (clipped, decayed)."""
        box_t, cls_t, pos, ign = assign_targets(self.anchors, boxes, valid,
                                                self.spec.num_classes)
        params = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        stats = {k: v.clone() for k, v in self.stats.items()}
        self.model.train()
        deltas, logits = functional_call(self.model, {**params, **stats},
                                         (images.to(self.dtype),))
        total, metrics = detection_loss(deltas, logits, box_t, cls_t, pos, ign)
        keys = list(params)
        grads = torch.autograd.grad(total, [params[k] for k in keys])
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = MAX_GRAD_NORM / norm if norm >= MAX_GRAD_NORM else 1.0
        g = {k: gr * scale for k, gr in zip(keys, grads)}
        for k in keys:
            if _decayed(k, self.params[k]):
                g[k] = g[k] + WEIGHT_DECAY * self.params[k]
        lr = self.schedule(self.count)
        self.trace = {k: g[k] + MOMENTUM * self.trace[k] for k in keys}
        new = {k: self.params[k] - lr * self.trace[k] for k in keys}
        t = np.float32(self.count)
        decay = float(np.minimum(np.float32(0.9998), (np.float32(1) + t) / (np.float32(10) + t)))
        keep = float(np.float32(1) - np.float32(decay))
        self.ema = {k: self.ema[k] * decay + new[k] * keep for k in keys}
        self.params, self.stats = new, stats
        self.count += 1
        return {"loss": float(total.detach()), "opt_grad": {k: v.detach() for k, v in g.items()}}


def augmented(images_u8, boxes, valid, idx, generator, jitter, mosaic_p):
    """The batch of the images ``idx``, augmented with the generator's next
    draws, as the program's device-resident trainer makes it."""
    images, boxes, valid = images_u8[idx], boxes[idx], valid[idx]
    draws = draw_mosaic(generator, idx.shape[0], images.shape[1], jitter[0], jitter[1], mosaic_p)
    return augment_mosaic_and_normalize(images, boxes, valid, draws)
