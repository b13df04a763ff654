"""The plain train step of the D family: one device, float32, TF32 off.

The step of ``reference/train/step.py`` (the optax chain of the JAX
package written on tensors: global-norm clipping at 10, decay 4e-5 on the
convolution kernels, SGD with momentum 0.9 under the warmup-cosine
schedule; the parameter EMA) over the plain D model of this directory
(:mod:`benchmark.reference.effdet.model`), with the same anchors, targets,
losses and augmentation. The fusion weights take no decay: they are no
convolution kernel (automl's decay reads ``.*(kernel|weight)$``, which they
do not match either). The checkpoint is read here, so the model needs
nothing of ``reference/model``'s modules; a float16 file is read into
float32.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.effdet.model import D_SPECS, forward
from benchmark.reference.model.anchors import AnchorConfig, generate_anchors
from benchmark.reference.model.checkpoint import msgpack_restore
from benchmark.reference.train.losses import detection_loss
from benchmark.reference.train.step import (MAX_GRAD_NORM, MOMENTUM, WEIGHT_DECAY,
                                            warmup_cosine_decay_schedule)
from benchmark.reference.train.targets import assign_targets

_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias", "edge_weight": "edge_weight",
           "mean": "running_mean", "var": "running_var"}
_STATS = ("running_mean", "running_var")


def load_checkpoint(path: str) -> dict:
    """A flax msgpack checkpoint as a flat dict of float32 tensors, named
    as the model reads them (HWIO kernels as OIHW, ``BatchNorm_0`` as
    ``bn``)."""
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    out = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, path + ["bn" if key == "BatchNorm_0" else key])
                continue
            arr = np.asarray(val, np.float32)
            if key == "kernel":
                arr = arr.transpose(3, 2, 0, 1)
            out[".".join(path + [_LEAVES[key]])] = torch.from_numpy(np.ascontiguousarray(arr))

    for collection in ("params", "batch_stats"):
        walk(tree[collection], [])
    return out


def _decayed(key: str, param: torch.Tensor) -> bool:
    return key.endswith(".weight") and param.ndim == 4


class PlainTrainer:
    """The step of the program's ``Trainer(spec, base_lr, total_steps,
    warmup_steps)`` with the whole model trainable, from ``checkpoint``;
    the interface of ``reference/train/step.py::PlainTrainer``."""

    def __init__(self, spec_name: str, checkpoint: str, base_lr: float, total_steps: int,
                 warmup_steps: int, device, dtype=torch.float32):
        self.spec = D_SPECS[spec_name]
        self.device = torch.device(device)
        self.dtype = dtype
        state = {k: v.to(self.device, dtype) for k, v in load_checkpoint(checkpoint).items()}
        self.params = {k: v for k, v in state.items() if not k.endswith(_STATS)}
        self.stats = {k: v for k, v in state.items() if k.endswith(_STATS)}
        self.trace = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.ema = {k: v.clone() for k, v in self.params.items()}
        self.count = 0
        self.schedule = warmup_cosine_decay_schedule(base_lr, max(warmup_steps, 1),
                                                     max(total_steps, 2))
        cfg = AnchorConfig(input_size=self.spec.input_size, anchor_scale=self.spec.anchor_scale)
        self.anchors = torch.from_numpy(generate_anchors(cfg)).to(self.device)

    def state(self) -> dict:
        """The parameters, their EMA and the BatchNorm statistics as they
        stand (each step makes new tensors)."""
        return {"params": self.params, "ema": self.ema, "stats": self.stats}

    def load_state(self, params: dict, stats: dict, trace: dict, ema: dict, count: int) -> None:
        """Start from a given state (copied in this trainer's dtype)."""
        def copy(d, keys):
            return {k: d[k].detach().to(self.device, self.dtype).clone() for k in keys}

        self.params, self.trace = copy(params, self.params), copy(trace, self.params)
        self.ema, self.stats = copy(ema, self.params), copy(stats, self.stats)
        self.count = int(count)

    def step(self, images, boxes, valid) -> dict:
        """One step on a normalized batch; returns the loss and the first
        gradient as the optimizer took it (clipped, decayed)."""
        box_t, cls_t, pos, ign = assign_targets(self.anchors, boxes, valid,
                                                self.spec.num_classes)
        params = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        deltas, logits, stats = forward(self.spec, {**params, **self.stats},
                                        images.to(self.dtype), train=True)
        total, _ = detection_loss(deltas, logits, box_t, cls_t, pos, ign)
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
        self.params, self.stats = new, {**self.stats, **stats}
        self.count += 1
        return {"loss": float(total.detach()), "opt_grad": {k: v.detach() for k, v in g.items()}}
