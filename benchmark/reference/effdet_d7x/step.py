"""The plain train step of EfficientDet-D7x: one device, float32, TF32 off.

A copy of ``reference/effdet/step.py`` (the step of
``reference/train/step.py``, the optax chain of the JAX package written on
tensors: global-norm clipping at 10, decay 4e-5 on the convolution
kernels, SGD with momentum 0.9 under the warmup-cosine schedule; the
parameter EMA) over the plain D7x model of this directory
(:mod:`benchmark.reference.effdet_d7x.model`), with the same anchors (over
levels 3..8), targets, losses and augmentation. Three changes: each step
runs with TF32 off, whatever the process's setting (``tf32=True`` is the
control's precision); the model recomputes by blocks (``recompute``, the
model's docstring: the plain step at 1536 px does not fit the card
otherwise); and :func:`write_seeded_checkpoint` writes the weights the
cell starts from, drawn here from a seed, in the checkpoint layout the
program and :func:`load_checkpoint` read. The checkpoint is read here, so
the model needs nothing of ``reference/model``'s modules.
"""

from __future__ import annotations

import contextlib
import math
import struct

import numpy as np
import torch
from torch import nn

from benchmark.reference.effdet_d7x.model import D_SPECS, forward, parameter_shapes
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


_FLAX_LEAVES = {"conv": ("params", "kernel"), "bias": ("params", "bias"),
                "scale": ("params", "scale"), "shift": ("params", "bias"),
                "mean": ("batch_stats", "mean"), "var": ("batch_stats", "var"),
                "edge": ("params", "edge_weight")}
CLASS_PRIOR = 0.01
# flax's truncated normal has stddev 1 before this correction (its
# variance_scaling divides by the stddev of a unit normal cut at +-2).
_TRUNC_STD = 0.87962566103423978


def seeded_weights(spec_name: str, seed: int) -> dict:
    """Every weight of the spec, drawn from ``seed`` on the CPU with flax's
    initializers: convolution kernels ``lecun_normal`` (a normal cut at two
    standard deviations, ``std = sqrt(1 / fan_in) / 0.8796``), biases 0,
    BatchNorm scale 1, bias 0, running mean 0 and variance 1, fusion
    weights 1, and the class head's final bias ``-log((1 - p) / p)``, p =
    0.01 (the focal loss's prior)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, (kind, shape) in parameter_shapes(D_SPECS[spec_name]).items():
        if kind == "conv":
            w = torch.empty(shape)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
            out[name] = w * (math.sqrt(1.0 / (shape[1] * shape[2] * shape[3])) / _TRUNC_STD)
        else:
            out[name] = torch.full(shape, 1.0 if kind in ("scale", "var", "edge") else 0.0)
    out["class_net.final.pointwise.bias"].fill_(-math.log((1 - CLASS_PRIOR) / CLASS_PRIOR))
    return out


def _pack(obj, out: list) -> None:
    """msgpack of a nested dict of str keys, lists, ints, str, bytes and
    numpy arrays (flax's ext type 1: ``[shape, dtype name, bytes]``)."""
    if isinstance(obj, dict):
        out.append(b"\xdf" + struct.pack(">I", len(obj)))
        for k in sorted(obj):
            _pack(k, out)
            _pack(obj[k], out)
    elif isinstance(obj, np.ndarray):
        inner: list = []
        _pack([list(obj.shape), obj.dtype.name, np.ascontiguousarray(obj).tobytes()], inner)
        data = b"".join(inner)
        out.append(b"\xc9" + struct.pack(">Ib", len(data), 1) + data)
    elif isinstance(obj, list):
        out.append(b"\xdd" + struct.pack(">I", len(obj)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, int):
        out.append(b"\xd3" + struct.pack(">q", obj))
    elif isinstance(obj, str):
        data = obj.encode()
        out.append(b"\xdb" + struct.pack(">I", len(data)) + data)
    elif isinstance(obj, bytes):
        out.append(b"\xc6" + struct.pack(">I", len(obj)) + obj)
    else:
        raise TypeError(f"cannot pack {type(obj)}")


def write_seeded_checkpoint(spec_name: str, seed: int, path: str) -> None:
    """:func:`seeded_weights` as a flax msgpack checkpoint, ``{"params",
    "batch_stats"}`` with HWIO kernels and ``BatchNorm_0`` for ``bn``, in
    float32."""
    shapes = parameter_shapes(D_SPECS[spec_name])
    tree: dict = {"params": {}, "batch_stats": {}}
    for name, value in seeded_weights(spec_name, seed).items():
        kind = shapes[name][0]
        collection, leaf = _FLAX_LEAVES[kind]
        arr = value.numpy().astype(np.float32)
        if kind == "conv":
            arr = arr.transpose(2, 3, 1, 0)
        node = tree[collection]
        for part in name.split(".")[:-1]:
            node = node.setdefault("BatchNorm_0" if part == "bn" else part, {})
        node[leaf] = np.ascontiguousarray(arr)
    out: list = []
    _pack(tree, out)
    with open(path, "wb") as f:
        f.write(b"".join(out))


@contextlib.contextmanager
def _tf32(on: bool):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _decayed(key: str, param: torch.Tensor) -> bool:
    return key.endswith(".weight") and param.ndim == 4


class PlainTrainer:
    """The step of the program's ``Trainer(spec, base_lr, total_steps,
    warmup_steps)`` with the whole model trainable, from ``checkpoint``;
    the interface of ``reference/train/step.py::PlainTrainer``. Its steps
    run with TF32 off unless ``tf32``, and recompute by blocks unless
    ``recompute`` is false."""

    def __init__(self, spec_name: str, checkpoint: str, base_lr: float, total_steps: int,
                 warmup_steps: int, device, dtype=torch.float32, tf32: bool = False,
                 recompute: bool = True):
        self.spec = D_SPECS[spec_name]
        self.tf32, self.recompute = tf32, recompute
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
        cfg = AnchorConfig(input_size=self.spec.input_size, anchor_scale=self.spec.anchor_scale,
                           max_level=self.spec.max_level)
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
        with _tf32(self.tf32):
            deltas, logits, stats = forward(self.spec, {**params, **self.stats},
                                            images.to(self.dtype), train=True,
                                            recompute=self.recompute)
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
