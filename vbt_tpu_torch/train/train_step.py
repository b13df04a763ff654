"""The detection train step: model, anchors, optimizer and EMA.

Port of ``vbt_tpu.train.train_step``. A :class:`TrainState` holds the
parameters and running statistics as flat dicts keyed like the model's
``state_dict``; a step never writes into the state it was given. The
optimizer is the optax chain of the JAX package, written on tensors
(:func:`make_optimizer`):

1. with frozen top-level keys, their gradients are zero (frozen subtrees
   take no gradient at all here: ``EfficientDet(frozen=...)``);
2. ``clip_by_global_norm(10)``: ``g / |g| * 10`` only when ``|g| >= 10``
   (``torch.nn.utils.clip_grad_norm_`` scales by ``10 / (|g| + 1e-6)``);
3. ``add_decayed_weights(4e-5)`` under flax's mask: every leaf but biases,
   BatchNorm scales and the frozen keys' (so every convolution kernel,
   depthwise included, is decayed);
4. ``sgd(momentum=0.9)``: ``trace = g + 0.9 trace``, ``update = -lr(count)
   trace``, with the warmup-cosine schedule read at the count *before* it
   increments (``lr(0) = 0``: the first step moves nothing but fills the
   trace).

The parameter EMA uses ``decay = min(0.9998, (1 + t) / (10 + t))`` over
the parameters only. Training runs in float32 (TF32 off on the card,
``utils.device.resolve_device``), in float64, the precision in which the
tests hold a step against JAX's, or with ``dtype=torch.bfloat16`` in flax's
compute-dtype sense (``EfficientDet(spec, dtype=jnp.bfloat16)``):
parameters, optimizer state, EMA and running statistics stay float32;
every convolution casts its input, kernel and bias to bfloat16 and computes
in it; train-mode BatchNorm reduces its statistics in float32 from the
bfloat16 activations, normalizes in float32 with its float32 scale and
bias and rounds the result to bfloat16 (flax's ``BatchNorm(dtype=bf16)``);
the losses take the logits and box outputs in float32. The gradients come
back float32 through the casts.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch
from torch.func import functional_call

from vbt_tpu_torch.models import EfficientDet, ModelSpec
from vbt_tpu_torch.models.anchors import generate_anchors
from vbt_tpu_torch.models.conv import Conv2dSame
from vbt_tpu_torch.models.efficientdet import init_parameters
from vbt_tpu_torch.train.losses import detection_loss
from vbt_tpu_torch.train.targets import assign_targets
from vbt_tpu_torch.utils.device import resolve_device

MAX_GRAD_NORM = 10.0
MOMENTUM = 0.9
DTYPES = (torch.float32, torch.float64, torch.bfloat16)  # compute dtypes


class OptState(NamedTuple):
    """SGD's momentum ``trace`` (a tensor per parameter, zero for frozen
    ones) and the schedule's ``count``; ``frozen`` names the masked top
    keys, which set the layout of optax's state in a checkpoint."""

    trace: dict
    count: int
    frozen: tuple = ()


class TrainState(NamedTuple):
    step: int
    params: dict  # state_dict key -> tensor, parameters
    batch_stats: dict  # state_dict key -> tensor, running_mean / running_var
    opt_state: OptState
    ema_params: dict  # exponential moving average of params (0.9998)


def warmup_cosine_decay_schedule(peak_value: float, warmup_steps: int, decay_steps: int):
    """optax's ``warmup_cosine_decay_schedule(0, peak, warmup, decay, 0)``:
    linear from 0 to ``peak_value`` over ``warmup_steps``, then a cosine to
    0 at ``decay_steps``; in float32 step for step as optax computes it.
    Returns a function of the (int) count."""
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"the cosine decay needs positive steps, got {cosine_steps}")
    f32 = np.float32

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
            return float(f32(0.0 - peak_value) * frac + f32(peak_value))
        t = f32(min(count - warmup_steps, cosine_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t / f32(cosine_steps)))
        return float(f32(peak_value) * (f32(1.0) * cosine + f32(0.0)))

    return schedule


def _decayed(key: str, param: torch.Tensor, frozen: tuple) -> bool:
    """flax's decay mask: no decay on biases and BatchNorm scales (the 1-d
    ``weight``s) nor on frozen top keys; every conv kernel is decayed."""
    return key.endswith(".weight") and param.ndim == 4 and key.split(".")[0] not in frozen


class SGDChain:
    """The optax chain of :func:`make_optimizer` on dicts of tensors;
    ``update`` returns the updates and the next state, as optax does, and
    :func:`apply_updates` adds them."""

    def __init__(self, schedule, weight_decay: float, frozen: tuple = ()):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.frozen = tuple(frozen)

    def init(self, params: dict) -> OptState:
        return OptState({k: torch.zeros_like(v) for k, v in params.items()}, 0, self.frozen)

    def update(self, grads: dict, state: OptState, params: dict) -> tuple[dict, OptState]:
        keys = list(params)
        g = [grads[k] for k in keys]
        # clip_by_global_norm: (t / |g|) * max_norm only when |g| >= max_norm.
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        clip = norm >= MAX_GRAD_NORM
        g = list(torch._foreach_mul(torch._foreach_div(g, torch.where(clip, norm, 1.0)),
                                    torch.where(clip, MAX_GRAD_NORM, 1.0).to(norm.dtype)))
        # add_decayed_weights under the mask.
        dec = [i for i, k in enumerate(keys) if _decayed(k, params[k], self.frozen)]
        decayed = torch._foreach_add([g[i] for i in dec], [params[keys[i]] for i in dec],
                                     alpha=self.weight_decay)
        for i, t in zip(dec, decayed):
            g[i] = t
        # sgd: trace = g + momentum * trace; update = -lr(count) * trace.
        trace = torch._foreach_add(g, [state.trace[k] for k in keys], alpha=MOMENTUM)
        updates = torch._foreach_mul(trace, -self.schedule(state.count))
        return (dict(zip(keys, updates)),
                OptState(dict(zip(keys, trace)), state.count + 1, self.frozen))


def apply_updates(params: dict, updates: dict) -> dict:
    keys = list(params)
    return dict(zip(keys, torch._foreach_add([params[k] for k in keys],
                                             [updates[k] for k in keys])))


def make_optimizer(base_lr: float, total_steps: int, warmup_steps: int,
                   weight_decay: float = 4e-5, freeze_top_keys: tuple = ()):
    """(optimizer, schedule) as the JAX package's optax chain."""
    schedule = warmup_cosine_decay_schedule(base_lr, max(warmup_steps, 1), max(total_steps, 2))
    return SGDChain(schedule, weight_decay, freeze_top_keys), schedule


def ema_decay_at(step: int, ema_decay: float) -> tuple[float, float]:
    """(decay, 1 - decay) of the EMA at ``step``, in float32 as JAX has them."""
    t = np.float32(step)
    decay = np.minimum(np.float32(ema_decay), (np.float32(1) + t) / (np.float32(10) + t))
    return float(decay), float(np.float32(1) - decay)


class Trainer:
    """Owns the model, anchors, optimizer and the step functions, on one
    device (``"cuda"`` unless the caller asks for the CPU). ``dtype`` is the
    compute dtype; the state is float32 under bfloat16 compute, else
    ``dtype``."""

    def __init__(self, spec: ModelSpec, base_lr: float = 0.08, total_steps: int = 1000,
                 warmup_steps: int = 100, dtype: torch.dtype = torch.float32,
                 input_size: int | None = None, ema_decay: float = 0.9998,
                 freeze_top_keys: tuple = (), device: str | torch.device = "cuda"):
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, got {dtype}")
        self.dtype = dtype
        self.state_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
        self.device = resolve_device(device)
        self.ema_decay = ema_decay
        self.freeze_top_keys = tuple(freeze_top_keys)
        self.spec = spec
        self.input_size = input_size or spec.input_size
        self.model = EfficientDet(spec, frozen=self.freeze_top_keys).to(self.device,
                                                                        self.state_dtype)
        self.param_keys = [k for k, _ in self.model.named_parameters()]
        # The convolutions' kernels and biases, cast to the compute dtype
        # (BatchNorm's scale and bias stay in the state's).
        self.conv_keys = {f"{name}.{k}" for name, m in self.model.named_modules()
                          if isinstance(m, Conv2dSame) for k, _ in m.named_parameters()}
        self.trainable = [k for k, p in self.model.named_parameters() if p.requires_grad]
        cfg = spec.anchor_config
        if self.input_size != cfg.input_size:
            cfg = replace(cfg, input_size=self.input_size)
        self.anchors = torch.from_numpy(generate_anchors(cfg)).to(self.device)
        self.tx, self.schedule = make_optimizer(base_lr, total_steps, warmup_steps,
                                                freeze_top_keys=self.freeze_top_keys)

    def init_state(self, seed: int = 0) -> TrainState:
        """A fresh state from flax's initializers, drawn from ``seed`` on the
        CPU (the same parameters on every device)."""
        model = init_parameters(EfficientDet(self.spec), torch.Generator().manual_seed(seed))
        return self.state_from(model.state_dict())

    def state_from(self, state_dict: dict) -> TrainState:
        """A fresh train state (step 0, zero trace, EMA = params) from a
        model ``state_dict``, moved to the trainer's device."""
        sd = {k: v.detach().to(self.device, self.state_dtype).clone()
              for k, v in state_dict.items()}
        params = {k: sd[k] for k in self.param_keys}
        stats = {k: v for k, v in sd.items() if k not in params}
        return TrainState(0, params, stats, self.tx.init(params),
                          {k: v.clone() for k, v in params.items()})

    def is_frozen(self, key: str) -> bool:
        """Whether ``key`` (a state_dict key) lies in a frozen subtree."""
        return key.split(".")[0] in self.freeze_top_keys

    def _compute(self, params: dict) -> dict:
        """The convolutions' parameters in the compute dtype (a no-op but
        under bfloat16); differentiable, so gradients come back in the
        state's dtype."""
        return {k: v.to(self.dtype) if k in self.conv_keys else v for k, v in params.items()}

    def train_step(self, state: TrainState, batch: dict):
        """batch: images (B, 3, S, S) float32 normalized, gt_boxes (B, G, 4)
        pixels, gt_valid (B, G) bool, on the trainer's device. Returns (new
        state, metrics); the metrics stay on the device, but ``lr``, a float."""
        box_t, cls_t, pos, ign = assign_targets(self.anchors, batch["gt_boxes"],
                                                batch["gt_valid"], self.spec.num_classes)
        trainable = set(self.trainable)
        params = {k: v.detach().requires_grad_(k in trainable) for k, v in state.params.items()}
        # The model updates its running statistics in place: give it copies,
        # but for the frozen subtrees, which run on theirs and leave them.
        stats = {k: (v if self.is_frozen(k) else v.clone()) for k, v in state.batch_stats.items()}
        self.model.train()
        images = batch["images"].to(self.dtype)
        deltas, logits = functional_call(self.model, {**self._compute(params), **stats},
                                         (images,))
        total, metrics = detection_loss(deltas, logits, box_t, cls_t, pos, ign)
        grads = dict(zip(self.trainable,
                         torch.autograd.grad(total, [params[k] for k in self.trainable])))
        grads = {k: grads[k] if k in grads else torch.zeros_like(v)
                 for k, v in state.params.items()}
        updates, opt_state = self.tx.update(grads, state.opt_state, state.params)
        new_params = apply_updates(state.params, updates)
        decay, keep = ema_decay_at(state.step, self.ema_decay)
        keys = list(new_params)
        ema = torch._foreach_add(torch._foreach_mul([state.ema_params[k] for k in keys], decay),
                                 torch._foreach_mul([new_params[k] for k in keys], keep))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["lr"] = self.schedule(state.step)
        return TrainState(state.step + 1, new_params, stats, opt_state,
                          dict(zip(keys, ema))), metrics

    @torch.no_grad()
    def eval_forward(self, state: TrainState, images: torch.Tensor):
        """(deltas, logits) with the running statistics; no update."""
        self.model.eval()
        return functional_call(self.model, {**self._compute(state.params), **state.batch_stats},
                               (images.to(self.dtype),))

    def eval_loss(self, state: TrainState, batch: dict) -> dict:
        """Validation loss metrics (no parameter or statistics update)."""
        box_t, cls_t, pos, ign = assign_targets(self.anchors, batch["gt_boxes"],
                                                batch["gt_valid"], self.spec.num_classes)
        deltas, logits = self.eval_forward(state, batch["images"])
        return detection_loss(deltas, logits, box_t, cls_t, pos, ign)[1]

    def variables(self, state: TrainState, use_ema: bool = False) -> "OrderedDict":
        """The model ``state_dict`` (params or their EMA, and the running
        statistics) that ``DetectionPipeline`` and ``save_params`` take."""
        params = state.ema_params if use_ema else state.params
        merged = {**params, **state.batch_stats}
        return OrderedDict((k, merged[k]) for k in self.model.state_dict())
