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

import copy
from collections import OrderedDict
from dataclasses import replace
from functools import partial
from typing import NamedTuple

import numpy as np
import torch
from torch.func import functional_call

from vbt_tpu_torch.models import EfficientDet, ModelSpec
from vbt_tpu_torch.models.anchors import generate_anchors
from vbt_tpu_torch.models.conv import BatchNorm, Conv2dSame
from vbt_tpu_torch.parallel.data_parallel import GlobalBatchStats, ShareThreads, Turns
from vbt_tpu_torch.parallel.mesh import make_mesh
from vbt_tpu_torch.runtime.batch_runner import shard_clips
from vbt_tpu_torch.runtime.pipeline import DetectionPipeline
from vbt_tpu_torch.train.losses import detection_loss
from vbt_tpu_torch.train.targets import assign_targets
from vbt_tpu_torch.utils.device import resolve_device
from vbt_tpu_torch.utils.profiling import span

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

    def update(self, grads: dict, state: OptState, params: dict,
               lr: float | torch.Tensor | None = None) -> tuple[dict, OptState]:
        """``lr``: the learning rate, by default the schedule's at the count
        (a 0-dim device tensor in a captured CUDA graph of the step)."""
        lr = self.schedule(state.count) if lr is None else lr
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
        updates = torch._foreach_mul(trace, -lr)
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
    """Owns the model, anchors, optimizer and the step functions, on
    ``device`` (``"cuda"`` unless the caller asks for the CPU). ``dtype`` is
    the compute dtype; the state is float32 under bfloat16 compute, else
    ``dtype``.

    ``mesh``, an ordered device list (``parallel.mesh.make_mesh``), makes
    the steps data-parallel, as the JAX package's jitted step is on a batch
    sharded over a ``('data',)`` mesh. The state lives on ``mesh[0]`` (the
    default ``device``; another one is refused). The global batch is split
    into equal contiguous shares, one a device in mesh order
    (``runtime.batch_runner.shard_clips``); share 0 runs ``self.model``,
    each other share a replica of it made here (a ``[cpu, cpu]`` mesh has
    two). Each share runs the forward of its images in a thread of its own,
    the shares taking turns, reading the parameters through differentiable
    copies, and every train-mode BatchNorm normalizes with the global
    batch's statistics (``parallel.data_parallel``). The outputs are gathered
    on ``mesh[0]``, where the targets, the loss (over the global positive
    count), one backward (the shares' gradients arrive summed), the
    optimizer and the EMA run as on one device. That is the one-device
    arithmetic over the global batch, which is what GSPMD computes, with
    the batch sums in another order. A mesh of one device is the one-device
    step."""

    def __init__(self, spec: ModelSpec, base_lr: float = 0.08, total_steps: int = 1000,
                 warmup_steps: int = 100, dtype: torch.dtype = torch.float32,
                 input_size: int | None = None, ema_decay: float = 0.9998,
                 freeze_top_keys: tuple = (), device: str | torch.device | None = None,
                 mesh=None):
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, got {dtype}")
        self.dtype = dtype
        self.state_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
        self.mesh = None if mesh is None else [resolve_device(d) for d in make_mesh(devices=mesh)]
        if device is None:
            device = "cuda" if self.mesh is None else self.mesh[0]
        self.device = resolve_device(device)
        if self.mesh is not None and self.device != self.mesh[0]:
            raise ValueError(f"device {self.device} is not the mesh's first device "
                             f"{self.mesh[0]}, where the state lives")
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
        # The model of each share: this one, then a replica a further share.
        self.share_models = [self.model] + [copy.deepcopy(self.model).to(dev)
                                            for dev in (self.mesh or [])[1:]]
        self.share_threads = ShareThreads(self.mesh) if len(self.share_models) > 1 else None
        self.tx, self.schedule = make_optimizer(base_lr, total_steps, warmup_steps,
                                                freeze_top_keys=self.freeze_top_keys)

    def init_state(self, seed: int = 0, input_size: int | None = None) -> TrainState:
        """A fresh state from flax's initializers, drawn from ``seed`` on the
        CPU (the same parameters on every device). ``input_size`` is JAX's
        size of the dummy image its init traces; no shape depends on it, so
        it is accepted and not read."""
        return self.state_from(DetectionPipeline.init_variables(self.spec, seed))

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

    def step_scalars(self, state: TrainState) -> tuple[float, float, float]:
        """The learning rate and the EMA's ``(decay, 1 - decay)`` of the step
        from ``state``, in float32 as JAX has them."""
        return (self.schedule(state.opt_state.count), *ema_decay_at(state.step, self.ema_decay))

    def _compute(self, params: dict) -> dict:
        """The convolutions' parameters in the compute dtype (a no-op but
        under bfloat16); differentiable, so gradients come back in the
        state's dtype."""
        return {k: v.to(self.dtype) if k in self.conv_keys else v for k, v in params.items()}

    def train_step(self, state: TrainState, batch: dict, scalars=None):
        """batch: images (B, 3, S, S) float32 normalized, gt_boxes (B, G, 4)
        pixels, gt_valid (B, G) bool, on the trainer's device. Returns (new
        state, metrics); the metrics stay on the device, but ``lr``, a float.
        ``scalars``, the learning rate and the EMA's ``(decay, 1 - decay)``,
        are :meth:`step_scalars`' where None; a CUDA graph of the step
        (``train.fused``) gives them as 0-dim device tensors it reads.
        Host-clock spans: ``train.targets``, ``train.forward`` (with the
        loss), ``train.backward`` (with the zero fill of frozen leaves) and
        ``train.update`` (SGD, then the EMA)."""
        with span("train.targets"):
            box_t, cls_t, pos, ign = assign_targets(self.anchors, batch["gt_boxes"],
                                                    batch["gt_valid"], self.spec.num_classes)
        trainable = set(self.trainable)
        params = {k: v.detach().requires_grad_(k in trainable) for k, v in state.params.items()}
        # The model updates its running statistics in place: give it copies,
        # but for the frozen subtrees, which run on theirs and leave them.
        stats = {k: (v if self.is_frozen(k) else v.clone()) for k, v in state.batch_stats.items()}
        self.model.train()
        with span("train.forward"):
            deltas, logits = self._forward(params, stats, batch["images"].to(self.dtype))
            total, metrics = detection_loss(deltas, logits, box_t, cls_t, pos, ign)
        with span("train.backward"):
            grads = dict(zip(self.trainable,
                             torch.autograd.grad(total, [params[k] for k in self.trainable])))
            grads = {k: grads[k] if k in grads else torch.zeros_like(v)
                     for k, v in state.params.items()}
        with span("train.update"):
            lr, decay, keep = self.step_scalars(state) if scalars is None else scalars
            updates, opt_state = self.tx.update(grads, state.opt_state, state.params, lr)
            new_params = apply_updates(state.params, updates)
            keys = list(new_params)
            ema = torch._foreach_add(
                torch._foreach_mul([state.ema_params[k] for k in keys], decay),
                torch._foreach_mul([new_params[k] for k in keys], keep))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["lr"] = self.schedule(state.step)
        return TrainState(state.step + 1, new_params, stats, opt_state,
                          dict(zip(keys, ema))), metrics

    @torch.no_grad()
    def eval_forward(self, state: TrainState, images: torch.Tensor):
        """(deltas, logits) with the running statistics; no update. Over a
        mesh each device runs its share and the outputs are concatenated on
        ``mesh[0]``."""
        self.model.eval()
        return self._forward(state.params, state.batch_stats, images.to(self.dtype))

    def _forward(self, params: dict, stats: dict, images: torch.Tensor):
        """(deltas, logits) of the model in its mode (train or eval) with
        ``params`` and the running statistics ``stats``, which a train-mode
        forward updates in place."""
        tensors = {**self._compute(params), **stats}
        if len(self.share_models) == 1:
            return functional_call(self.model, tensors, (images,))
        shares = shard_clips(self.mesh, images)  # refuses a batch that does not split
        train = self.model.training
        turns = Turns(len(self.mesh))
        reduce = GlobalBatchStats(self.mesh, turns) if train else None

        def share(i: int):
            dev, model = self.mesh[i], self.share_models[i]
            model.train(train)
            placed = tensors
            if i:  # the first share's statistics are those the step returns
                placed = {k: v.to(dev, copy=train and k in stats and not self.is_frozen(k))
                          for k, v in tensors.items()}
            bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
            for m in bns:
                m.reduce_stats = None if reduce is None else partial(reduce.stats, i)
            try:
                return functional_call(model, placed, shares[i])
            finally:
                for m in bns:
                    m.reduce_stats = None

        outs = self.share_threads.run(share, turns)
        return tuple(torch.cat([out[j].to(self.device) for out in outs]) for j in range(2))

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
