"""Device-resident training loop: the whole dataset lives on the card.

Port of ``vbt_tpu.train.fused``. The train and valid sets go to the device
once as uint8; a step gathers its index batch there, then augments (mosaic,
flip, scale jitter, :mod:`~vbt_tpu_torch.train.augment`), assigns targets
and runs forward, backward and the update. Only the (B,) index vector
crosses from the host a step; the augmentation draws come from a
``torch.Generator`` on the device, which :meth:`DeviceDataTrainer.epoch`
hands back as JAX hands back its key. Metrics stay on the device until the
caller reads them, once an epoch.

On a CUDA trainer with no mesh and a float32 state, a step is served from
a captured CUDA graph of the whole chain (gather, augment, targets, forward,
backward, SGD, EMA), one launch where the eager step issues thousands, by
the protocol of :class:`~vbt_tpu_torch.runtime.graphs.GraphedCalls`: a key
(the batch size, the image size, the compute dtype, the jitter, the
generator) runs eagerly on the trainer's stream once, is captured and
served by the first replay on its second call, and replays after. The
state, the index batch and the step's scalars (the learning rate, the
EMA's decay and ``1 - decay``, ``mosaic_p``, computed on the host as the
eager step computes them) go in, fresh copies of the new state and
metrics come out, so that no step writes into the state it was given; the
generator advances as in the eager step. One key at a time, so that at
most one graph's private pool (a step's activations) lives. The CPU,
float64 and data-parallel steps are always eager, with no graph.

Each step records the host-clock span ``train.step``. An eager step
records inside it ``train.augment`` here and ``train.targets``,
``train.forward``, ``train.backward`` and ``train.update`` in
:meth:`Trainer.train_step` (:mod:`vbt_tpu_torch.utils.profiling`: into the
caller's open stage, else the process-wide timer); a replayed step records
``train.replay`` alone (the copy in, the replay's launch and the copy out),
so that its calls over ``train.step``'s are the graph's share.
"""

from __future__ import annotations

import numpy as np
import torch

from vbt_tpu_torch.ops.preprocess import MEAN_RGB, STDDEV_RGB
from vbt_tpu_torch.runtime.graphs import GraphedCalls, ReplaySpans
from vbt_tpu_torch.train.augment import augment_mosaic_and_normalize, draw_mosaic
from vbt_tpu_torch.train.data import DetectionDataset
from vbt_tpu_torch.train.train_step import Trainer, TrainState
from vbt_tpu_torch.utils.profiling import span

REPLAY_SPANS = ReplaySpans(call="train.replay")


class DeviceDataTrainer:
    """Wraps a :class:`Trainer` with device-resident data and fused steps."""

    def __init__(self, trainer: Trainer, train_ds: DetectionDataset,
                 valid_ds: DetectionDataset | None = None, mosaic_p: float = 0.5,
                 jitter: tuple[float, float] = (0.5, 1.6)):
        self.trainer = trainer
        self.mosaic_p = mosaic_p
        self.jitter = jitter
        self.n_train = len(train_ds)
        self._train = self._upload(train_ds)
        self._valid = self._upload(valid_ds) if valid_ds is not None and len(valid_ds) else None
        graphed = (trainer.device.type == "cuda" and trainer.mesh is None
                   and trainer.state_dtype == torch.float32)
        self.graphs = (GraphedCalls(1, torch.cuda.Stream(trainer.device), REPLAY_SPANS, "train")
                       if graphed else None)
        params = set(trainer.param_keys)
        self._stat_keys = [k for k in trainer.model.state_dict() if k not in params]

    def _upload(self, ds: DetectionDataset) -> tuple[torch.Tensor, ...]:
        dev = self.trainer.device
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (ds.images, ds.boxes, ds.valid))

    def augment(self, idx: torch.Tensor, generator: torch.Generator, mosaic_p: float) -> dict:
        """The augmented batch of the train images ``idx`` (on the device)."""
        with span("train.augment"):
            images, boxes, valid = (a[idx] for a in self._train)
            draws = draw_mosaic(generator, idx.shape[0], images.shape[1], self.jitter[0],
                                self.jitter[1], mosaic_p)
            images, boxes, valid = augment_mosaic_and_normalize(images, boxes, valid, draws)
            return {"images": images, "gt_boxes": boxes, "gt_valid": valid}

    def step(self, state: TrainState, idx: torch.Tensor, generator: torch.Generator,
             mosaic_p: float):
        """One fused step: gather, augment, targets, forward, backward, update
        (the span ``train.step``); on a CUDA trainer from a key's second call
        on, a replay of its graph (module docstring)."""
        with span("train.step"):
            if self.graphs is None:
                return self.trainer.train_step(state, self.augment(idx, generator, mosaic_p))
            key = (idx.shape[0], self._train[0].shape[1], self.trainer.dtype,
                   tuple(self.jitter), generator)
            new, metrics = self.graphs(
                key, lambda inputs, scalars: self._graphed(state, generator, inputs, scalars),
                self._flat(state) + [idx], [*self.trainer.step_scalars(state), mosaic_p],
                (generator,))
            # A replay hands back the counts and the learning rate it captured.
            metrics["lr"] = self.trainer.schedule(state.step)
            return new._replace(step=state.step + 1, opt_state=new.opt_state._replace(
                count=state.opt_state.count + 1)), metrics

    def _flat(self, state: TrainState) -> list:
        """The state's tensors in the graph's order: parameters, running
        statistics, momentum trace, EMA."""
        p, s = self.trainer.param_keys, self._stat_keys
        return ([state.params[k] for k in p] + [state.batch_stats[k] for k in s]
                + [state.opt_state.trace[k] for k in p] + [state.ema_params[k] for k in p])

    def _graphed(self, state: TrainState, generator: torch.Generator, inputs: list,
                 scalars: list):
        """The step on ``inputs`` (``_flat``'s tensors, then the index
        batch) with ``scalars`` (the learning rate, the EMA's decay and
        ``1 - decay``, the mosaic probability): host numbers in an eager
        step, the graph's 0-dim tensors in a capture. ``state`` gives the
        rest (the counts, the frozen keys)."""
        *flat, idx = inputs
        p, s = self.trainer.param_keys, self._stat_keys
        n, m = len(p), len(s)
        static = TrainState(state.step, dict(zip(p, flat[:n])), dict(zip(s, flat[n:n + m])),
                            state.opt_state._replace(trace=dict(zip(p, flat[n + m:2 * n + m]))),
                            dict(zip(p, flat[2 * n + m:])))
        *step_scalars, mosaic_p = scalars
        return self.trainer.train_step(static, self.augment(idx, generator, mosaic_p),
                                       step_scalars)

    def epoch(self, state: TrainState, rng: np.random.Generator, batch_size: int,
              generator: torch.Generator, max_batches: int | None = None,
              mosaic_p: float | None = None):
        """One shuffled epoch (the order from ``rng`` on the host, the
        augmentation from ``generator`` on the device). Returns ``(state,
        metrics, generator)``: a list of per-step metric dicts still on the
        device, and the advanced generator to pass to the next epoch.
        ``mosaic_p`` overrides the constructor's value for this epoch."""
        p = self.mosaic_p if mosaic_p is None else mosaic_p
        order = rng.permutation(self.n_train)
        stop = self.n_train - (self.n_train % batch_size)
        if max_batches is not None:
            stop = min(stop, max_batches * batch_size)
        metrics = []
        for i in range(0, stop, batch_size):
            idx = torch.as_tensor(order[i:i + batch_size], device=self.trainer.device)
            state, m = self.step(state, idx, generator, p)
            metrics.append(m)
        return state, metrics, generator

    def val_loss(self, state: TrainState, batch_size: int = 32) -> float:
        """Mean validation loss, in bounded batches, weighted by batch size."""
        if self._valid is None:
            return float("nan")
        images_all, boxes_all, valid_all = self._valid
        n = int(images_all.shape[0])
        losses, weights = [], []
        for i in range(0, n, batch_size):
            j = min(i + batch_size, n)
            images = ((images_all[i:j].float() - MEAN_RGB) / STDDEV_RGB).permute(0, 3, 1, 2)
            m = self.trainer.eval_loss(state, {"images": images, "gt_boxes": boxes_all[i:j],
                                               "gt_valid": valid_all[i:j]})
            losses.append(m["loss"])
            weights.append(j - i)
        losses = torch.stack(losses).double().cpu().numpy()
        weights = np.asarray(weights, float)
        return float((losses * weights).sum() / weights.sum())
