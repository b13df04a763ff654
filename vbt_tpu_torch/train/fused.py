"""Device-resident training loop: the whole dataset lives on the card.

Port of ``vbt_tpu.train.fused``. The train and valid sets go to the device
once as uint8; a step gathers its index batch there, then augments (mosaic,
flip, scale jitter, :mod:`~vbt_tpu_torch.train.augment`), assigns targets
and runs forward, backward and the update. Only the (B,) index vector
crosses from the host a step; the augmentation draws come from a
``torch.Generator`` on the device, which :meth:`DeviceDataTrainer.epoch`
hands back as JAX hands back its key. Metrics stay on the device until the
caller reads them, once an epoch.

Each step records the host-clock spans ``train.step`` and, inside it,
``train.augment`` here and ``train.targets``, ``train.forward``,
``train.backward`` and ``train.update`` in :meth:`Trainer.train_step`
(:mod:`vbt_tpu_torch.utils.profiling`: into the caller's open stage, else
the process-wide timer).
"""

from __future__ import annotations

import numpy as np
import torch

from vbt_tpu_torch.ops.preprocess import MEAN_RGB, STDDEV_RGB
from vbt_tpu_torch.train.augment import augment_mosaic_and_normalize, draw_mosaic
from vbt_tpu_torch.train.data import DetectionDataset
from vbt_tpu_torch.train.train_step import Trainer, TrainState
from vbt_tpu_torch.utils.profiling import span


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
        (the span ``train.step``, the stages' spans inside it)."""
        with span("train.step"):
            return self.trainer.train_step(state, self.augment(idx, generator, mosaic_p))

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
