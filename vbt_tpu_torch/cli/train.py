"""Train EfficientDet barbell detectors (Lite0-2, and D3 and D7x from their seeded init).

Port of ``vbt_tpu.cli.train`` with its flags and defaults: the VOC layout
``data/{train,valid,test}``, the export names ``{arch}[_whole]``, the peak
learning rate ``0.08 * batch / 64`` by default, a warmup of ``total_steps //
20``, mosaic off for the final 10% of epochs, ``--heads_only`` freezing
backbone and BiFPN from the ``{arch}_whole.msgpack`` donor (looked up in
``--export_dir``, then in the repo's ``models/``, before the model is
initialized), ``--init_from``, ``--resume`` and ``--checkpoint_every``, one
``loss: ... - val_loss: ...`` line an epoch, then the raw and the EMA
parameters evaluated through ``DetectionPipeline`` (the NMS kernel, once a
batch of 32 images) and ``evaluate_model``, the better one exported to
``{name}.msgpack`` beside the ``{name}.log`` that ``vbt-torch-training-plot``
reads. Checkpoints are flax msgpack, loadable by both packages.

Training runs on the card (``device="cuda"``, float32) and raises without
one; before it touches the card, :func:`run` selects the kernel build
cache and probes the card in a deadlined subprocess
(:mod:`vbt_tpu_torch.utils.cache`, :mod:`vbt_tpu_torch.utils.health`), as
the JAX CLI does. bfloat16 compute (``Trainer(dtype=torch.bfloat16)``) has
no flag, as in the JAX CLI. click is imported inside :func:`make_command`,
cv2 by the data loaders.

Usage: ``python -m vbt_tpu_torch.cli.train --data_dir data --export_dir
models --epochs 50 --batch_size 32``
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from vbt_tpu_torch.models import get_model_spec
from vbt_tpu_torch.runtime.checkpoint import (
    latest_train_checkpoint,
    load_params,
    load_train_checkpoint,
    save_params,
    save_train_checkpoint,
)
from vbt_tpu_torch.runtime.pipeline import DetectionPipeline
from vbt_tpu_torch.train.data import load_voc_dataset
from vbt_tpu_torch.train.evaluate import evaluate_model
from vbt_tpu_torch.train.fused import DeviceDataTrainer
from vbt_tpu_torch.train.train_step import Trainer
from vbt_tpu_torch.utils.profiling import process_timer

REPO_MODELS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "models")
FREEZE = ("backbone", "fpn")


def find_donor(architecture: str, export_dir: str) -> str:
    """The heads-only donor ``{architecture}_whole.msgpack``: in
    ``export_dir``, else in the repo's ``models/``; raises if neither has it."""
    name = f"{architecture}_whole.msgpack"
    candidates = [os.path.join(d, name) for d in (export_dir, REPO_MODELS)]
    found = next((p for p in candidates if os.path.isfile(p)), None)
    if found is None:
        raise FileNotFoundError(
            f"--heads_only needs a trained donor backbone: none of {candidates} exists. "
            "Train the _whole variant first.")
    return found


def donor_state(trainer: Trainer, state, donor_path: str):
    """A fresh state whose frozen subtrees (backbone and BiFPN, parameters
    and running statistics) come from the checkpoint at ``donor_path``."""
    own = trainer.variables(state)
    donor = load_params(donor_path, own)
    return trainer.state_from(
        {k: (donor[k] if trainer.is_frozen(k) else v) for k, v in own.items()})


def train_model(
    architecture: str,
    data_dir: str,
    export_dir: str,
    epochs: int,
    batch_size: int,
    train_whole_model: bool,
    base_lr: float | None = None,
    seed: int = 0,
    max_steps: int | None = None,
    log_fn=print,
    input_size: int | None = None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    mosaic_p: float = 0.5,
    init_from: str | None = None,
    device: str | torch.device = "cuda",
):
    """Train on ``data_dir/{train,valid}``; returns (trainer, state,
    val_losses)."""
    spec = get_model_spec(architecture)
    size = input_size or spec.input_size

    train_ds = load_voc_dataset(os.path.join(data_dir, "train"), size)
    valid_ds = load_voc_dataset(os.path.join(data_dir, "valid"), size)

    steps_per_epoch = max(len(train_ds) // batch_size, 1)
    total_steps = steps_per_epoch * epochs
    if max_steps is not None:
        total_steps = min(total_steps, max_steps)
    lr = base_lr if base_lr is not None else 0.08 * batch_size / 64.0

    # Heads-only: backbone + BiFPN frozen from the donor, the heads train.
    freeze = () if train_whole_model else FREEZE
    donor_path = find_donor(architecture, export_dir) if freeze else None

    trainer = Trainer(spec, base_lr=lr, total_steps=total_steps,
                      warmup_steps=max(total_steps // 20, 1), input_size=size,
                      freeze_top_keys=freeze, device=device)
    state = trainer.init_state(seed=seed)

    if freeze:
        state = donor_state(trainer, state, donor_path)
        log_fn(f"Heads-only: froze backbone+fpn from {donor_path}")

    if init_from:
        # Warm start: params and running statistics from an exported
        # .msgpack, a fresh optimizer (--resume restores the whole state).
        state = trainer.state_from(load_params(init_from, trainer.variables(state)))
        log_fn(f"Warm start from {init_from}")

    start_epoch = 0
    if resume and checkpoint_dir is not None:
        latest = latest_train_checkpoint(checkpoint_dir)
        if latest is not None:
            state = load_train_checkpoint(checkpoint_dir, latest, state)
            start_epoch = latest
            log_fn(f"Resumed from checkpoint at epoch {latest}")

    ddt = DeviceDataTrainer(trainer, train_ds, valid_ds, mosaic_p=mosaic_p)

    rng = np.random.default_rng(seed + start_epoch)
    generator = torch.Generator(device=trainer.device).manual_seed(seed + start_epoch)
    step = start_epoch * steps_per_epoch
    val_losses = []
    mosaic_cutoff = int(epochs * 0.9)  # mosaic off for the final 10%
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        remaining = None if max_steps is None else max(max_steps - step, 0)
        state, train_metrics, generator = ddt.epoch(
            state, rng, batch_size, generator, max_batches=remaining,
            mosaic_p=mosaic_p if epoch < mosaic_cutoff else 0.0)
        step += len(train_metrics)

        val_loss = ddt.val_loss(state)
        val_losses.append(val_loss)
        train_loss = (float(torch.stack([m["loss"] for m in train_metrics]).double().mean())
                      if train_metrics else float("nan"))
        log_fn(f"Epoch {epoch + 1}/{epochs} - {time.time() - t0:.0f}s - "
               f"loss: {train_loss:.4f} - val_loss: {val_loss:.4f}")
        if checkpoint_dir is not None and checkpoint_every and (epoch + 1) % checkpoint_every == 0:
            save_train_checkpoint(checkpoint_dir, epoch + 1, state)
        if max_steps is not None and step >= max_steps:
            break

    return trainer, state, val_losses


def run(data_dir, export_dir, architecture, epochs, batch_size, train_whole_model, lr, seed,
        max_steps, checkpoint_dir, checkpoint_every, resume, mosaic_p, init_from,
        device="cuda", timing: bool = False) -> dict:
    """The body of the CLI, callable without click: train, evaluate raw
    and EMA parameters on ``data_dir/test``, export the better one and
    write the log. Returns the evaluation results by tag. ``timing``
    prints the process-wide spans at the end (the train step's
    ``train.*``, the evaluation's ``detect.*``)."""
    from vbt_tpu_torch.utils.cache import enable_persistent_cache
    from vbt_tpu_torch.utils.health import require_healthy_device

    enable_persistent_cache()
    require_healthy_device(device, context="train")  # fail fast on a wedged card
    os.makedirs(export_dir, exist_ok=True)
    name = f"{architecture}_whole" if train_whole_model else architecture
    log_lines = []

    def log_fn(msg):
        print(msg)
        log_lines.append(msg)

    trainer, state, _ = train_model(
        architecture, data_dir, export_dir, epochs, batch_size, train_whole_model,
        base_lr=lr, seed=seed, max_steps=max_steps, log_fn=log_fn,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every, resume=resume,
        mosaic_p=mosaic_p, init_from=init_from, device=device)

    print("Evaluating the exported model...")
    results = {}
    for tag, use_ema in (("raw", False), ("ema", True)):
        pipeline = DetectionPipeline(trainer.spec, trainer.variables(state, use_ema=use_ema),
                                     device=trainer.device)
        results[tag] = evaluate_model(pipeline, os.path.join(data_dir, "test"))
        log_fn(f"{tag}: {results[tag]}")

    # Export whichever parameter set evaluates better (EMA usually wins).
    best = max(results, key=lambda t: results[t]["AP"])
    ckpt_path = os.path.join(export_dir, f"{name}.msgpack")
    save_params(ckpt_path, trainer.variables(state, use_ema=best == "ema"))
    log_fn(f"Exported {ckpt_path} ({best} params, AP={results[best]['AP']:.4f})")

    with open(os.path.join(export_dir, f"{name}.log"), "w") as f:
        f.write("\n".join(log_lines) + "\n")
    if timing:
        print(process_timer().report())
    return results


def make_command():
    """Build the click command (click is imported here, not at import)."""
    import click

    @click.command()
    @click.option("--data_dir", default="data", show_default=True,
                  help="Dataset root containing train/valid/test VOC directories.")
    @click.option("--export_dir", default="models", show_default=True)
    @click.option("--architecture", default="efficientdet_lite0", show_default=True,
                  type=click.Choice(["efficientdet_lite0", "efficientdet_lite1",
                                     "efficientdet_lite2", "efficientdet_d3",
                                     "efficientdet_d7x"]))
    @click.option("--epochs", default=50, show_default=True, type=int)
    @click.option("--batch_size", default=4, show_default=True, type=int)
    @click.option("--train_whole_model/--heads_only", default=True, show_default=True)
    @click.option("--lr", default=None, type=float,
                  help="Peak learning rate; default scales 0.08 * batch/64.")
    @click.option("--seed", default=0, type=int, show_default=True)
    @click.option("--max_steps", default=None, type=int, help="Hard step cap (smoke tests).")
    @click.option("--checkpoint_dir", default=None,
                  help="Directory for mid-training checkpoints.")
    @click.option("--checkpoint_every", default=0, type=int, show_default=True,
                  help="Checkpoint every N epochs (0 = off).")
    @click.option("--resume", is_flag=True, help="Resume from the latest checkpoint.")
    @click.option("--mosaic_p", default=0.5, type=float, show_default=True,
                  help="Per-image probability of 4-image mosaic augmentation.")
    @click.option("--init_from", default=None,
                  help="Warm-start params/batch_stats from an exported .msgpack "
                       "(fresh optimizer; unlike --resume).")
    @click.option("--timing", is_flag=True,
                  help="Print the train step's per-span wall-clock accounting at the end.")
    def command(data_dir, export_dir, architecture, epochs, batch_size, train_whole_model, lr,
                seed, max_steps, checkpoint_dir, checkpoint_every, resume, mosaic_p, init_from,
                timing):
        """Train a barbell detector and export it with COCO-style evaluation."""
        run(data_dir, export_dir, architecture, epochs, batch_size, train_whole_model, lr, seed,
            max_steps, checkpoint_dir, checkpoint_every, resume, mosaic_p, init_from,
            timing=timing)

    return command


def main(args=None, standalone_mode: bool = True):
    """Console entry point (``vbt-torch-train``)."""
    return make_command().main(args=args, standalone_mode=standalone_mode)


if __name__ == "__main__":
    main()
