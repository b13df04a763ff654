"""COCO AP of every saved training checkpoint of a run, raw and EMA.

Port of the JAX package's ``tools/ckpt_sweep.py`` with the same arguments
and printed lines; ``--data_dir`` defaults to the reference project's
data, ``reference/data`` under the working directory
(:data:`._reference.DATA_DIR`), where JAX's tool names the reference's
data by its absolute location. From-scratch schedules can peak before the last
epoch, so a checkpoint is chosen on evidence: every ``step_*.msgpack`` of
``CKPT_DIR`` (either package's train checkpoints) is loaded into a
``Trainer(spec, base_lr=0.01, total_steps=10, warmup_steps=1)`` state and
its raw and EMA parameters are evaluated on ``DATA_DIR/test`` through a
float32 ``DetectionPipeline`` (JAX's default dtype), one line each:

    epoch {step:5d} {raw|ema}: AP ... AP50 ... AP75 ...

:mod:`vbt_tpu_torch.tools.ckpt_soup` reads these lines.

Usage: ``python -m vbt_tpu_torch.tools.ckpt_sweep ARCH CKPT_DIR [--data_dir D]``
"""

from __future__ import annotations

import glob
import os
import re
import sys

import torch

from vbt_tpu_torch.tools._reference import DATA_DIR as DEFAULT_DATA_DIR


def checkpoint_steps(ckpt_dir: str) -> list[int]:
    """The steps of every ``step_*.msgpack`` in ``ckpt_dir``, ascending."""
    return sorted(int(re.search(r"step_(\d+)", p).group(1))
                  for p in glob.glob(os.path.join(ckpt_dir, "step_*.msgpack")))


def selection_trainer(architecture: str, device):
    """The trainer whose fresh state is the template every train checkpoint
    of a run is read into (the JAX tools' ``Trainer`` and seed)."""
    from vbt_tpu_torch.models import get_model_spec
    from vbt_tpu_torch.train.train_step import Trainer

    trainer = Trainer(get_model_spec(architecture), base_lr=0.01, total_steps=10,
                      warmup_steps=1, device=device)
    return trainer, trainer.init_state(seed=0)


def evaluate_variables(spec, variables: dict, test_dir: str, device) -> dict:
    """COCO AP / AP50 / AP75 of a model ``state_dict`` on a VOC directory,
    served in float32 on ``device`` (K1 on the card)."""
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline
    from vbt_tpu_torch.train.evaluate import evaluate_model

    pipe = DetectionPipeline(spec, variables, device=device, dtype=torch.float32)
    return evaluate_model(pipe, test_dir)


def format_metrics(m: dict) -> str:
    """``AP ... AP50 ... AP75 ...`` to 4 decimals, as every tool prints them."""
    return f"AP {m['AP']:.4f} AP50 {m['AP50']:.4f} AP75 {m['AP75']:.4f}"


def sweep(architecture: str, ckpt_dir: str, data_dir: str = DEFAULT_DATA_DIR,
          device="cuda", out=None) -> list[tuple[int, str, dict]]:
    """The body of the CLI: one line to ``out`` (default stdout) a
    checkpoint and tag. Returns ``[(step, tag, metrics)]`` in print order."""
    from vbt_tpu_torch.runtime.checkpoint import load_train_checkpoint
    from vbt_tpu_torch.utils.cache import enable_persistent_cache

    out = out or sys.stdout
    enable_persistent_cache()
    trainer, template = selection_trainer(architecture, device)
    test_dir = os.path.join(data_dir, "test")
    results = []
    for step in checkpoint_steps(ckpt_dir):
        state = load_train_checkpoint(ckpt_dir, step, template)
        for tag, use_ema in (("raw", False), ("ema", True)):
            m = evaluate_variables(trainer.spec, trainer.variables(state, use_ema=use_ema),
                                   test_dir, device)
            print(f"epoch {step:5d} {tag}: {format_metrics(m)}", file=out, flush=True)
            results.append((step, tag, m))
    return results


def make_command():
    """Build the click command (click is imported here, not at import)."""
    import click

    @click.command()
    @click.argument("architecture")
    @click.argument("ckpt_dir")
    @click.option("--data_dir", default=DEFAULT_DATA_DIR)
    def command(architecture, ckpt_dir, data_dir):
        """Evaluate COCO AP for every saved training checkpoint of a run."""
        sweep(architecture, ckpt_dir, data_dir)

    return command


def main(args=None, standalone_mode: bool = True):
    return make_command().main(args=args, standalone_mode=standalone_mode)


if __name__ == "__main__":
    main()
