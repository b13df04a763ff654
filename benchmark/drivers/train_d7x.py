"""The train family on EfficientDet-D7x (``d7x.train``): the cell of
``drivers/train.py`` with three changes.

- No weights ship with the configuration: its ``checkpoint`` names a
  recipe (``configs/d7x_weights.json``), and set-up draws the weights from
  the seed plus the recipe's ``seed_offset``
  (``reference/effdet_d7x/step.py::write_seeded_checkpoint``, flax's
  initializers), writes them in the checkpoint layout into a temporary
  directory and points the program and the reference at that file.
- The check runs the plain trainer of ``reference/effdet_d7x/`` (TF32 off
  unless the control asks for it, recomputing by blocks) in the place of
  ``reference/train/step.py``'s.
- ``change_gap`` and ``ema_gap`` leave out, besides ``train.py``'s leaves
  (a reference gradient under a thousandth of the median leaf's), the
  leaves the reference moved by less than one float32 ulp an element over
  the stage: the norm of the reference's change under the norm of the
  spacing of the leaf's values before it. Such a leaf moves by rounding
  alone. The step from seeded weights at this batch's learning rate
  (0.0025 with a warmup of 640 steps: 4e-6 at the first step that moves
  anything) leaves most leaves there at the start: float32 turns
  ``p - lr * trace`` into ``p`` or a one-ulp neighbour, and a flip between
  the two on a leaf at the median's scale reads 1, as a state left
  unchanged does.

Everything else of the cell (traffic, set-up, window, stages, the other
numbers) is ``train.py``'s.
"""

from __future__ import annotations

import functools
import os
import shutil
import sys
import tempfile

import numpy as np

from benchmark.drivers import train

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "ema_gap", "stats_gap")


def ulp_norm(values) -> float:
    """The norm of the spacing of float32 ``values``: one ulp an element."""
    import torch

    a = values.detach().float().abs()
    return float(torch.linalg.vector_norm((torch.nextafter(a, torch.full_like(a, float("inf")))
                                           - a).double()))


def representable(change: dict, before: dict, keys) -> list:
    """The leaves of ``keys`` whose ``change`` is at least one ulp an
    element of their values ``before``."""
    import torch

    return [k for k in keys
            if float(torch.linalg.vector_norm(change[k].double())) >= ulp_norm(before[k])]


def stage_gaps(prog: dict, want: dict, before: dict) -> dict:
    """``train.stage_gaps`` with ``change_gap`` and ``ema_gap`` over the
    representable leaves (module docstring); ``before`` holds the stage's
    starting ``params`` and ``ema``."""
    import torch

    gaps = train.stage_gaps(prog, want)
    grad = want["grad1"]
    norms = {k: float(torch.linalg.vector_norm(grad[k].double())) for k in grad}
    med = float(np.median(list(norms.values())))
    moved = [k for k in grad if norms[k] >= 1e-3 * med]
    for name, part in (("change_gap", "change"), ("ema_gap", "ema")):
        keys = representable(want[part], before["params" if part == "change" else "ema"], moved)
        gaps[name] = train.leaf_gap(prog[part], want[part], keys) if keys else 0.0
        gaps[f"{part}_leaves"] = len(keys)
    return gaps


class Cell(train.Cell):
    def setup(self) -> None:
        from benchmark.core.registry import load_json
        from benchmark.reference.effdet_d7x.step import write_seeded_checkpoint
        from vbt_tpu_torch.models import get_model_spec

        get_model_spec(self.config["spec"])  # a program without the spec fails here, at once
        # train.py draws the frames from the seed, the order from seed + 2 and
        # the augmentation from seed + 3.
        recipe = load_json(self.root / self.config["checkpoint"])
        self.weights_dir = tempfile.mkdtemp(prefix="bench_d7x_")
        path = os.path.join(self.weights_dir, f"{self.config['spec']}.msgpack")
        write_seeded_checkpoint(self.config["spec"], self.seed + recipe["seed_offset"], path)
        self.config = dict(self.config, checkpoint=path)
        super().setup()

    def reference_records(self, tf32: bool = False) -> tuple[dict, dict]:
        from benchmark.reference.effdet_d7x.step import PlainTrainer
        from benchmark.reference.train import step

        lite = step.PlainTrainer
        step.PlainTrainer = functools.partial(PlainTrainer, tf32=tf32)
        try:
            return super().reference_records(tf32)
        finally:
            step.PlainTrainer = lite

    def check(self, limits: dict) -> list[dict]:
        from benchmark.reference.effdet_d7x.step import load_checkpoint

        try:
            want_start, want_late = self.reference_records()
            first = {k: v for k, v in load_checkpoint(self.config["checkpoint"]).items()
                     if k in want_start["grad1"]}
            start = stage_gaps(self.record, want_start, {"params": first, "ema": first})
            late = stage_gaps(self.late_record, want_late, self.late_start)
            start["grad_gap"] = train.leaf_gap(self.record["grad1"], want_start["grad1"],
                                               list(want_start["grad1"]))
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)
            shutil.rmtree(self.weights_dir, ignore_errors=True)
        self.counters["stages"] = {"start": start, "late": late}
        for name, g in (("start", start), ("late", late)):
            print(f"check {name} stage: " + ", ".join(f"{k} {g[k]!r}" for k in NUMBERS if k in g)
                  + f"; {g['left_out']} of {g['leaves']} leaves left out by the gradient rule "
                  f"(median {g['median_grad']:.3e}); change_gap over {g['change_leaves']}, "
                  f"ema_gap over {g['ema_leaves']} moved by an ulp an element or more",
                  file=sys.stderr)
        return [{"name": k, "value": max(start.get(k, 0.0), late.get(k, 0.0)), "limit": limits[k]}
                for k in NUMBERS]
