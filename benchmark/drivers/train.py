"""The train family: ``vbt-torch-train``'s device-resident step.

Traffic (``traffic/<mix>.json``): a VOC tree of ``images`` plate frames of
``height`` x ``width`` from :mod:`benchmark.core.scene` (one frame of each
of several sets, the disc's analytic box labelled ``barbell``), written as
JPEG and XML under ``TMPDIR`` at set-up and loaded with the program's
``load_voc_dataset`` at the model's input size. The step is
``DeviceDataTrainer.step`` of a ``Trainer`` warm-started from the
configuration's checkpoint (the CLI's ``--init_from``), batch ``batch``,
``lr`` the CLI's ``0.08 * batch / 64``, the schedule of ``epochs``
epochs, mosaic ``mosaic_p``; index batches from a shuffled order drawn
from the seed, an epoch at a time, and the augmentation from a card
generator seeded from it.

Set-up builds the trainer and drives it through its first ``compared``
steps (rows that all differ), which warm every shape; the same object
goes on in the window. ``train_img_per_s``: images of every step in the
window over the time from its start to a synchronize after the last one.
The window keeps the state, index batch and generator state before each
of its last ``replayed`` steps (the state is never written in place, so
keeping it costs no copy).

The check compares two stages with the reference
(``reference/train/step.py``) on the same images, index batches and
generator states: the start, the first ``compared`` steps from the
checkpoint file; and the window's last ``replayed`` steps, from the
program's own state before them (weights, BatchNorm statistics, momentum,
EMA and count), which the reference takes as its start:

- ``loss_gap``: the widest relative gap of a step's loss;
- ``grad_gap``: the first gradient as the optimizer took it (clipped and
  decayed, the momentum trace after step 1), by the worst leaf: the gap of
  the leaf's norms over the larger of the reference leaf's norm and the
  median leaf's (the start only);
- ``change_gap``, ``ema_gap``: the change over the stage of the
  parameters and of their EMA, the same way, over the leaves whose
  reference gradient (the stage's first) is at least a thousandth of the
  median leaf's (the others move by round-off alone);
- ``stats_gap``: the change of the BatchNorm running statistics, the
  same way, over every leaf.

Each number is the worse of the two stages; standard error prints both.
"""

from __future__ import annotations

import collections
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from benchmark.core import scene


def write_voc(root: str, mix: dict, rng: np.random.Generator, device) -> None:
    """``images`` frames, each with its VOC XML: the disc's box, label
    ``barbell``."""
    import cv2

    per_set = mix["images_per_set"]
    n_sets = -(-mix["images"] // per_set)
    written = 0
    for s in range(n_sets):
        plan = scene.plan_set(rng, mix["set_frames"], mix["height"], mix["width"], 5, 8,
                              mix["radius"], mix["amplitude"])
        picks = np.sort(rng.choice(plan.frames, size=per_set, replace=False))
        cy = scene.center_y(plan) * plan.height
        r, cx = plan.radius * plan.height, plan.center_x * plan.width
        for t in picks:
            if written == mix["images"]:
                return
            img = scene.render(plan, device, int(t), int(t) + 1)[0].cpu().numpy()
            name = f"plate_{written:04d}"
            cv2.imwrite(os.path.join(root, f"{name}.jpg"), img[..., ::-1])
            box = np.rint([cy[t] - r, cx - r, cy[t] + r, cx + r]).astype(int)
            with open(os.path.join(root, f"{name}.xml"), "w") as f:
                f.write(f"<annotation><filename>{name}.jpg</filename><object><name>barbell"
                        f"</name><bndbox><xmin>{box[1]}</xmin><ymin>{box[0]}</ymin>"
                        f"<xmax>{box[3]}</xmax><ymax>{box[2]}</ymax></bndbox></object>"
                        f"</annotation>")
            written += 1


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def state_tensors(state) -> dict:
    """The program's state as the reference takes it: dicts of tensors and
    the step count."""
    return {"params": state.params, "stats": state.batch_stats, "trace": state.opt_state.trace,
            "ema": state.ema_params, "count": int(state.opt_state.count)}


def stage_record(after, before, losses) -> dict:
    """What the program did over a stage: its losses and the change of the
    parameters, their EMA and the BatchNorm statistics."""
    return {"losses": [float(x) for x in losses], "change": delta(after.params, before.params),
            "ema": delta(after.ema_params, before.ema_params),
            "stats": delta(after.batch_stats, before.batch_stats)}


def stage_gaps(prog: dict, want: dict) -> dict:
    """A stage's numbers (module docstring), and how many leaves the rule
    left out of ``change_gap`` and ``ema_gap``."""
    import torch

    grad = want["grad1"]
    norms = {k: float(torch.linalg.vector_norm(grad[k].double())) for k in grad}
    med = float(np.median(list(norms.values())))
    moved = [k for k in grad if norms[k] >= 1e-3 * med]
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], want["losses"])),
            "change_gap": leaf_gap(prog["change"], want["change"], moved),
            "ema_gap": leaf_gap(prog["ema"], want["ema"], moved),
            "stats_gap": leaf_gap(prog["stats"], want["stats"], list(want["stats"])),
            "left_out": len(grad) - len(moved), "leaves": len(grad), "median_grad": med}


def leaf_gap(prog: dict, ref: dict, keys) -> float:
    """Worst leaf: |norm(prog) - norm(ref)| over max(norm(ref), median
    leaf's norm of ref)."""
    import torch

    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in keys}
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    med = float(np.median(list(rn.values())))
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys)


class Cell:
    device = "cuda"
    trainer_hook = None  # a control or a test may change the program's step

    def __init__(self, config: dict, mix: dict, seed: int, traced: bool, root):
        self.config, self.mix, self.seed, self.traced, self.root = config, mix, seed, traced, root
        self.attempted = self.failed = 0
        self.window_s = 0.0
        self.spans = {}
        self.counters = {}

    def _hparams(self, n_train: int) -> dict:
        m = self.mix
        total = max(n_train // m["batch"], 1) * m["epochs"]
        return {"base_lr": 0.08 * m["batch"] / 64.0, "total_steps": total,
                "warmup_steps": max(total // 20, 1)}

    def setup(self) -> None:
        import torch

        from vbt_tpu_torch.models import get_model_spec
        from vbt_tpu_torch.runtime.checkpoint import load_params
        from vbt_tpu_torch.train.data import load_voc_dataset
        from vbt_tpu_torch.train.fused import DeviceDataTrainer
        from vbt_tpu_torch.train.train_step import Trainer

        m = self.mix
        rng = np.random.default_rng(self.seed)
        self.tmp = tempfile.mkdtemp(prefix="bench_train_")
        write_voc(self.tmp, m, rng, self.device)
        spec = get_model_spec(self.config["spec"])
        ds = load_voc_dataset(self.tmp, spec.input_size)
        self.hp = self._hparams(len(ds))
        trainer = Trainer(spec, device=self.device, input_size=spec.input_size, **self.hp)
        state = trainer.init_state(seed=0)
        state = trainer.state_from(load_params(str(self.root / self.config["checkpoint"]),
                                               trainer.variables(state)))
        self.ddt = DeviceDataTrainer(trainer, ds, None, mosaic_p=m["mosaic_p"],
                                     jitter=tuple(m["jitter"]))
        if self.trainer_hook is not None:
            self.trainer_hook(trainer)
        self.images = (ds.images, ds.boxes, ds.valid)
        self.order_rng = np.random.default_rng(self.seed + 2)
        self.gen_seed = self.seed + 3
        self.generator = torch.Generator(device=trainer.device).manual_seed(self.gen_seed)
        self._order = []
        self.first_idx = []
        start = state
        losses = []
        for i in range(m["compared"]):
            idx = self._next_idx()
            self.first_idx.append(idx.cpu().numpy())
            state, metrics = self.ddt.step(state, idx, self.generator, m["mosaic_p"])
            losses.append(metrics["loss"])
            if i == 0:
                grad1 = {k: v.clone() for k, v in state.opt_state.trace.items()}
        self.record = dict(stage_record(state, start, losses), grad1=grad1)
        self.state = state
        if self.device == "cuda":
            torch.cuda.synchronize()

    def _next_idx(self):
        import torch

        if len(self._order) < self.mix["batch"]:
            n = self.ddt.n_train
            order = self.order_rng.permutation(n)
            self._order = list(order[:n - n % self.mix["batch"]])
        idx, self._order = self._order[:self.mix["batch"]], self._order[self.mix["batch"]:]
        return torch.as_tensor(np.asarray(idx), device=self.ddt.trainer.device)

    def run_window(self, seconds: float, tracer) -> dict:
        import torch

        m = self.mix
        steps = 0
        state = self.state
        ring = collections.deque(maxlen=m["replayed"])
        losses = collections.deque(maxlen=m["replayed"])
        with tracer.window():
            t0 = time.perf_counter()
            marks = [t0]
            while time.perf_counter() - t0 < seconds:
                idx = self._next_idx()
                ring.append((state, idx, self.generator.get_state()))
                state, metrics = self.ddt.step(state, idx, self.generator, m["mosaic_p"])
                losses.append(metrics["loss"])
                steps += 1
                if steps % 10 == 0:
                    marks.append(time.perf_counter())
            if self.device == "cuda":
                torch.cuda.synchronize()
            self.window_s = time.perf_counter() - t0
        self.state = state
        self.late_start = state_tensors(ring[0][0])
        self.late_steps = [(idx.cpu().numpy(), gen) for _, idx, gen in ring]
        self.late_record = stage_record(state, ring[0][0], losses)
        self.attempted = steps
        per10 = np.diff(marks)
        if len(per10):
            print(f"window: {steps} steps in {self.window_s:.3f} s, host seconds per 10 steps "
                  f"min/median/max {per10.min():.3f} {np.median(per10):.3f} {per10.max():.3f}",
                  file=sys.stderr)
        self.counters.update(steps=steps, images=steps * m["batch"])
        return {"train_img_per_s": steps * m["batch"] / self.window_s}

    def release(self) -> None:
        import torch

        del self.ddt, self.state
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def reference_records(self, tf32: bool = False) -> tuple[dict, dict]:
        """What the reference does over both stages: from the checkpoint
        file through the first steps, and from the program's state before
        the window's last steps through those; each with the same images,
        index batches and generator states. ``tf32`` computes it with TF32
        on, the control's precision."""
        import torch

        from benchmark.reference.train.step import PlainTrainer, augmented

        m = self.mix
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            ref = PlainTrainer(self.config["spec"], str(self.root / self.config["checkpoint"]),
                               device=self.device, **self.hp)
            images, boxes, valid = (torch.from_numpy(np.ascontiguousarray(a)).to(ref.device)
                                    for a in self.images)
            gen = torch.Generator(device=ref.device).manual_seed(self.gen_seed)
            records = []
            for steps in ([(idx, None) for idx in self.first_idx], self.late_steps):
                if records:
                    ref.load_state(**self.late_start)
                before, losses = ref.state(), []
                for i, (idx, gen_state) in enumerate(steps):
                    if gen_state is not None:
                        gen.set_state(gen_state)
                    batch = augmented(images, boxes, valid, torch.as_tensor(idx, device=ref.device),
                                      gen, m["jitter"], m["mosaic_p"])
                    out = ref.step(*batch)
                    losses.append(out["loss"])
                    if i == 0:
                        grad1 = out["opt_grad"]
                after = ref.state()
                records.append({"losses": losses, "grad1": grad1,
                                "change": delta(after["params"], before["params"]),
                                "ema": delta(after["ema"], before["ema"]),
                                "stats": delta(after["stats"], before["stats"])})
            return records[0], records[1]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def check(self, limits: dict) -> list[dict]:
        want_start, want_late = self.reference_records()
        start = stage_gaps(self.record, want_start)
        late = stage_gaps(self.late_record, want_late)
        start["grad_gap"] = leaf_gap(self.record["grad1"], want_start["grad1"],
                                     list(want_start["grad1"]))
        shutil.rmtree(self.tmp, ignore_errors=True)
        self.counters["stages"] = {"start": start, "late": late}
        for name, g in (("start", start), ("late", late)):
            print(f"check {name} stage: " + ", ".join(
                f"{k} {g[k]!r}" for k in ("loss_gap", "grad_gap", "change_gap", "ema_gap",
                                          "stats_gap") if k in g)
                  + f"; {g['left_out']} of {g['leaves']} leaves left out of change_gap and ema_gap"
                  f" (reference gradient under a thousandth of the median leaf's, "
                  f"{g['median_grad']:.3e})", file=sys.stderr)
        return [{"name": k, "value": max(start.get(k, 0.0), late.get(k, 0.0)), "limit": limits[k]}
                for k in ("loss_gap", "grad_gap", "change_gap", "ema_gap", "stats_gap")]
