"""Greedy checkpoint soup: average the best checkpoints of one training run.

Port of the JAX package's ``tools/ckpt_soup.py`` with the same arguments,
defaults (``--data_dir`` the reference data under the working directory,
as in :mod:`.ckpt_sweep`) and printed lines. Late checkpoints of a long
from-scratch schedule oscillate around one basin, and the average of their weights
("model soups", Wortsman et al. 2022) often beats each of them. The
candidates are the lines of a :mod:`~vbt_tpu_torch.tools.ckpt_sweep` log
from ``--min_step`` on, ranked by ``--metric`` (ties keep the log's order),
the best ``--top_k`` of them. The soup starts from the best candidate (or
from ``--seed_msgpack``), then admits each next candidate only if the
evaluated soup's metric does not drop. Parameters and BatchNorm running
statistics are summed in float64 on the host and divided by the member
count; each trial is evaluated in float32. ``--out`` writes the final soup
as the flax msgpack both packages read (``runtime.checkpoint.save_params``).

Usage: ``python -m vbt_tpu_torch.tools.ckpt_soup ARCH CKPT_DIR --sweep_log sweep.txt
--top_k 8 --out soup.msgpack``
"""

from __future__ import annotations

import os
import re
import sys

import torch

from vbt_tpu_torch.tools.ckpt_sweep import DEFAULT_DATA_DIR, format_metrics

METRICS = ("AP", "AP50", "AP75")
_LINE = re.compile(r"epoch\s+(\d+)\s+(raw|ema): AP (\d\.\d+) AP50 (\d\.\d+) AP75 (\d\.\d+)")


def parse_sweep(path: str) -> list[tuple[int, str, dict]]:
    """The (step, tag, metrics) entries of a ckpt_sweep log, in its order."""
    out = []
    with open(path) as f:
        for line in f:
            m = _LINE.search(line)
            if m:
                out.append((int(m.group(1)), m.group(2),
                            {"AP": float(m.group(3)), "AP50": float(m.group(4)),
                             "AP75": float(m.group(5))}))
    return out


def _float64(variables: dict) -> dict:
    return {k: v.detach().to("cpu", torch.float64) for k, v in variables.items()}


def soup(architecture: str, ckpt_dir: str, sweep_log: str, top_k: int = 8, metric: str = "AP",
         min_step: int = 0, data_dir: str = DEFAULT_DATA_DIR, out: str | None = None,
         seed_msgpack: str | None = None, device="cuda", stream=None):
    """The body of the CLI, printing to ``stream`` (default stdout).
    Returns (the soup's float32 ``state_dict`` on the CPU, its members, the
    metrics of its last kept evaluation)."""
    from vbt_tpu_torch.runtime.checkpoint import load_params, load_train_checkpoint, save_params
    from vbt_tpu_torch.tools.ckpt_sweep import evaluate_variables, selection_trainer
    from vbt_tpu_torch.utils.cache import enable_persistent_cache

    if metric not in METRICS:
        raise ValueError(f"metric must be one of {METRICS}, got {metric!r}")
    stream = stream or sys.stdout
    enable_persistent_cache()
    trainer, template = selection_trainer(architecture, device)
    test_dir = os.path.join(data_dir, "test")

    cands = [c for c in parse_sweep(sweep_log) if c[0] >= min_step]
    cands.sort(key=lambda c: c[2][metric], reverse=True)
    cands = cands[:top_k]
    if not cands:
        import click

        raise click.ClickException("no candidates parsed from sweep log")

    def variables_of(step, tag):
        state = load_train_checkpoint(ckpt_dir, step, template)
        return trainer.variables(state, use_ema=tag == "ema")

    def evaluate(variables):
        return evaluate_variables(trainer.spec, {k: v.to(torch.float32)
                                                 for k, v in variables.items()},
                                  test_dir, device)

    if seed_msgpack:
        soup_sum = _float64(load_params(seed_msgpack, trainer.variables(template)))
        members = [(os.path.basename(seed_msgpack), "seed")]
        best = evaluate(soup_sum)
        print(f"seed {seed_msgpack}: {metric} {best[metric]:.4f}", file=stream, flush=True)
        rest = cands
    else:
        step, tag, swept = cands[0]
        soup_sum = _float64(variables_of(step, tag))
        members = [(step, tag)]
        best = evaluate(soup_sum)
        print(f"seed {step}/{tag}: {metric} {best[metric]:.4f} (swept {swept[metric]:.4f})",
              file=stream, flush=True)
        rest = cands[1:]

    for step, tag, swept in rest:
        more = _float64(variables_of(step, tag))
        trial_sum = {k: s + more[k] for k, s in soup_sum.items()}
        n = len(members) + 1
        m = evaluate({k: s / n for k, s in trial_sum.items()})
        keep = m[metric] >= best[metric]
        print(f"+ {step}/{tag} (swept {swept[metric]:.4f}) -> soup {format_metrics(m)} "
              f"[{'KEEP' if keep else 'drop'}]", file=stream, flush=True)
        if keep:
            soup_sum = trial_sum
            members.append((step, tag))
            best = m

    n = len(members)
    final = {k: (s / n).to(torch.float32) for k, s in soup_sum.items()}
    print(f"final soup ({n} members: {members}): {format_metrics(best)}", file=stream, flush=True)
    if out:
        # JAX's soup comes out of ``jax.tree.map``, whose dicts have sorted
        # keys, so its file holds batch_stats before params.
        save_params(out, final, collections=("batch_stats", "params"))
        print(f"saved {out}", file=stream, flush=True)
    return final, members, best


def make_command():
    """Build the click command (click is imported here, not at import)."""
    import click

    @click.command()
    @click.argument("architecture")
    @click.argument("ckpt_dir")
    @click.option("--sweep_log", required=True,
                  help="ckpt_sweep output ranking the candidates")
    @click.option("--top_k", default=8, help="candidates to consider, best-first")
    @click.option("--metric", default="AP", type=click.Choice(list(METRICS)))
    @click.option("--min_step", default=0, help="ignore earlier checkpoints")
    @click.option("--data_dir", default=DEFAULT_DATA_DIR)
    @click.option("--out", default=None, help="msgpack path for the final soup")
    @click.option("--seed_msgpack", default=None,
                  help="Seed the greedy soup from this params msgpack (e.g. a "
                  "previously shipped soup) instead of the best swept candidate. "
                  "Only valid when the candidates descend from the seed (same "
                  "basin), e.g. a low-LR fine-tune warm-started from it.")
    def command(architecture, ckpt_dir, sweep_log, top_k, metric, min_step, data_dir, out,
                seed_msgpack):
        """Greedy checkpoint soup of one training run."""
        soup(architecture, ckpt_dir, sweep_log, top_k, metric, min_step, data_dir, out,
             seed_msgpack)

    return command


def main(args=None, standalone_mode: bool = True):
    return make_command().main(args=args, standalone_mode=standalone_mode)


if __name__ == "__main__":
    main()
