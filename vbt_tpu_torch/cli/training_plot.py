"""Plot validation-loss curves for all trained models.

Port of ``vbt_tpu.cli.training_plot``: greps ``val_loss: <float>`` lines
from ``models/*.log`` (``vbt-torch-train`` writes them) and renders one
seaborn line per model into ``figs/training_plot.pdf``. click, pandas,
matplotlib and seaborn are imported inside the functions that use them.

Usage: ``python -m vbt_tpu_torch.cli.training_plot --log_dir models --fig_dir figs``
"""

from __future__ import annotations

import glob
import os
import re
from collections import defaultdict

VAL_LOSS_RE = re.compile(r"val_loss: (\d+\.\d+)")


def parse_logs(log_dir: str) -> dict[str, list[float]]:
    losses: dict[str, list[float]] = defaultdict(list)
    for file in glob.glob(os.path.join(log_dir, "*.log")):
        with open(file) as f:
            for line in f:
                match = VAL_LOSS_RE.findall(line)
                if match:
                    losses[os.path.basename(file).split(".")[0]].append(float(match[0]))
    return losses


def run(log_dir: str, fig_dir: str) -> None:
    """Render ``fig_dir/training_plot.pdf``, one line per model of diverse
    lengths (long format, built model by model)."""
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns

    sns.set_theme(context="paper", style="ticks")
    losses = parse_logs(log_dir)
    if not losses:
        print(f"No val_loss lines found in {log_dir}/*.log; nothing to plot.")
        return
    df = pd.concat(
        [pd.DataFrame({"epoch": range(1, len(vals) + 1), "Model": name, "loss": vals})
         for name, vals in sorted(losses.items())],
        ignore_index=True)
    _, ax = plt.subplots(figsize=(7, 4))
    sns.lineplot(ax=ax, data=df, x="epoch", y="loss", hue="Model")
    ax.set(xlabel="Epoch", ylabel="Validation loss")
    plt.tight_layout()
    os.makedirs(fig_dir, exist_ok=True)
    plt.savefig(os.path.join(fig_dir, "training_plot.pdf"))
    plt.close()


def make_command():
    """Build the click command (click is imported here, not at import)."""
    import click

    @click.command()
    @click.option("--log_dir", default="models", show_default=True)
    @click.option("--fig_dir", default="figs", show_default=True)
    def command(log_dir, fig_dir):
        """Render figs/training_plot.pdf from models/*.log val_loss curves."""
        run(log_dir, fig_dir)

    return command


def main(args=None, standalone_mode: bool = True):
    """Console entry point (``vbt-torch-training-plot``)."""
    return make_command().main(args=args, standalone_mode=standalone_mode)


if __name__ == "__main__":
    main()
