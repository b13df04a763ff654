"""Regenerate the evaluation figure tree: combined and per-model PR/ROC PDFs.

Port of the JAX package's ``tools/gen_eval_figs.py`` with the same option,
constants, figures and printed line, drawn by the port's
:func:`vbt_tpu_torch.cli.eval.plot_precision_recall` and
:func:`~vbt_tpu_torch.cli.eval.plot_roc`:

- our models' detections, from ``dfs/eval_detections.pkl.gz`` (written by
  ``vbt-torch-eval ... --replace_df``);
- the reference project's variants, read from its committed cache and
  prefixed ``ref_``.

Both caches are paths relative to the working directory, the repository
root: JAX's tool names the reference cache by its fixed absolute location,
the port by ``reference/`` under the root (where a copy of the reference
project's ``dfs/`` is placed), so it reads nothing outside its checkout.

Per-model PDFs follow the reference's listing: PR only at IoU 0.75, ROC at
0.5 and 0.75, each at :data:`SCORE_THRESHOLDS`. Where the reference cache
is absent, one line says so and our curves are drawn alone (the JAX tool
stops there). A host tool: pandas, seaborn and matplotlib are imported
inside the functions.

Usage: ``python -m vbt_tpu_torch.tools.gen_eval_figs [--fig_dir figs]``
"""

from __future__ import annotations

import os

from vbt_tpu_torch.tools._reference import DFS_DIR

OUR_CACHE = "dfs/eval_detections.pkl.gz"
REF_CACHE = os.path.join(DFS_DIR, "eval_detections.pkl.gz")
SCORE_THRESHOLDS = [0.2, 0.5]


def merged_detections():
    """Our cached detections, then the reference's with ``ref_`` model
    names when its cache is present, in one frame with a fresh index."""
    import pandas as pd

    frames = [pd.read_pickle(OUR_CACHE)]
    if os.path.exists(REF_CACHE):
        ref = pd.read_pickle(REF_CACHE)
        frames.append(ref.assign(Model="ref_" + ref["Model"]))
    else:
        print(f"{REF_CACHE}: absent, drawing {OUR_CACHE} alone")
    return pd.concat(frames, ignore_index=True)


def run(fig_dir: str) -> None:
    """Write the figure tree into ``fig_dir``."""
    import seaborn as sns

    from vbt_tpu_torch.cli.eval import plot_precision_recall, plot_roc

    sns.set_theme(context="paper", style="ticks")
    os.makedirs(fig_dir, exist_ok=True)
    df = merged_detections()
    for iou in (0.5, 0.75):
        d = df.copy()
        d["Label"] = d["IoU"] > iou
        # Per-model PR PDFs exist only at 0.75 in the reference's tree.
        plot_precision_recall(d.copy(), fig_dir, iou, SCORE_THRESHOLDS if iou == 0.75 else [])
        plot_roc(d.copy(), fig_dir, iou, SCORE_THRESHOLDS)
    n = len([f for f in os.listdir(fig_dir) if f.endswith(".pdf")])
    print(f"{fig_dir}: {n} PDFs")


def make_command():
    """Build the click command (click is imported here, not at import)."""
    import click

    @click.command()
    @click.option("--fig_dir", default="figs", show_default=True)
    def command(fig_dir):
        run(fig_dir)

    return command


def main(args=None, standalone_mode: bool = True):
    return make_command().main(args=args, standalone_mode=standalone_mode)


if __name__ == "__main__":
    main()
