"""Regenerate the README images of ``docs/``: ``plot.png``,
``precision_recall_iou_0.75.png`` and ``roc_iou_0.75.png``.

Port of the JAX package's ``tools/gen_docs_pngs.py`` with the same option,
figures and printed line:

- ``plot.png``: the plot CLI's two-panel figure of :data:`PLOT_DF`, the
  reference project's golden dataframe of its first squat clip, through the
  port's ``parse_df_filename``, ``smooth_track_df``,
  ``analyze_phases(engine="host")`` and ``render_figure``, at 300 dpi;
- the two curves: PNG renders of the combined figures at IoU 0.75 that
  :mod:`.gen_eval_figs` writes as PDFs, without the per-model figures.

:data:`PLOT_DF` is relative to the working directory, the repository root,
as :data:`.gen_eval_figs.REF_CACHE` is. An absent input is skipped with a
printed line: :data:`PLOT_DF` skips
``plot.png``, the reference cache leaves our curves alone
(:func:`.gen_eval_figs.merged_detections`). A host tool: pandas, seaborn
and matplotlib are imported inside :func:`run`.

Usage: ``python -m vbt_tpu_torch.tools.gen_docs_pngs [--docs_dir docs]``
"""

from __future__ import annotations

import os

from vbt_tpu_torch.tools._reference import DFS_DIR

PLOT_DF = os.path.join(DFS_DIR, "001_squat_6reps_id1_efficientdet_lite0_whole.pkl.gz")


def run(docs_dir: str) -> None:
    """Write the images into ``docs_dir``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns

    from vbt_tpu_torch.cli.eval import plot_precision_recall, plot_roc
    from vbt_tpu_torch.cli.plot import (
        analyze_phases,
        parse_df_filename,
        render_figure,
        smooth_track_df,
    )
    from vbt_tpu_torch.tools.gen_eval_figs import merged_detections

    sns.set_theme(context="paper", style="ticks")
    os.makedirs(docs_dir, exist_ok=True)

    if os.path.exists(PLOT_DF):
        parsed = parse_df_filename(PLOT_DF)
        df = pd.read_pickle(PLOT_DF)
        df = df.query(f"id == {parsed.tracking_id}").drop(columns=["id"])
        df = smooth_track_df(df)
        phases = analyze_phases(df, plate_diameter=0.45, engine="host")
        render_figure(df, phases)
        plt.savefig(os.path.join(docs_dir, "plot.png"), dpi=300)
        plt.close()
    else:
        print(f"{PLOT_DF}: absent, no plot.png")

    d = merged_detections()
    d["Label"] = d["IoU"] > 0.75
    # No score thresholds: the combined figures only (the per-model
    # operating points live in the PDF tree).
    plot_precision_recall(d.copy(), docs_dir, 0.75, [], fmt="png")
    plot_roc(d.copy(), docs_dir, 0.75, [], fmt="png")
    print(f"{docs_dir}: {sorted(os.listdir(docs_dir))}")


def make_command():
    """Build the click command (click is imported here, not at import)."""
    import click

    @click.command()
    @click.option("--docs_dir", default="docs", show_default=True)
    def command(docs_dir):
        run(docs_dir)

    return command


def main(args=None, standalone_mode: bool = True):
    return make_command().main(args=args, standalone_mode=standalone_mode)


if __name__ == "__main__":
    main()
