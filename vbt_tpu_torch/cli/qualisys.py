"""Compare tracking dataframes against Qualisys motion-capture exports.

Port of ``vbt_tpu.cli.qualisys`` with the same flags (the reference's
``qualysis`` spelling), defaults and output: the LaTeX table of the clips'
Pearson r and MSE, and with ``--fig_dir`` one overlay PDF a clip. Against
the Kinovea flow: a rolling-30 plate-size mean, no x/y smoothing, rows in
file order. click is imported inside :func:`make_command`.

Usage: ``python -m vbt_tpu_torch.cli.qualisys --qualysis_dir exports/ --df_dir dfs/``
"""

from __future__ import annotations

from vbt_tpu_torch.cli._groundtruth import GroundTruthConfig, latex_summary, run_validation
from vbt_tpu_torch.contract.parsers import read_qualisys_export

CONFIG = GroundTruthConfig(
    name="Qualysis",
    own_label="Vlastné",
    export_glob="*.tsv",
    read_export=read_qualisys_export,
    plate_smoothing="rolling30",
    smooth_xy=False,
    sort_by_time=False,
    equalize_axes="qualisys",
)


def run(qualysis_dir, df_dir, show_fig, fig_dir, plate_diameter):
    """The body of the CLI, callable without click; returns the clips' results."""
    results = run_validation(qualysis_dir, df_dir, show_fig, fig_dir, plate_diameter, CONFIG)
    print(latex_summary(results))
    return results


def make_command():
    """Build the click command (click is imported here, not at import)."""
    import click

    @click.command()
    @click.option("--qualysis_dir", default="qualysis_exports", show_default=True,
                  help="Directory containing the qualysis exports.")
    @click.option("--df_dir", default="qualysis_dfs", show_default=True,
                  help="Directory containing the dfs.")
    @click.option("--show_fig", is_flag=True, help="Show the figure.", show_default=True)
    @click.option("--fig_dir", default=None, show_default=True,
                  help="Directory for saving the figures. If not set the figures won't be saved.")
    @click.option("--plate_diameter", default=0.45, type=float, show_default=True,
                  help="Diameter of the weight plate used in meters.")
    def command(qualysis_dir, df_dir, show_fig, fig_dir, plate_diameter):
        """Plot comparisons between qualysis exports and the created dfs."""
        run(qualysis_dir, df_dir, show_fig, fig_dir, plate_diameter)

    return command


def main(args=None, standalone_mode: bool = True):
    """Console entry point (``vbt-torch-qualisys``)."""
    return make_command().main(args=args, standalone_mode=standalone_mode)


if __name__ == "__main__":
    main()
