"""Compare tracking dataframes against Kinovea manual-trajectory exports.

Port of ``vbt_tpu.cli.kinovea`` with the same flags, defaults and output
lines: ``Total MSEx = ..., MSEy = ...``, then the LaTeX table of the
clips' Pearson r and MSE, and with ``--fig_dir`` one overlay PDF a clip.
click is imported inside :func:`make_command`.

Usage: ``python -m vbt_tpu_torch.cli.kinovea --kinovea_dir exports/ --df_dir dfs/``
"""

from __future__ import annotations

from vbt_tpu_torch.cli._groundtruth import GroundTruthConfig, latex_summary, run_validation
from vbt_tpu_torch.contract.parsers import read_kinovea_export

CONFIG = GroundTruthConfig(
    name="Kinovea",
    own_label="Velocity Tracker",
    export_glob="*.txt",
    read_export=read_kinovea_export,
    plate_smoothing="expanding",
    smooth_xy=True,
    sort_by_time=True,
    equalize_axes="kinovea",
)


def run(kinovea_dir, df_dir, show_fig, fig_dir, plate_diameter):
    """The body of the CLI, callable without click; returns the clips' results."""
    results = run_validation(kinovea_dir, df_dir, show_fig, fig_dir, plate_diameter, CONFIG)
    total_mse_x = sum(r.mse_x for r in results)
    total_mse_y = sum(r.mse_y for r in results)
    print(f"Total MSEx = {total_mse_x}, MSEy = {total_mse_y}")
    print(latex_summary(results))
    return results


def make_command():
    """Build the click command (click is imported here, not at import)."""
    import click

    @click.command()
    @click.option("--kinovea_dir", default="kinovea_exports", show_default=True,
                  help="Directory containing the kinovea exports.")
    @click.option("--df_dir", default="dfs", show_default=True,
                  help="Directory containing the dfs.")
    @click.option("--show_fig", is_flag=True, help="Show the figure.", show_default=True)
    @click.option("--fig_dir", default=None, show_default=True,
                  help="Directory for saving the figures. If not set the figures won't be saved.")
    @click.option("--plate_diameter", default=0.45, type=float, show_default=True,
                  help="Diameter of the weight plate used in meters.")
    def command(kinovea_dir, df_dir, show_fig, fig_dir, plate_diameter):
        """Plot comparisons between kinovea exports and the created dfs."""
        run(kinovea_dir, df_dir, show_fig, fig_dir, plate_diameter)

    return command


def main(args=None, standalone_mode: bool = True):
    """Console entry point (``vbt-torch-kinovea``)."""
    return make_command().main(args=args, standalone_mode=standalone_mode)


if __name__ == "__main__":
    main()
