"""The engine of the ground-truth validation CLIs (``vbt-torch-kinovea``,
``vbt-torch-qualisys``).

Port of ``vbt_tpu.cli._groundtruth``. The two CLIs differ only by a
:class:`GroundTruthConfig`: the export parser (Kinovea txt in cm, Qualisys
tsv in mm with x negated), the plate-size smoothing (an expanding mean, or a
rolling mean of 30), rolling-5 x/y smoothing or none, whether rows are
sorted by time, and the overlay's labels and axis balancing.

Per clip: pixel -> meter scaling by the plate size (x * d / width, y
negated), a mean shift onto the ground truth, both trajectories resampled
linearly at 30 Hz on their overlap, then Pearson r and the MSE of each
axis, and a LaTeX table of all clips. The pandas operations run in the JAX
package's order, so the metrics are its own to floating-point noise; the
MSE is ``np.mean((a - b) ** 2)``, what ``sklearn.metrics.mean_squared_error``
returns, without sklearn.

The overlay figure (matplotlib and seaborn) is built only when ``show_fig``
or ``fig_dir`` asks for it; the JAX package builds it for every clip, but
no number comes from it. pandas and scipy are imported inside the
functions.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from math import ceil
from typing import Callable

import numpy as np

from vbt_tpu_torch.contract.schema import parse_df_filename


@dataclass(frozen=True)
class GroundTruthConfig:
    name: str  # legend label of the ground-truth curve
    own_label: str  # legend label of our trajectory
    export_glob: str  # filename pattern inside the export dir
    read_export: Callable  # path -> (time, x, y) dataframe in meters
    plate_smoothing: str  # 'expanding' | 'rolling30'
    smooth_xy: bool  # rolling-5 on x/y before scaling
    sort_by_time: bool  # the Kinovea flow sorts; the Qualisys one does not
    equalize_axes: str  # 'kinovea' | 'qualisys' axis-span balancing variant


@dataclass
class ClipResult:
    video: str
    mse_x: float
    mse_y: float
    r_x: float
    p_x: float
    r_y: float
    p_y: float


def scale_to_meters(df, plate_diameter: float, cfg: GroundTruthConfig):
    """Normalized image coordinates -> meters via the plate size."""
    out = df.drop(columns=["dx", "dy"])

    if cfg.sort_by_time:
        out = out.sort_values(by="time")

    if cfg.plate_smoothing == "expanding":
        for col in ["norm_plate_height", "norm_plate_width"]:
            out[col] = out[col].expanding(min_periods=1).mean()
    else:  # rolling30
        for col in ["norm_plate_width", "norm_plate_height"]:
            out[col] = out[col].rolling(window=30, center=False, min_periods=1).mean()

    if cfg.smooth_xy:
        for col in ["x", "y"]:
            out[col] = out[col].rolling(window=5, center=False, min_periods=1).mean()

    out["x"] = out["x"] * plate_diameter / out["norm_plate_width"]
    # y grows downward in image coordinates: negate.
    out["y"] = -out["y"] * plate_diameter / out["norm_plate_height"]
    return out.drop(columns=["norm_plate_width", "norm_plate_height"])


def align_mean_shift(ours, truth):
    """Shift our trajectory so the per-axis means coincide."""
    ours = ours.copy()
    ours["y"] += truth["y"].mean() - ours["y"].mean()
    ours["x"] += truth["x"].mean() - ours["x"].mean()
    return ours


def correlate(ours, truth) -> tuple[float, float, float, float, float, float]:
    """Resample both trajectories at 30 Hz on their overlap and compare.

    Returns (r_x, p_x, r_y, p_y, mse_x, mse_y). A constant axis gives r =
    NaN, as ``scipy.stats.pearsonr`` does."""
    from scipy.interpolate import interp1d
    from scipy.stats import pearsonr

    t_max = min(truth["time"].max(), ours["time"].max())
    t_min = max(truth["time"].min(), ours["time"].min())
    ts = np.linspace(t_min, t_max, int(t_max * 30))  # 30 fps

    def resample(df, col):
        return interp1d(df["time"], df[col], kind="linear")(ts)

    x_t, x_o = resample(truth, "x"), resample(ours, "x")
    y_t, y_o = resample(truth, "y"), resample(ours, "y")

    rx = pearsonr(x_t, x_o)
    ry = pearsonr(y_t, y_o)
    return (
        float(rx.statistic),
        float(rx.pvalue),
        float(ry.statistic),
        float(ry.pvalue),
        float(np.mean((x_t - x_o) ** 2)),
        float(np.mean((y_t - y_o) ** 2)),
    )


def overlay_figure(truth, ours, cfg: GroundTruthConfig):
    """Two-panel X/Y overlay of the ground truth and our trajectory."""
    import matplotlib.pyplot as plt
    import seaborn as sns

    fig, axs = plt.subplots(2, sharex=True, figsize=(8, 4))
    for ax, col in zip(axs, ["x", "y"]):
        sns.lineplot(ax=ax, x="time", y=col, data=truth, label=cfg.name)
        sns.lineplot(ax=ax, x="time", y=col, data=ours, label=cfg.own_label)

    x_max = ceil(axs[1].get_xlim()[1])
    plt.xticks(range(0, x_max, 5), range(0, x_max, 5), minor=False)
    plt.xticks(range(0, x_max, 1), [], minor=True)
    plt.xlim(0, max(truth["time"].max(), ours["time"].max()))
    plt.xlabel("Čas [s]")

    x_span = axs[0].get_ylim()[1] - axs[0].get_ylim()[0]
    y_span = axs[1].get_ylim()[1] - axs[1].get_ylim()[0]
    if cfg.equalize_axes == "kinovea":
        # Widen only the X panel when it is narrower.
        if abs(x_span) < abs(y_span):
            lo, hi = axs[0].get_ylim()
            axs[0].set_ylim(lo - y_span / 2, hi + y_span / 2)
    else:
        # Widen whichever panel is narrower.
        if x_span > y_span:
            lo, hi = axs[1].get_ylim()
            axs[1].set_ylim(lo - x_span / 2, hi + x_span / 2)
        else:
            lo, hi = axs[0].get_ylim()
            axs[0].set_ylim(lo - y_span / 2, hi + y_span / 2)

    axs[0].set_ylabel("X [m]")
    axs[1].set_ylabel("Y [m]")

    handles, labels = axs[0].get_legend_handles_labels()
    fig.legend(handles, labels, loc="upper right", ncols=2, framealpha=1.0)
    axs[0].legend().set_visible(False)
    axs[1].legend().set_visible(False)
    plt.tight_layout()
    return fig


def latex_summary(results: list[ClipResult]) -> str:
    """The LaTeX summary table of all clips, sorted by video."""
    import pandas as pd

    df = pd.DataFrame(
        {
            "video": [r.video for r in results],
            "mse_x": [r.mse_x for r in results],
            "mse_y": [r.mse_y for r in results],
            "result_x": [r.r_x for r in results],
            "result_y": [r.r_y for r in results],
        }
    ).sort_values(by="video")

    df["video"] = df["video"].map(lambda v: f"\\texttt{{{v.replace('_', chr(92) + '_')}}}")
    for col in ["mse_x", "mse_y", "result_x", "result_y"]:
        df[col] = df[col].map("${:.4f}$".format)

    df = df.rename(
        columns={
            "video": "Video",
            "mse_x": "$\\text{MSE}_x$",
            "mse_y": "$\\text{MSE}_y$",
            "result_x": "$r_x$",
            "result_y": "$r_y$",
        }
    )
    return df.to_latex(index=False)


def run_validation(export_dir: str, df_dir: str, show_fig: bool, fig_dir: str | None,
                   plate_diameter: float, cfg: GroundTruthConfig) -> list[ClipResult]:
    """Every export of ``export_dir`` against the tracking dataframe of
    ``df_dir`` whose name starts with the export's stem; an export without
    one is reported and skipped, as is a dataframe whose name does not
    parse. ``fig_dir`` gets one overlay PDF a clip."""
    import pandas as pd

    figures = show_fig or fig_dir is not None
    if figures:
        import matplotlib.pyplot as plt
        import seaborn as sns

        sns.set_theme(context="paper", style="ticks")
        sns.set_palette("rocket", 2)

    export_files = glob.glob(os.path.join(export_dir, cfg.export_glob))
    df_files = glob.glob(os.path.join(df_dir, "*.pkl.gz"))
    if fig_dir is not None:
        os.makedirs(fig_dir, exist_ok=True)

    results: list[ClipResult] = []
    for export_file in export_files:
        stem = os.path.basename(export_file).split(".")[0]
        match = next((p for p in df_files if os.path.basename(p).startswith(stem)), None)
        if match is None:
            print(f"No matching df file found for: {export_file}")
            continue
        parsed = parse_df_filename(match)
        if parsed is None:
            continue

        truth = cfg.read_export(export_file)
        ours = pd.read_pickle(match)
        ours = ours.query(f"id == {parsed.tracking_id}").drop(columns=["id"])
        ours = scale_to_meters(ours, plate_diameter, cfg)
        ours = align_mean_shift(ours, truth)

        r_x, p_x, r_y, p_y, mse_x, mse_y = correlate(ours, truth)
        results.append(ClipResult(video=parsed.video, mse_x=mse_x, mse_y=mse_y,
                                  r_x=r_x, p_x=p_x, r_y=r_y, p_y=p_y))
        if figures:
            fig = overlay_figure(truth, ours, cfg)
            if show_fig:
                plt.show()
            if fig_dir is not None:
                fig.savefig(os.path.join(
                    fig_dir, f"{parsed.video}_id{parsed.tracking_id}_{parsed.model}.pdf"))
            plt.close(fig)

    return results
