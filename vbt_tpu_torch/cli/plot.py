"""Plot bar position/velocity and per-rep ROM / ACV metrics from a dataframe.

Port of ``vbt_tpu.cli.plot`` with the same arguments, defaults, smoothing,
analysis, figure layout and output naming. The phase segmentation runs on
the exact host lane (``--engine host``, numpy float64, the default) or,
with ``--engine torch``, as the two-pass torch program of
:mod:`vbt_tpu_torch.analysis.velocity_torch` on the card (``device="cpu"``
for the CPU). ``--engine jax``, the JAX CLI's name for its device lane, is
an alias of ``torch``, so ``vbt-plot``'s command lines run unchanged.
pandas, matplotlib and seaborn are imported only inside
:func:`render_figure` and :func:`plot_one`, click inside
:func:`make_command`.

Usage: ``python -m vbt_tpu_torch.cli.plot --fig_dir figs/ dfs/*.pkl.gz``
"""

from __future__ import annotations

import os
from math import ceil, floor

import numpy as np

from vbt_tpu_torch.analysis.phase import CONCENTRIC, ECCENTRIC, Phase
from vbt_tpu_torch.analysis.velocity import analyze_df
from vbt_tpu_torch.contract.schema import parse_df_filename

ENGINES = ("host", "jax", "torch")
SERIES_COLS = ["time", "x", "y", "dx", "dy", "norm_plate_height", "norm_plate_width"]

# Phase shading colors (plot.py:28-31).
PHASE_COLORS = {CONCENTRIC: "C3", ECCENTRIC: "C1"}

POSITION_COLS = ("x", "y")
VELOCITY_COLS = ("dx", "dy")
PLATE_COLS = ("norm_plate_height", "norm_plate_width")

# The reference maintained a Slovak label variant (figs_sk/) by toggling
# commented lines in plot.py:112-217; here it is a --lang option.
LABELS = {
    "en": dict(
        pos_ylabel="[Normalized image coordinates]",
        pos_title="Bar position over time, ROM for each concentric phase displayed in [m]",
        vel_ylabel=r"[(Normalized image coordinates)$\cdot$s$^{-1}$]",
        vel_title="Bar speed over time, ACV for each concentric phase displayed in [m/s]",
        concentric="Concentric",
        eccentric="Eccentric",
        phase="Phase",
        xlabel="Time [s]",
    ),
    "sk": dict(
        pos_ylabel="[Normalizované súradnice]",
        pos_title="Poloha činky v čase, dĺžka trajektórie pre každú koncentrickú fázu zobrazená v [m]",
        vel_ylabel=r"[(Normalizované súradnice)$\cdot$s$^{-1}]$",
        vel_title="Rýchlosť činky v čase, metrika ACV zobrazená pre každú koncetrickú fázu v [m/s]",
        concentric="Koncentrická",
        eccentric="Excentrická",
        phase="Fáza",
        xlabel="Čas [s]",
    ),
}


def smooth_track_df(df):
    """plot.py:90-95 smoothing: rolling-5 mean on kinematics, expanding mean
    on plate dimensions."""
    out = df.copy()
    for col in (*POSITION_COLS, *VELOCITY_COLS):
        out[col] = out[col].rolling(window=5, center=False, min_periods=1).mean()
    for col in PLATE_COLS:
        out[col] = out[col].expanding(min_periods=1).mean()
    return out


def analyze_phases(df, plate_diameter: float, engine: str, device="cuda") -> list[Phase]:
    """Segment the smoothed dataframe into phases with the chosen engine;
    ``device`` is where the torch engine runs."""
    if engine in ("jax", "torch"):
        from vbt_tpu_torch.analysis.velocity_torch import analyze_series, to_phase_list

        arrays = [df[c].to_numpy(dtype=np.float64) for c in SERIES_COLS]
        # The dataframe is already plot-smoothed; skip the presmoothing.
        return to_phase_list(analyze_series(*arrays, plate_diameter=plate_diameter,
                                            presmooth=False, device=device))
    if engine != "host":
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    return analyze_df(df, plate_diameter)


def render_figure(df, phases: list[Phase], lang: str = "en"):
    """Two stacked panels: position and velocity over time, with phase spans
    and per-rep ROM [m] / ACV [m/s] labels (plot.py:112-217)."""
    import matplotlib.patches as mpatches
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns

    text = LABELS[lang]
    sns.set_theme(style="ticks", context="paper")
    sns.set_palette("rocket")

    df_pos = df.drop(columns=[*VELOCITY_COLS, *PLATE_COLS])
    df_vel = df.drop(columns=[*POSITION_COLS, *PLATE_COLS]).rename(
        columns={"dx": "x", "dy": "y"}
    )

    df_pos = pd.melt(df_pos, id_vars=["time"], var_name="variable", value_name="value")
    df_pos["Position"] = df_pos["variable"].str.extract(r"([xy])")
    df_pos = df_pos[["time", "Position", "value"]]
    df_vel = pd.melt(df_vel, id_vars=["time"], var_name="Velocity", value_name="value")

    fig, (pos_ax, vel_ax) = plt.subplots(2, sharex=True, figsize=(8, 5))
    sns.lineplot(df_pos, x="time", y="value", hue="Position", ax=pos_ax, palette="rocket")
    sns.lineplot(df_vel, x="time", y="value", hue="Velocity", ax=vel_ax, palette="rocket")

    start, end = df["time"].min(), df["time"].max()
    pos_ylim = pos_ax.get_ylim()
    pos_ax.set(
        ylabel=text["pos_ylabel"],
        xlabel=None,
        title=text["pos_title"],
        ylim=[max(pos_ylim[0] - 0.2, 0), min(pos_ylim[1] + 0.2, 1)],
        xlim=[start, end],
    )
    pos_ax.legend(ncol=4, loc="lower left")

    vel_ylim = vel_ax.get_ylim()
    vel_ax.set(
        ylabel=text["vel_ylabel"],
        xlabel=None,
        title=text["vel_title"],
        xlim=[start, end],
    )
    vel_ax.legend(ncol=1, loc="upper left")

    for phase in phases:
        span = dict(
            xmin=phase.time_start,
            xmax=phase.time_end,
            facecolor=PHASE_COLORS[phase.type],
            alpha=0.2,
        )
        pos_ax.axvspan(**span)
        vel_ax.axvspan(**span)

        if phase.type == CONCENTRIC:
            acv = phase.rom / phase.duration  # average concentric velocity [m/s]
            mid = (phase.time_start + phase.time_end) / 2 + 0.02
            pos_ax.text(
                x=mid,
                y=pos_ylim[1] if pos_ax.get_ylim()[1] < 1 else pos_ax.get_ylim()[0] + 0.02,
                s=f"{phase.rom:0.2f}",
                horizontalalignment="center",
                verticalalignment="bottom",
                rotation="vertical",
            )
            vel_ax.text(
                x=mid,
                y=vel_ylim[1] * 0.8,
                s=f"{acv:0.2f}",
                horizontalalignment="center",
                verticalalignment="center",
                rotation="vertical",
            )

    legend_patches = [
        mpatches.Patch(color=PHASE_COLORS[CONCENTRIC], alpha=0.2, label=text["concentric"]),
        mpatches.Patch(color=PHASE_COLORS[ECCENTRIC], alpha=0.2, label=text["eccentric"]),
    ]
    fig.legend(handles=legend_patches, loc="lower right", ncol=2, framealpha=1.0, title=text["phase"])
    plt.xlabel(text["xlabel"])

    x_max = ceil(vel_ax.get_xlim()[1])
    x_min = floor(vel_ax.get_xlim()[0])
    x_min = x_min - x_min % 5
    plt.xticks(range(x_min, x_max, 5), range(x_min, x_max, 5), minor=False)
    plt.xticks(range(x_min, x_max, 1), [], minor=True)
    plt.tight_layout()
    return fig


def plot_one(src: str, show_fig: bool, save_fig: bool, plate_diameter: float,
             fig_dir: str | None, engine: str = "host", lang: str = "en", device="cuda"):
    """One exported dataframe -> its phases, and the figure saved or shown."""
    import matplotlib.pyplot as plt
    import pandas as pd

    parsed = parse_df_filename(src)
    if parsed is None:
        print(f"Couldn't create a plot for file '{src}'.")
        return
    df = pd.read_pickle(src)
    df = df.query(f"id == {parsed.tracking_id}").drop(columns=["id"])
    df = smooth_track_df(df)
    phases = analyze_phases(df, plate_diameter, engine, device)
    render_figure(df, phases, lang=lang)
    if save_fig:
        filename = f"{os.path.basename(src).split('.')[0]}.pdf"
        path = filename if fig_dir is None else os.path.join(fig_dir, filename)
        plt.savefig(path)
    if show_fig:
        plt.show()
    plt.close()
    return phases


def make_command():
    """Build the click command (click is imported here, not at import)."""
    import click

    @click.command()
    @click.argument("src", type=str, nargs=-1)
    @click.option("--show_fig", is_flag=True, help="Show the figure.", show_default=True)
    @click.option("--plate_diameter", default=0.45, type=float, show_default=True,
                  help="Diameter of the weight plate used in meters.")
    @click.option("--fig_dir", default=None, show_default=True,
                  help="Directory for saving the figures. If not set the figures won't be saved.")
    @click.option("--engine", default="host", type=click.Choice(list(ENGINES)),
                  show_default=True,
                  help="Phase segmentation engine: exact host lane or the torch program on "
                       "the card (jax: the same as torch).")
    @click.option("--lang", default="en", type=click.Choice(["en", "sk"]), show_default=True,
                  help="Figure label language (the reference shipped figs_sk/ Slovak variants).")
    def command(src, show_fig, plate_diameter, fig_dir, engine, lang):
        """Visualize the bar position and speeds over time based on the passed in
        dataframe in the pickle format."""
        save_fig = fig_dir is not None
        if fig_dir is not None:
            os.makedirs(fig_dir, exist_ok=True)
        for s in src:
            if not os.path.isfile(s):
                raise FileNotFoundError(s)
            plot_one(s, show_fig, save_fig, plate_diameter, fig_dir, engine, lang)

    return command


def main(args=None, standalone_mode: bool = True):
    """Console entry point (``vbt-torch-plot``)."""
    return make_command().main(args=args, standalone_mode=standalone_mode)


if __name__ == "__main__":
    main()
