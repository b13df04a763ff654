"""Tracking-dataframe schema and filename grammar.

Copy of ``vbt_tpu.contract.schema``'s export side, with pandas imported
inside the functions that build dataframes:

- columns and dtypes (``id`` int64, everything else float64);
- rows sorted by ``(id, time)`` with the per-frame insertion index kept;
- the filename ``{video}_id{N}_{model}.pkl.gz``, where ``N`` is the track
  id with the largest cumulative Euclidean travel.
"""

from __future__ import annotations

import os

import numpy as np

#: Column order of the per-video tracking dataframe.
TRACK_COLUMNS = (
    "id",
    "time",
    "x",
    "y",
    "dx",
    "dy",
    "norm_plate_height",
    "norm_plate_width",
)

TRACK_DTYPES = {
    "id": np.int64,
    "time": np.float64,
    "x": np.float64,
    "y": np.float64,
    "dx": np.float64,
    "dy": np.float64,
    "norm_plate_height": np.float64,
    "norm_plate_width": np.float64,
}


def build_df_filename(video_path: str, tracking_id: int, model_path: str) -> str:
    """``{video}_id{N}_{model}.pkl.gz`` from the basenames of the video and
    model paths, each cut at its first ``.``."""
    video = os.path.basename(video_path).split(".")[0]
    model = os.path.basename(model_path).split(".")[0]
    return f"{video}_id{int(tracking_id)}_{model}.pkl.gz"


def build_track_df(data: dict[str, list]):
    """The per-video dataframe from the columnar capture dict: rows in frame
    order, then sorted by ``(id, time)`` keeping the insertion index."""
    import pandas as pd

    df = pd.DataFrame.from_dict(data)
    df = df.sort_values(by=["id", "time"])
    return df.astype({k: v for k, v in TRACK_DTYPES.items() if k in df.columns})


def max_travel_id(df) -> int:
    """Track id with the maximum cumulative Euclidean travel distance; ties
    resolve to the first maximal row, as ``idxmax`` does."""
    d = df.copy()
    same_id = d["id"] == d["id"].shift()
    step = np.sqrt((d["x"] - d["x"].shift()) ** 2 + (d["y"] - d["y"].shift()) ** 2)
    d["distance"] = np.where(same_id, step, np.nan)
    d["cumulative_distance"] = d.groupby("id")["distance"].cumsum()
    return int(d.loc[d["cumulative_distance"].idxmax(), "id"])
