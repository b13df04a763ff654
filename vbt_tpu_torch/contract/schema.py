"""Tracking-dataframe schema and filename grammar.

Copy of ``vbt_tpu.contract.schema``'s export and parse sides, with pandas
imported inside the functions that build dataframes:

- columns and dtypes (``id`` int64, everything else float64);
- rows sorted by ``(id, time)`` with the per-frame insertion index kept;
- the filename ``{video}_id{N}_{model}.pkl.gz``, where ``N`` is the track
  id with the largest cumulative Euclidean travel, and its parser, which
  the plot CLI uses to find the track to analyse;
- :func:`validate_track_df`, the check of a dataframe against that
  contract.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

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


# The video stem, an ``_id`` separator, the integer track id, the model
# name and the ``.pkl.gz`` extension.
_FILENAME_RE = re.compile(r"(?P<video>\S*)_id(?P<tracking_id>\d+)_(?P<model>\S*)\.pkl\.gz")


@dataclass(frozen=True)
class TrackFileName:
    """Parsed fields of an exported dataframe filename."""

    video: str
    tracking_id: int
    model: str

    def render(self) -> str:
        return f"{self.video}_id{self.tracking_id}_{self.model}.pkl.gz"


def parse_df_filename(path: str) -> TrackFileName | None:
    """Parse ``{video}_id{N}_{model}.pkl.gz``; None when it does not match."""
    m = _FILENAME_RE.match(os.path.basename(path))
    if m is None:
        return None
    return TrackFileName(video=m.group("video"), tracking_id=int(m.group("tracking_id")),
                         model=m.group("model"))


def build_df_filename(video_path: str, tracking_id: int, model_path: str) -> str:
    """``{video}_id{N}_{model}.pkl.gz`` from the basenames of the video and
    model paths, each cut at its first ``.``."""
    video = os.path.basename(video_path).split(".")[0]
    model = os.path.basename(model_path).split(".")[0]
    return TrackFileName(video=video, tracking_id=int(tracking_id), model=model).render()


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


def validate_track_df(df) -> list[str]:
    """The dataframe's contract violations, in JAX's order and words: the
    column order (alone, if it is wrong), each column's dtype, then the
    ``(id, time)`` sort. Empty when conformant."""
    problems: list[str] = []
    cols = tuple(df.columns)
    if cols != TRACK_COLUMNS:
        problems.append(f"columns {cols!r} != {TRACK_COLUMNS!r}")
        return problems
    for col, want in TRACK_DTYPES.items():
        got = df[col].dtype
        if got != want:
            problems.append(f"dtype[{col}] {got} != {np.dtype(want)}")
    key = df[["id", "time"]].reset_index(drop=True)
    if not key.equals(key.sort_values(by=["id", "time"]).reset_index(drop=True)):
        problems.append("rows not sorted by (id, time)")
    return problems
