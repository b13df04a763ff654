"""The port's golden-dataframe diff (``contract.golden.compare_track_dfs``)
against the JAX package's, on the CPU.

A tracking dataframe made from a seed and its perturbations (a changed id,
a moved value within and beyond the tolerance, a NaN pattern, a row
dropped, a reordered index, renamed and reordered columns): the port's
verdict, problems and ``max_abs_err`` equal JAX's exactly, with and
without the index check and with a relative tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vbt_tpu.contract import golden as jgolden  # noqa: E402
from vbt_tpu_torch.contract import DfComparison, compare_track_dfs  # noqa: E402
from vbt_tpu_torch.contract.schema import TRACK_COLUMNS, build_track_df  # noqa: E402


def _golden():
    rng = np.random.default_rng(7)
    n = 40
    data = {"id": list(rng.integers(1, 4, n)), "time": list(np.arange(1, n + 1) / 30.0)}
    for col in TRACK_COLUMNS[2:]:
        data[col] = list(rng.uniform(0, 1, n))
    return build_track_df(data)


def _perturb(df, kind):
    out = df.copy()
    if kind == "same":
        pass
    elif kind == "id":
        out.iloc[3, out.columns.get_loc("id")] += 1
    elif kind == "within_tol":
        out["x"] += 1e-10
    elif kind == "beyond_tol":
        out.iloc[5, out.columns.get_loc("y")] += 1e-3
    elif kind == "nan_pattern":
        out.iloc[2, out.columns.get_loc("dx")] = np.nan
    elif kind == "nan_both":
        out.iloc[2, out.columns.get_loc("dx")] = np.nan
        df.iloc[2, df.columns.get_loc("dx")] = np.nan
    elif kind == "rows":
        out = out.iloc[:-1]
    elif kind == "index":
        out.index = out.index[::-1]
    elif kind == "columns_renamed":
        out = out.rename(columns={"dy": "vy"})
    elif kind == "columns_reordered":
        out = out[list(TRACK_COLUMNS[::-1])]
    return df, out


@pytest.mark.parametrize("kind", ["same", "id", "within_tol", "beyond_tol", "nan_pattern",
                                  "nan_both", "rows", "index", "columns_renamed",
                                  "columns_reordered"])
@pytest.mark.parametrize("kw", [{}, {"check_index": False}, {"atol": 0.0, "rtol": 1e-2}])
def test_compare_track_dfs_equals_jax(kind, kw):
    golden, candidate = _perturb(_golden(), kind)
    got = compare_track_dfs(golden, candidate, **kw)
    want = jgolden.compare_track_dfs(golden, candidate, **kw)
    assert isinstance(got, DfComparison)
    for field in ("equal", "row_count_golden", "row_count_candidate", "max_abs_err",
                  "problems"):
        assert getattr(got, field) == getattr(want, field), (field, got, want)
    assert got.equal == (kind in ("same", "within_tol", "nan_both")
                         or (kind == "index" and kw.get("check_index") is False)
                         or (kind == "beyond_tol" and "rtol" in kw))
    assert str(got) == str(want)


def test_golden_with_unexpected_columns():
    golden = _golden().assign(extra=0.0)  # reported, and the columns still compared
    got = compare_track_dfs(golden, golden.copy())
    want = jgolden.compare_track_dfs(golden, golden.copy())
    assert (got.equal, got.problems) == (want.equal, want.problems)
    assert got.problems[0].startswith("golden columns unexpected")
