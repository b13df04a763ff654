"""Diff a tracking dataframe against a golden one.

Copy of ``vbt_tpu.contract.golden``: a freshly produced tracking dataframe
against a committed one (the reference's de-facto regression suite is its
per-video dataframes), column by column. It only calls the dataframes'
methods, so pandas is not imported here.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from vbt_tpu_torch.contract.schema import TRACK_COLUMNS


@dataclass
class DfComparison:
    """Result of comparing a candidate tracking dataframe to a golden one."""

    equal: bool
    row_count_golden: int
    row_count_candidate: int
    max_abs_err: dict[str, float] = field(default_factory=dict)
    problems: list[str] = field(default_factory=list)

    def __str__(self) -> str:
        status = "EQUAL" if self.equal else "DIFFERS"
        lines = [
            f"{status}: golden={self.row_count_golden} rows, "
            f"candidate={self.row_count_candidate} rows"
        ]
        for col, err in self.max_abs_err.items():
            lines.append(f"  max|err| {col}: {err:.3e}")
        lines.extend(f"  ! {p}" for p in self.problems)
        return "\n".join(lines)


def compare_track_dfs(golden, candidate, atol: float = 1e-9, rtol: float = 0.0,
                      check_index: bool = True) -> DfComparison:
    """Compare two tracking dataframes column by column.

    ``id`` must match exactly; float columns match within ``atol``/``rtol``
    with their NaNs in the same places. When ``check_index`` is set, the
    preserved insertion index (part of the pickle contract, see schema.py)
    must match too.
    """
    cmp = DfComparison(equal=True, row_count_golden=len(golden),
                       row_count_candidate=len(candidate))

    if tuple(golden.columns) != TRACK_COLUMNS:
        cmp.problems.append(f"golden columns unexpected: {tuple(golden.columns)}")
    if tuple(candidate.columns) != tuple(golden.columns):
        cmp.problems.append(
            f"column mismatch: {tuple(candidate.columns)} != {tuple(golden.columns)}")
        cmp.equal = False
        return cmp

    if len(golden) != len(candidate):
        cmp.problems.append("row count mismatch")
        cmp.equal = False
        return cmp

    if check_index and not golden.index.equals(candidate.index):
        cmp.problems.append("insertion index mismatch")
        cmp.equal = False

    if not np.array_equal(golden["id"].to_numpy(), candidate["id"].to_numpy()):
        cmp.problems.append("id column mismatch")
        cmp.equal = False

    for col in TRACK_COLUMNS[1:]:
        g = golden[col].to_numpy(dtype=np.float64)
        c = candidate[col].to_numpy(dtype=np.float64)
        err = np.abs(g - c)
        if not np.array_equal(np.isnan(g), np.isnan(c)):
            cmp.problems.append(f"NaN pattern mismatch in {col}")
            cmp.equal = False
            continue
        finite = ~np.isnan(g)
        max_err = float(err[finite].max()) if finite.any() else 0.0
        cmp.max_abs_err[col] = max_err
        tol = atol + rtol * np.abs(g[finite])
        if not np.all(err[finite] <= tol):
            cmp.problems.append(f"{col} exceeds tolerance (max abs err {max_err:.3e})")
            cmp.equal = False

    return cmp
