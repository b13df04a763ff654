"""The tracking dataframe contract (schema, filename grammar, its check),
the ground-truth parsers and the golden-dataframe diff."""

from vbt_tpu_torch.contract.golden import DfComparison, compare_track_dfs
from vbt_tpu_torch.contract.schema import TRACK_COLUMNS, validate_track_df

__all__ = ["DfComparison", "TRACK_COLUMNS", "compare_track_dfs", "validate_track_df"]
