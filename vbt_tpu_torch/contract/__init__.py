"""The tracking dataframe contract (schema, filename grammar), the
ground-truth parsers and the golden-dataframe diff."""

from vbt_tpu_torch.contract.golden import DfComparison, compare_track_dfs

__all__ = ["DfComparison", "compare_track_dfs"]
