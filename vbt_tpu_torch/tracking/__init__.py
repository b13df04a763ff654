"""Multi-object tracking: the host SORT and OC-SORT (numpy copies of
``vbt_tpu.tracking``'s host lane) and the batched scan tracker
(:mod:`vbt_tpu_torch.tracking.scan`, kernel K3 on the card), which runs
either algorithm (``ScanTrackerConfig.sort`` / ``.ocsort``)."""

from vbt_tpu_torch.tracking.ocsort import OCSort
from vbt_tpu_torch.tracking.sort import SortTracker

__all__ = ["OCSort", "SortTracker"]
