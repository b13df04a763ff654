"""Host multi-object tracking: OC-SORT (numpy copy of ``vbt_tpu.tracking``'s
host lane). The batched scan tracker is a later slice."""

from vbt_tpu_torch.tracking.ocsort import OCSort

__all__ = ["OCSort"]
