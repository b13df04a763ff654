"""Multi-object tracking: the host OC-SORT (numpy copy of
``vbt_tpu.tracking``'s host lane) and the batched scan tracker
(:mod:`vbt_tpu_torch.tracking.scan`, kernel K3 on the card)."""

from vbt_tpu_torch.tracking.ocsort import OCSort

__all__ = ["OCSort"]
