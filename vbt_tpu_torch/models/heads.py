"""Box / class prediction heads (torch, NCHW).

Port of ``vbt_tpu.models.heads``: ``repeats`` separable convs whose weights
are shared across pyramid levels, each followed by a BatchNorm of its own
per level (``bn{i}_p{lv}``) and ReLU6, then a shared final separable conv
projecting to ``num_anchors * out_per_anchor`` channels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vbt_tpu_torch.models.bifpn import LEVELS
from vbt_tpu_torch.models.conv import BatchNorm, Conv2dSame


class _SharedSepConv(nn.Module):
    """Depthwise 3x3 + pointwise 1x1 with bias (no BN inside)."""

    def __init__(self, in_ch: int, channels: int):
        super().__init__()
        self.depthwise = Conv2dSame(in_ch, in_ch, 3, groups=in_ch)
        self.pointwise = Conv2dSame(in_ch, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class PredictionHead(nn.Module):
    """Head applied to every pyramid level; returns per-level NCHW maps."""

    def __init__(self, out_per_anchor: int, num_anchors: int, channels: int, repeats: int):
        super().__init__()
        self.repeats = repeats
        for i in range(repeats):
            self.add_module(f"conv{i}", _SharedSepConv(channels, channels))
            for lv in LEVELS:
                self.add_module(f"bn{i}_p{lv}", BatchNorm(channels))
        self.final = _SharedSepConv(channels, out_per_anchor * num_anchors)

    def forward(self, feats: dict[int, torch.Tensor]) -> dict[int, torch.Tensor]:
        outputs = {}
        for lv in sorted(feats):
            x = feats[lv]
            for i in range(self.repeats):
                x = getattr(self, f"conv{i}")(x)
                x = F.relu6(getattr(self, f"bn{i}_p{lv}")(x))
            outputs[lv] = self.final(x)
        return outputs
