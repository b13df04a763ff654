"""BiFPN neck (torch, NCHW).

Port of ``vbt_tpu.models.bifpn`` with plain-sum fusion (the lite default):
each node sums its inputs, applies ReLU6, a depthwise-separable conv and
BN. Upsampling is the JAX package's nearest index map; downsampling is a
3x3/2 max pool with XLA SAME padding of ``-inf`` (5 -> 3 at P6 -> P7 pads
(1, 1); other sizes pad on the high side only). ``fastattn`` fusion is a
later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vbt_tpu_torch.models.conv import BatchNorm, Conv2dSame, pad_same

MIN_LEVEL = 3
MAX_LEVEL = 7
LEVELS = tuple(range(MIN_LEVEL, MAX_LEVEL + 1))


def _upsample2x(x: torch.Tensor, target_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest upsample to ``target_hw`` by the index map
    ``rows = arange(th) * h // th`` (the JAX package's rounding)."""
    h, w = x.shape[2:]
    th, tw = target_hw
    rows = torch.arange(th, device=x.device) * h // th
    cols = torch.arange(tw, device=x.device) * w // tw
    return x.index_select(2, rows).index_select(3, cols)


def _downsample2x(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max pool, XLA SAME padding with -inf."""
    return F.max_pool2d(pad_same(x, 3, 2, value=float("-inf")), 3, 2)


class SepConvBN(nn.Module):
    """Depthwise 3x3 + pointwise 1x1 (with bias) + BN, no activation."""

    def __init__(self, in_ch: int, channels: int):
        super().__init__()
        self.depthwise = Conv2dSame(in_ch, in_ch, 3, groups=in_ch)
        self.pointwise = Conv2dSame(in_ch, channels, 1, bias=True)
        self.bn = BatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.pointwise(self.depthwise(x)))


class ChannelResample(nn.Module):
    """1x1 conv (with bias) + BN to the pyramid width when channels differ;
    identity otherwise (``Conv_0`` keeps the flax auto-name)."""

    def __init__(self, in_ch: int, channels: int):
        super().__init__()
        self.active = in_ch != channels
        if self.active:
            self.Conv_0 = Conv2dSame(in_ch, channels, 1, bias=True)
            self.bn = BatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.Conv_0(x)) if self.active else x


class FuseNode(nn.Module):
    """Sum fusion of same-shape inputs, ReLU6, then ``SepConvBN``."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = SepConvBN(channels, channels)

    def forward(self, inputs: list[torch.Tensor]) -> torch.Tensor:
        x = inputs[0]
        for t in inputs[1:]:
            x = x + t
        return self.conv(F.relu6(x))


class BiFPNCell(nn.Module):
    """One top-down + bottom-up pass over levels 3..7."""

    def __init__(self, channels: int):
        super().__init__()
        for lv in LEVELS[:-1]:
            self.add_module(f"td_p{lv}", FuseNode(channels))
        for lv in LEVELS[1:]:
            self.add_module(f"bu_p{lv}", FuseNode(channels))

    def forward(self, feats: dict[int, torch.Tensor]) -> dict[int, torch.Tensor]:
        td = {MAX_LEVEL: feats[MAX_LEVEL]}
        for lv in reversed(LEVELS[:-1]):
            up = _upsample2x(td[lv + 1], feats[lv].shape[2:])
            td[lv] = getattr(self, f"td_p{lv}")([feats[lv], up])
        out = {MIN_LEVEL: td[MIN_LEVEL]}
        for lv in LEVELS[1:]:
            down = _downsample2x(out[lv - 1])
            inputs = [feats[lv], down] if lv == MAX_LEVEL else [feats[lv], td[lv], down]
            out[lv] = getattr(self, f"bu_p{lv}")(inputs)
        return out


class BiFPN(nn.Module):
    """Lateral resampling of C3..C5, P6/P7 synthesis from C5, ``repeats``
    cells."""

    def __init__(self, tap_channels: dict[int, int], channels: int, repeats: int):
        super().__init__()
        for lv in (3, 4, 5):
            self.add_module(f"lateral_p{lv}", ChannelResample(tap_channels[lv], channels))
        self.lateral_p6 = ChannelResample(tap_channels[5], channels)
        self.repeats = repeats
        for r in range(repeats):
            self.add_module(f"cell{r}", BiFPNCell(channels))

    def forward(self, backbone_feats: dict[int, torch.Tensor]) -> dict[int, torch.Tensor]:
        feats = {lv: getattr(self, f"lateral_p{lv}")(backbone_feats[lv]) for lv in (3, 4, 5)}
        feats[6] = _downsample2x(self.lateral_p6(backbone_feats[5]))
        feats[7] = _downsample2x(feats[6])
        for r in range(self.repeats):
            feats = getattr(self, f"cell{r}")(feats)
        return feats
