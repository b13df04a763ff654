"""EfficientNet-lite backbone (torch, NCHW).

Port of ``vbt_tpu.models.efficientnet_lite``: EfficientNet without
squeeze-excite, ReLU6, fixed stem; returns the stride-8/16/32 taps
{3: C3, 4: C4, 5: C5}. Sub-module names follow the flax parameter tree
(``g{group}_b{repeat}``, ``expand``/``depthwise``/``project`` and their
``*_bn``) so a checkpoint maps onto them mechanically.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from vbt_tpu_torch.models.conv import BatchNorm, Conv2dSame


@dataclass(frozen=True)
class MBConvArgs:
    kernel: int
    stride: int
    expand: int
    out_ch: int
    repeats: int


# EfficientNet-B0 block table; lite variants scale channels/repeats from it.
_B0_BLOCKS: tuple[MBConvArgs, ...] = (
    MBConvArgs(kernel=3, stride=1, expand=1, out_ch=16, repeats=1),
    MBConvArgs(kernel=3, stride=2, expand=6, out_ch=24, repeats=2),
    MBConvArgs(kernel=5, stride=2, expand=6, out_ch=40, repeats=2),
    MBConvArgs(kernel=3, stride=2, expand=6, out_ch=80, repeats=3),
    MBConvArgs(kernel=5, stride=1, expand=6, out_ch=112, repeats=3),
    MBConvArgs(kernel=5, stride=2, expand=6, out_ch=192, repeats=4),
    MBConvArgs(kernel=3, stride=1, expand=6, out_ch=320, repeats=1),
)

#: (width_multiplier, depth_multiplier) per lite variant.
LITE_SCALING = {
    "lite0": (1.0, 1.0),
    "lite1": (1.0, 1.1),
    "lite2": (1.1, 1.2),
    "lite3": (1.2, 1.4),
    "lite4": (1.4, 1.8),
}

STEM_CHANNELS = 32  # fixed in the lite family (not width-scaled)
TAPS = {2: 3, 4: 4, 6: 5}  # block group index -> pyramid level


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    """Standard EfficientNet channel rounding to a multiple of ``divisor``."""
    scaled = filters * width
    new = max(divisor, int(scaled + divisor / 2) // divisor * divisor)
    if new < 0.9 * scaled:  # never drop below 90%
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def scaled_blocks(variant: str) -> list[MBConvArgs]:
    """Block table for a lite variant; the first and last groups keep their
    repeat count (lite family quirk)."""
    width, depth = LITE_SCALING[variant]
    out = []
    last = len(_B0_BLOCKS) - 1
    for i, b in enumerate(_B0_BLOCKS):
        reps = b.repeats if i in (0, last) else round_repeats(b.repeats, depth)
        out.append(MBConvArgs(kernel=b.kernel, stride=b.stride, expand=b.expand,
                              out_ch=round_filters(b.out_ch, width), repeats=reps))
    return out


def tap_channels(variant: str) -> dict[int, int]:
    """Channels of the C3/C4/C5 taps."""
    blocks = scaled_blocks(variant)
    return {lv: blocks[gi].out_ch for gi, lv in TAPS.items()}


class BatchNormAct(nn.Module):
    """BatchNorm + optional ReLU6 (flax ``BatchNormAct``; its inner
    ``BatchNorm_0`` is ``bn`` here)."""

    def __init__(self, channels: int, act: bool = True):
        super().__init__()
        self.bn = BatchNorm(channels)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(x)
        return F.relu6(x) if self.act else x


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck, lite flavour (no SE, ReLU6)."""

    def __init__(self, in_ch: int, args: MBConvArgs, stride: int):
        super().__init__()
        mid = in_ch * args.expand
        self.has_expand = args.expand != 1
        if self.has_expand:
            self.expand = Conv2dSame(in_ch, mid, 1)
            self.expand_bn = BatchNormAct(mid)
        self.depthwise = Conv2dSame(mid, mid, args.kernel, stride, groups=mid)
        self.depthwise_bn = BatchNormAct(mid)
        self.project = Conv2dSame(mid, args.out_ch, 1)
        self.project_bn = BatchNormAct(args.out_ch, act=False)
        self.residual = stride == 1 and in_ch == args.out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x
        if self.has_expand:
            x = self.expand_bn(self.expand(x))
        x = self.depthwise_bn(self.depthwise(x))
        x = self.project_bn(self.project(x))
        return x + inputs if self.residual else x


class EfficientNetLite(nn.Module):
    """Backbone returning the stride-8/16/32 feature taps (C3, C4, C5)."""

    def __init__(self, variant: str = "lite0"):
        super().__init__()
        self.stem = Conv2dSame(3, STEM_CHANNELS, 3, 2)
        self.stem_bn = BatchNormAct(STEM_CHANNELS)
        self.block_names: list[tuple[int, str]] = []
        ch = STEM_CHANNELS
        for gi, group in enumerate(scaled_blocks(variant)):
            for ri in range(group.repeats):
                name = f"g{gi}_b{ri}"
                stride = group.stride if ri == 0 else 1
                self.add_module(name, MBConvBlock(ch, group, stride))
                self.block_names.append((gi, name))
                ch = group.out_ch

    def forward(self, x: torch.Tensor) -> dict[int, torch.Tensor]:
        x = self.stem_bn(self.stem(x))
        features: dict[int, torch.Tensor] = {}
        for i, (gi, name) in enumerate(self.block_names):
            x = getattr(self, name)(x)
            last_of_group = i + 1 == len(self.block_names) or self.block_names[i + 1][0] != gi
            if last_of_group and gi in TAPS:
                features[TAPS[gi]] = x
        return features
