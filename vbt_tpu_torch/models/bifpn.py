"""BiFPN neck (torch, NCHW).

Port of ``vbt_tpu.models.bifpn`` with plain-sum fusion (the lite default):
each node sums its inputs, applies ReLU6, a depthwise-separable conv and
BN. Upsampling is the JAX package's nearest index map; downsampling is a
3x3/2 max pool with XLA SAME padding of ``-inf`` (5 -> 3 at P6 -> P7 pads
(1, 1); other sizes pad on the high side only).

EfficientDet-D0..D5 fuse by automl's ``fastattn`` (:class:`FastFuseNode`):
``sum_i relu(w_i) x_i / (sum_j relu(w_j) + 1e-4)``, one learnable weight an
input (``edge_weight``, initialised to 1), and swish in place of ReLU6;
D6-D7x sum their inputs (automl's ``sum``) under swish. Both are chosen
when the module is built (``act``, ``fusion``); a ``"sum"`` node runs the
forward it always ran.

The pyramid's levels are fixed when the module is built too: P3..P7 by
default, more where a spec asks for them (EfficientDet-D7x: P3..P8), each
level above P6 a further max pool of the one below. A built module loops
over its own levels; levels 3-7 keep their names (``td_p*``, ``bu_p*``),
so every five-level checkpoint loads as before.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vbt_tpu_torch.models.conv import BatchNorm, Conv2dSame, pad_same

MIN_LEVEL = 3
MAX_LEVEL = 7
LEVELS = tuple(range(MIN_LEVEL, MAX_LEVEL + 1))
FUSIONS = ("sum", "fastattn")
FUSION_EPS = 1e-4  # automl's epsilon of the fast normalized fusion


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
    """Sum fusion of same-shape inputs, the activation (ReLU6 unless ``act``
    says otherwise), then ``SepConvBN``."""

    def __init__(self, channels: int, act=F.relu6):
        super().__init__()
        self.conv = SepConvBN(channels, channels)
        self.act = act

    def forward(self, inputs: list[torch.Tensor]) -> torch.Tensor:
        x = inputs[0]
        for t in inputs[1:]:
            x = x + t
        return self.conv(self.act(x))


class FastFuseNode(FuseNode):
    """automl's fast normalized fusion of ``n_inputs`` same-shape inputs:
    ``sum_i relu(w_i) x_i / (sum_j relu(w_j) + 1e-4)``, then the activation
    and ``SepConvBN``. The normalized weights are cast to the inputs' dtype
    (they stay float32 in the state under a bf16 step)."""

    def __init__(self, channels: int, n_inputs: int, act):
        super().__init__(channels, act)
        self.edge_weight = nn.Parameter(torch.ones(n_inputs))

    def forward(self, inputs: list[torch.Tensor]) -> torch.Tensor:
        w = F.relu(self.edge_weight)
        w = (w / (w.sum() + FUSION_EPS)).to(inputs[0].dtype)
        x = inputs[0] * w[0]
        for i in range(1, len(inputs)):
            x = x + inputs[i] * w[i]
        return self.conv(self.act(x))


def _node(channels: int, n_inputs: int, act, fusion: str) -> FuseNode:
    return (FuseNode(channels, act) if fusion == "sum"
            else FastFuseNode(channels, n_inputs, act))


class BiFPNCell(nn.Module):
    """One top-down + bottom-up pass over ``levels`` (3..7 by default)."""

    def __init__(self, channels: int, act=F.relu6, fusion: str = "sum",
                 levels: tuple[int, ...] = LEVELS):
        super().__init__()
        self.levels = tuple(levels)
        top = self.levels[-1]
        for lv in self.levels[:-1]:
            self.add_module(f"td_p{lv}", _node(channels, 2, act, fusion))
        for lv in self.levels[1:]:
            self.add_module(f"bu_p{lv}", _node(channels, 2 if lv == top else 3, act, fusion))

    def forward(self, feats: dict[int, torch.Tensor]) -> dict[int, torch.Tensor]:
        bottom, top = self.levels[0], self.levels[-1]
        td = {top: feats[top]}
        for lv in reversed(self.levels[:-1]):
            up = _upsample2x(td[lv + 1], feats[lv].shape[2:])
            td[lv] = getattr(self, f"td_p{lv}")([feats[lv], up])
        out = {bottom: td[bottom]}
        for lv in self.levels[1:]:
            down = _downsample2x(out[lv - 1])
            inputs = [feats[lv], down] if lv == top else [feats[lv], td[lv], down]
            out[lv] = getattr(self, f"bu_p{lv}")(inputs)
        return out


class BiFPN(nn.Module):
    """Lateral resampling of C3..C5, synthesis of P6 and the levels above
    from C5 (a lateral, then one max pool a level), ``repeats`` cells over
    ``levels`` (P3..P7 by default); ``act`` (a function) and ``fusion`` (one
    of :data:`FUSIONS`) choose the nodes."""

    def __init__(self, tap_channels: dict[int, int], channels: int, repeats: int,
                 act=F.relu6, fusion: str = "sum", levels: tuple[int, ...] = LEVELS):
        super().__init__()
        if fusion not in FUSIONS:
            raise ValueError(f"fusion must be one of {FUSIONS}, got {fusion!r}")
        self.levels = tuple(levels)
        for lv in (3, 4, 5):
            self.add_module(f"lateral_p{lv}", ChannelResample(tap_channels[lv], channels))
        self.lateral_p6 = ChannelResample(tap_channels[5], channels)
        self.repeats = repeats
        for r in range(repeats):
            self.add_module(f"cell{r}", BiFPNCell(channels, act, fusion, self.levels))

    def forward(self, backbone_feats: dict[int, torch.Tensor]) -> dict[int, torch.Tensor]:
        feats = {lv: getattr(self, f"lateral_p{lv}")(backbone_feats[lv]) for lv in (3, 4, 5)}
        feats[6] = _downsample2x(self.lateral_p6(backbone_feats[5]))
        for lv in self.levels[4:]:
            feats[lv] = _downsample2x(feats[lv - 1])
        for r in range(self.repeats):
            feats = getattr(self, f"cell{r}")(feats)
        return feats
