"""Convolution and BatchNorm with the JAX package's numerics.

:class:`Conv2dSame` is the float ("off" quant mode) counterpart of
``vbt_tpu.models.quant.QuantConv``: a 2-D convolution with XLA's SAME
padding, NCHW activations and an OIHW weight. XLA's SAME padding is
asymmetric for stride 2 (``pad_lo = total // 2``, the extra pixel on the
high side), which a symmetric ``Conv2d(padding=...)`` cannot express, so
those cases pad explicitly with ``F.pad``. int8 is a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3  # EfficientNet/flax BatchNorm epsilon used throughout


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA SAME padding (lo, hi) along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """Pad an NCHW tensor so a VALID window op gives XLA SAME output."""
    top, bottom = same_pads(x.shape[2], kernel, stride)
    left, right = same_pads(x.shape[3], kernel, stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


class Conv2dSame(nn.Module):
    """Conv with XLA SAME padding; ``groups == in_ch`` gives a depthwise conv.

    Parameters: ``weight`` (out, in // groups, k, k) and optional ``bias``.
    They are filled from a checkpoint (``runtime.checkpoint``), never
    randomly initialised on the serving path.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = False):
        super().__init__()
        self.kernel, self.stride, self.groups = kernel, stride, groups
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1 and self.kernel % 2 == 1:
            # Symmetric SAME: let the conv pad (saves a copy of x).
            return F.conv2d(x, self.weight, self.bias, 1, self.kernel // 2, 1, self.groups)
        x = pad_same(x, self.kernel, self.stride)
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, 1, self.groups)


class BatchNorm(nn.Module):
    """Inference BatchNorm on NCHW with running statistics, eps 1e-3."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.empty(channels))
        self.register_buffer("running_var", torch.empty(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, training=False, eps=BN_EPS)
