"""Convolution and BatchNorm with the JAX package's numerics.

:class:`Conv2dSame` is the counterpart of ``vbt_tpu.models.quant.QuantConv``:
a 2-D convolution with XLA's SAME padding, NCHW activations and an OIHW
weight. XLA's SAME padding is asymmetric for stride 2 (``pad_lo = total //
2``, the extra pixel on the high side), which a symmetric
``Conv2d(padding=...)`` cannot express, so those cases pad explicitly with
``F.pad``. A dense conv (``groups == 1``) also runs the quant modes of
:mod:`vbt_tpu_torch.models.quant`; its float ("off") path is the plain
convolution, unchanged.

:class:`BatchNorm` in train mode takes the fused kernels of
:mod:`vbt_tpu_torch.ops.batchnorm_act` for a float32 tensor on the card
with no ``reduce_stats``, the activation after it included, and their plain
version in torch ops otherwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vbt_tpu_torch.models import quant as q
from vbt_tpu_torch.ops import batchnorm_act as bn_ops
from vbt_tpu_torch.ops.batchnorm_act import (
    BN_EPS,
    KERNEL_ACTS,
    batchnorm_act,
    batchnorm_act_plain,
)
from vbt_tpu_torch.utils.profiling import launch_counter

#: automl's ``act_type`` names: ReLU6 (the lite family), swish (x * sigmoid(x)).
ACTIVATIONS = {"relu6": F.relu6, "swish": F.silu}


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


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                stride: int = 1, groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` with XLA SAME padding on NCHW ``x`` and an OIHW weight."""
    kernel = weight.shape[-1]
    if stride == 1 and kernel % 2 == 1:
        # Symmetric SAME: let the conv pad (saves a copy of x).
        return F.conv2d(x, weight, bias, 1, kernel // 2, 1, groups)
    return F.conv2d(pad_same(x, kernel, stride), weight, bias, stride, 0, 1, groups)


class Conv2dSame(nn.Module):
    """Conv with XLA SAME padding; ``groups == in_ch`` gives a depthwise conv.

    Parameters: ``weight`` (out, in // groups, k, k) and optional ``bias``.
    They are filled from a checkpoint (``runtime.checkpoint``) or, to train
    from scratch, by ``models.efficientdet.init_parameters``. A dense conv has the buffer
    ``act_scale`` (``None`` until calibrated or loaded) and a ``quant``
    mode: ``"calibrate"`` records the running max of ``|x|`` on the float
    path, ``"int8"`` quantizes ``x`` with it and runs the int8 product on
    the weights :func:`quant.freeze_int8` made.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = False):
        super().__init__()
        self.kernel, self.stride, self.groups = kernel, stride, groups
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        self.quant = q.OFF
        if groups == 1:
            self.register_buffer("act_scale", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant == q.INT8:
            return self._int8(x)
        if self.quant == q.CALIBRATE:
            m = x.detach().abs().amax().float()
            self.act_scale = m if self.act_scale is None else torch.maximum(self.act_scale, m)
        return conv2d_same(x, self.weight, self.bias, self.stride, self.groups)

    def _int8(self, x: torch.Tensor) -> torch.Tensor:
        if self.act_scale is None or getattr(self, "w_int8", None) is None:
            raise ValueError("int8 mode requires a calibrated act_scale and frozen int8 "
                             "weights (quant.set_mode(model, 'int8'))")
        s_in = q.input_scale(self.act_scale)
        x_q = pad_same(q.quantize(x, s_in), self.kernel, self.stride)
        acc = q.int8_conv(x_q, self.w_int8, self.stride)
        out = q.dequantize(acc, s_in, self.w_scale, x.dtype)
        return out if self.bias is None else out + self.bias.view(1, -1, 1, 1)


class BatchNorm(nn.Module):
    """BatchNorm on NCHW with flax's semantics, eps 1e-3, momentum 0.99,
    and the activation ``act`` after it (a function, None for none).

    In eval mode it normalizes with the running statistics. In train mode
    it normalizes with the batch's: mean and variance over N, H, W in
    float32 (float64 for float64 inputs), the variance flax's fast one (``mean(x^2) - mean(x)^2``,
    clamped at 0) and biased; and it updates the running statistics in
    place, ``r <- 0.99 r + 0.01 batch``, the variance biased too.
    ``F.batch_norm(training=True)`` is not that: it stores the unbiased
    variance and reads its momentum the other way round.

    Train mode takes the fused kernels (``ops/batchnorm_act.py``, the
    activation inside them) for a float32 tensor on the card with no
    ``reduce_stats`` and an activation of their ``KERNEL_ACTS``; float64,
    bfloat16, the CPU, ``reduce_stats`` and another activation run the
    plain version. This is the one place that decides.
    ``BatchNorm.train_calls`` counts the train-mode calls on the card
    (``"card"``) and those of them that took the kernels (``"fused"``),
    registered as launch counters, so that a CUDA graph's replay adds the
    calls it holds.

    ``reduce_stats``, unset but in the data-parallel train step
    (``parallel.data_parallel``), takes the float activations of this
    share and returns the global batch's (mean, var) in their place.
    """

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.empty(channels))
        self.register_buffer("running_var", torch.empty(channels))
        self.reduce_stats = None

    def forward(self, x: torch.Tensor, act=None) -> torch.Tensor:
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                             self.bias, training=False, eps=BN_EPS)
            return y if act is None else act(y)
        args = (x, self.weight, self.bias, self.running_mean, self.running_var)
        if self._takes_kernels(x, act):
            return batchnorm_act(*args, act)
        return batchnorm_act_plain(*args, act, self.reduce_stats)

    def _takes_kernels(self, x: torch.Tensor, act) -> bool:
        """Whether a train-mode call on ``x`` with ``act`` takes the kernels;
        counted in :attr:`train_calls` where ``x`` is on the card."""
        if x.device.type != bn_ops.KERNEL_DEVICE:
            return False
        fused = self.reduce_stats is None and x.dtype == torch.float32 and act in KERNEL_ACTS
        BatchNorm.train_calls["card"] += 1
        BatchNorm.train_calls["fused"] += fused
        return fused


launch_counter(BatchNorm, "train_calls", ("card", "fused"))
