"""Turbo backbone: the EfficientNet-lite forward with fused MBConv blocks.

Port of ``vbt_tpu.models.turbo``. High-resolution MBConv blocks run through
the fused block (:func:`vbt_tpu_torch.ops.fused_mbconv.fused_mbconv`: the
CUDA kernel on the card, its plain version on the CPU), which keeps the
6x-expanded intermediate out of device memory; the small late blocks and
the stem run on plain convolutions. It reads the same weights as
:class:`EfficientNetLite`, so any shipped checkpoint works unchanged.

:class:`TurboBackbone` folds the BatchNorms into the weights once, at
construction, and keeps them on its device; the JAX function refolds them
under ``jit`` on every call, with the same f32 arithmetic. The stem and the
unfused blocks mirror the JAX ``_xla_block``: weights and BN factors cast
to the working dtype, then ``x * f + s``; they do not call
``MBConvBlock.forward`` (``F.batch_norm``), which rounds differently in
bf16. The unfused blocks and the taps are channels-last, the layout cuDNN
gives the module's own forward (an NCHW depthwise conv runs a much slower
kernel on the card). The tensor-core fused kernel takes and gives
channels-last memory too, so on the card a bf16 forward changes layout once,
after the stem; the FMA kernel (float32) and the plain version take
contiguous NCHW, their (B, C, H*W) layout, and that copy is the counterpart
of the JAX conversions at the fused/unfused boundary.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vbt_tpu_torch.models.conv import BatchNorm, conv2d_same
from vbt_tpu_torch.models.efficientnet_lite import TAPS, EfficientNetLite, MBConvBlock
from vbt_tpu_torch.ops.fused_mbconv import FusedBlockParams, fold_bn, fused_mbconv, mma_takes
from vbt_tpu_torch.utils.device import resolve_device

BN_EPS = 1e-3
# Fuse blocks whose INPUT spatial area is at least this many positions;
# below it the expanded intermediate is small (the JAX package's rule).
FUSE_MIN_SPATIAL = 1600  # 40x40


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _bn_factors(conv_weight: torch.Tensor, bn: BatchNorm) -> tuple[np.ndarray, np.ndarray]:
    """(factor, shift) of an inference BatchNorm, f32 numpy, as the JAX fold."""
    return fold_bn(_f32(conv_weight), _f32(bn.weight), _f32(bn.bias),
                   _f32(bn.running_mean), _f32(bn.running_var), BN_EPS)


def fold_block_params(
    block: MBConvBlock, h: int, w: int, kernel: int, stride: int, residual: bool,
    compute_dtype: torch.dtype = torch.bfloat16, device: str | torch.device = "cuda",
) -> FusedBlockParams:
    """BN-fold one MBConv block's f32 weights into kernel-ready tensors on ``device``."""
    device = resolve_device(device)

    def dev(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    we = be = None
    if block.has_expand:
        f, b = _bn_factors(block.expand.weight, block.expand_bn.bn)
        we = dev(_f32(block.expand.weight)[:, :, 0, 0] * f[:, None], compute_dtype)  # (Cmid, Cin)
        be = dev(b[:, None])
    f, b = _bn_factors(block.depthwise.weight, block.depthwise_bn.bn)
    kd = _f32(block.depthwise.weight)[:, 0]  # (Cmid, k, k)
    wd = dev((kd * f[:, None, None]).reshape(kd.shape[0], kernel * kernel))  # (Cmid, k*k)
    bd = dev(b[:, None])
    f, b = _bn_factors(block.project.weight, block.project_bn.bn)
    wp = dev(_f32(block.project.weight)[:, :, 0, 0] * f[:, None], compute_dtype)  # (Cout, Cmid)
    bp = dev(b[:, None])
    return FusedBlockParams(we=we, be=be, wd=wd, bd=bd, wp=wp, bp=bp,
                            h=h, w=w, kernel=kernel, stride=stride, residual=residual)


@dataclass(frozen=True)
class ConvBN:
    """A conv's weight and its BN as ``x * factor + shift``, all in the working dtype."""

    weight: torch.Tensor  # OIHW
    factor: torch.Tensor  # (1, C, 1, 1)
    shift: torch.Tensor  # (1, C, 1, 1)
    stride: int = 1
    groups: int = 1

    @classmethod
    def fold(cls, conv, bn: BatchNorm, dtype, device, stride=1, groups=1) -> "ConvBN":
        f, s = _bn_factors(conv.weight, bn)
        cast = lambda a: torch.from_numpy(a).to(device=device, dtype=dtype)  # noqa: E731
        return cls(cast(_f32(conv.weight)), cast(f).reshape(1, -1, 1, 1),
                   cast(s).reshape(1, -1, 1, 1), stride, groups)

    def __call__(self, x: torch.Tensor, act: bool = True) -> torch.Tensor:
        x = conv2d_same(x, self.weight, None, self.stride, self.groups) * self.factor + self.shift
        return F.relu6(x) if act else x


@dataclass(frozen=True)
class PlainBlock:
    """An unfused MBConv block: the counterpart of the JAX ``_xla_block``."""

    expand: ConvBN | None
    depthwise: ConvBN
    project: ConvBN
    residual: bool

    @classmethod
    def fold(cls, block: MBConvBlock, dtype, device) -> "PlainBlock":
        expand = (ConvBN.fold(block.expand, block.expand_bn.bn, dtype, device)
                  if block.has_expand else None)
        dw = block.depthwise
        depthwise = ConvBN.fold(dw, block.depthwise_bn.bn, dtype, device, dw.stride, dw.groups)
        project = ConvBN.fold(block.project, block.project_bn.bn, dtype, device)
        return cls(expand, depthwise, project, block.residual)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x
        if self.expand is not None:
            x = self.expand(x)
        x = self.project(self.depthwise(x), act=False)
        return x + inputs if self.residual else x


class TurboBackbone(nn.Module):
    """EfficientNet-lite forward with fused high-res blocks, for one image size.

    Built once from an :class:`EfficientNetLite` holding f32 weights; the
    folded weights live on ``device`` in ``dtype`` (f32 biases and depthwise
    weights for the fused blocks, as the kernel takes them). A block fuses
    when its input area is at least ``fuse_min_spatial`` and it has an
    expand conv; ``h, w`` advance after each stride-2 block. Same contract
    as ``EfficientNetLite.forward``: NCHW images in, {3: C3, 4: C4, 5: C5}
    out.
    """

    def __init__(self, backbone: EfficientNetLite, image_hw: tuple[int, int],
                 dtype: torch.dtype = torch.bfloat16, device: str | torch.device = "cuda",
                 fuse_min_spatial: int = FUSE_MIN_SPATIAL):
        super().__init__()
        device = resolve_device(device)
        self.image_hw = tuple(int(s) for s in image_hw)
        self.dtype = dtype
        self.on_card = device.type == "cuda"
        self.stem = ConvBN.fold(backbone.stem, backbone.stem_bn.bn, dtype, device, stride=2)
        h, w = (-(-s // 2) for s in self.image_hw)
        self.steps: list[tuple[int, str, FusedBlockParams | PlainBlock]] = []
        for gi, name in backbone.block_names:
            block = getattr(backbone, name)
            stride = block.depthwise.stride
            if h * w >= fuse_min_spatial and block.has_expand:
                step = fold_block_params(block, h, w, block.depthwise.kernel, stride,
                                         block.residual, compute_dtype=dtype, device=device)
            else:
                step = PlainBlock.fold(block, dtype, device)
            self.steps.append((gi, name, step))
            if stride == 2:
                h, w = -(-h // 2), -(-w // 2)

    @property
    def fused_names(self) -> list[str]:
        return [name for _, name, step in self.steps if isinstance(step, FusedBlockParams)]

    def forward(self, images: torch.Tensor) -> dict[int, torch.Tensor]:
        if tuple(images.shape[2:]) != self.image_hw:
            raise ValueError(f"built for {self.image_hw} images, got {tuple(images.shape[2:])}")
        x = self.stem(images.to(self.dtype))
        features: dict[int, torch.Tensor] = {}
        for i, (gi, _, step) in enumerate(self.steps):
            if isinstance(step, FusedBlockParams):
                ho, wo = step.out_hw
                cmid, cin = step.we.shape
                # The tensor-core kernel reads and writes channels-last memory.
                channels_last = self.on_card and mma_takes(x.dtype, cin, cmid, step.wp.shape[0],
                                                           True)
                x = x.contiguous(memory_format=torch.channels_last if channels_last
                                 else torch.contiguous_format)
                x = fused_mbconv(x, step).reshape(x.shape[0], -1, ho, wo)
            else:
                x = step(x.contiguous(memory_format=torch.channels_last))
            last_of_group = i + 1 == len(self.steps) or self.steps[i + 1][0] != gi
            if last_of_group and gi in TAPS:
                features[TAPS[gi]] = x.contiguous(memory_format=torch.channels_last)
        return features


def turbo_backbone(backbone: EfficientNetLite, images: torch.Tensor,
                   dtype: torch.dtype | None = None,
                   fuse_min_spatial: int = FUSE_MIN_SPATIAL) -> dict[int, torch.Tensor]:
    """One call of the turbo backbone, folding the weights for it (the JAX
    function's form; a server keeps a :class:`TurboBackbone` instead)."""
    dtype = images.dtype if dtype is None else dtype
    turbo = TurboBackbone(backbone, images.shape[2:], dtype, images.device, fuse_min_spatial)
    return turbo(images)


def turbo_forward(model, turbo: TurboBackbone, images: torch.Tensor):
    """Full detector forward with the turbo backbone: the same (deltas,
    logits) as ``model(images)``."""
    return model.neck_and_heads(turbo(images))
