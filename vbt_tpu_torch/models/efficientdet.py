"""EfficientDet detector assembly and the model-spec registry.

Port of ``vbt_tpu.models.efficientdet``. The forward pass takes NCHW images
and returns flattened ``(deltas (B, N, 4), logits (B, N, C))`` in the JAX
package's order: level-major, then row-major over the NHWC map, then the
per-cell anchor fastest — the order of :func:`anchors.generate_anchors`. The
NCHW head maps are permuted to NHWC before that reshape.

``model.train()`` is ``EfficientDet.__call__(train=True, frozen=...)``: the
subtrees named in ``frozen`` (heads-only training freezes ``("backbone",
"fpn")``) stay in eval mode, normalizing with their running statistics,
which do not move, and take no gradient. :func:`init_parameters` fills a
model from a ``torch.Generator`` with flax's initializers.

Two families share the assembly. The lite specs (``efficientdet_lite0..2``)
take an EfficientNet-lite backbone, ReLU6 and plain-sum fusion. The D
specs (``efficientdet_d3``, ``efficientdet_d7x``, google/automl
``efficientdet/hparams_config.py``) take a B-series backbone with
squeeze-excite and swish throughout; D3 fuses by fast normalized fusion,
D7x by plain sums over a pyramid one level taller, P3..P8 (``act``,
``fusion`` and ``max_level`` of :class:`ModelSpec`; the backbone's family
follows its name). automl's drop-connect (stochastic depth) in the
backbone is not trained, as the lite training leaves it out.

The forward records the host-clock spans ``model.backbone`` and
``model.fpn`` (:func:`~vbt_tpu_torch.utils.profiling.span`; a replayed CUDA
graph records neither).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from vbt_tpu_torch.models.anchors import ANCHORS_PER_CELL, AnchorConfig
from vbt_tpu_torch.models.bifpn import MAX_LEVEL, MIN_LEVEL, BiFPN, FastFuseNode
from vbt_tpu_torch.models.conv import ACTIVATIONS, BatchNorm, Conv2dSame
from vbt_tpu_torch.models.efficientnet_lite import EfficientNetLite, tap_channels
from vbt_tpu_torch.models.heads import PredictionHead
from vbt_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class ModelSpec:
    name: str
    backbone: str
    input_size: int
    fpn_channels: int
    fpn_repeats: int
    head_repeats: int
    anchor_scale: float = 3.0
    num_classes: int = 1  # one class: 'barbell'
    act: str = "relu6"  # the BiFPN's and the heads' (automl act_type)
    fusion: str = "sum"  # the BiFPN's (automl fpn_weight_method)
    max_level: int = MAX_LEVEL  # the pyramid's top level (automl max_level)

    @property
    def levels(self) -> tuple[int, ...]:
        return tuple(range(MIN_LEVEL, self.max_level + 1))

    @property
    def anchor_config(self) -> AnchorConfig:
        return AnchorConfig(input_size=self.input_size, anchor_scale=self.anchor_scale,
                            max_level=self.max_level)


MODEL_SPECS = {
    "efficientdet_lite0": ModelSpec("efficientdet_lite0", "lite0", 320, 64, 3, 3),
    "efficientdet_lite1": ModelSpec("efficientdet_lite1", "lite1", 384, 88, 4, 3),
    "efficientdet_lite2": ModelSpec("efficientdet_lite2", "lite2", 448, 112, 5, 3),
    "efficientdet_d3": ModelSpec("efficientdet_d3", "b3", 896, 160, 6, 4, anchor_scale=4.0,
                                 act="swish", fusion="fastattn"),
    "efficientdet_d7x": ModelSpec("efficientdet_d7x", "b7", 1536, 384, 8, 5, anchor_scale=4.0,
                                  act="swish", fusion="sum", max_level=8),
}
# The "whole" variants share the architecture with their base (only the
# fine-tuning regime differed), so model names round-trip through the CLIs.
for _base in list(MODEL_SPECS.values()):
    MODEL_SPECS[f"{_base.name}_whole"] = _base


def get_model_spec(name: str) -> ModelSpec:
    key = name if name in MODEL_SPECS else f"efficientdet_{name}"
    if key not in MODEL_SPECS:
        raise KeyError(f"unknown model spec '{name}'; have {sorted(MODEL_SPECS)}")
    return MODEL_SPECS[key]


def _flatten(maps: dict[int, torch.Tensor], per_anchor: int) -> torch.Tensor:
    """Per-level NCHW maps -> (B, sum(H*W*A), per_anchor), NHWC order."""
    parts = []
    for lv in sorted(maps):
        m = maps[lv].permute(0, 2, 3, 1)
        b, h, w, _ = m.shape
        parts.append(m.reshape(b, h * w * ANCHORS_PER_CELL, per_anchor))
    return torch.cat(parts, dim=1)


class EfficientDet(nn.Module):
    """Backbone + BiFPN + heads; sub-module names follow the flax tree
    ('backbone', 'fpn', 'box_net', 'class_net')."""

    def __init__(self, spec: ModelSpec, frozen: tuple[str, ...] = ()):
        super().__init__()
        self.spec = spec
        self.frozen = tuple(frozen)
        act = ACTIVATIONS[spec.act]
        self.backbone = EfficientNetLite(spec.backbone)
        self.fpn = BiFPN(tap_channels(spec.backbone), spec.fpn_channels, spec.fpn_repeats,
                         act, spec.fusion, spec.levels)
        self.box_net = PredictionHead(4, ANCHORS_PER_CELL, spec.fpn_channels,
                                      spec.head_repeats, act, spec.levels)
        self.class_net = PredictionHead(spec.num_classes, ANCHORS_PER_CELL,
                                        spec.fpn_channels, spec.head_repeats, act, spec.levels)
        for name in self.frozen:
            getattr(self, name).requires_grad_(False)

    def train(self, mode: bool = True) -> "EfficientDet":
        super().train(mode)
        for name in self.frozen:
            getattr(self, name).eval()
        return self

    def forward(self, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``images`` (B, 3, S, S) normalized -> (deltas, logits)."""
        with span("model.backbone"):
            feats = self.backbone(images)
        return self.neck_and_heads(feats)

    def neck_and_heads(self, feats: dict[int, torch.Tensor]):
        """BiFPN + heads on precomputed backbone taps {3, 4, 5}."""
        with span("model.fpn"):
            feats = self.fpn(feats)
        return (_flatten(self.box_net(feats), 4),
                _flatten(self.class_net(feats), self.spec.num_classes))


CLASS_PRIOR = 0.01  # the focal-loss prior of the class head's final bias
# flax's truncated normal has stddev 1 before this correction (its
# variance_scaling divides by the stddev of a unit normal cut at +-2).
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_parameters(model: EfficientDet, generator: torch.Generator) -> EfficientDet:
    """Fill ``model`` in place with flax's initializers, drawn from
    ``generator`` (a CPU generator; the model may live anywhere): every
    convolution kernel ``lecun_normal`` (a normal cut at two standard
    deviations, ``std = sqrt(1 / fan_in) / 0.8796``, fan_in = k * k *
    in / groups), biases 0, BatchNorm scale 1 and bias 0 with running mean
    0 and variance 1, the fusion weights 1 (automl's), and the class head's
    final bias ``-log((1 - p) / p)`` with p = 0.01. JAX's random stream is
    not reproduced."""
    for module in model.modules():
        if isinstance(module, Conv2dSame):
            w = module.weight
            std = math.sqrt(1.0 / (w.shape[1] * w.shape[2] * w.shape[3])) / _TRUNC_STD
            sample = torch.empty(w.shape, dtype=w.dtype)
            nn.init.trunc_normal_(sample, 0.0, 1.0, -2.0, 2.0, generator=generator)
            w.copy_(sample * std)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, BatchNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
        elif isinstance(module, FastFuseNode):
            module.edge_weight.fill_(1.0)
    model.class_net.final.pointwise.bias.fill_(-math.log((1 - CLASS_PRIOR) / CLASS_PRIOR))
    return model
