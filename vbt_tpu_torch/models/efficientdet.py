"""EfficientDet-Lite detector assembly and the model-spec registry.

Port of ``vbt_tpu.models.efficientdet``. The forward pass takes NCHW images
and returns flattened ``(deltas (B, N, 4), logits (B, N, C))`` in the JAX
package's order: level-major, then row-major over the NHWC map, then the
per-cell anchor fastest — the order of :func:`anchors.generate_anchors`. The
NCHW head maps are permuted to NHWC before that reshape.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from vbt_tpu_torch.models.anchors import ANCHORS_PER_CELL, AnchorConfig
from vbt_tpu_torch.models.bifpn import BiFPN
from vbt_tpu_torch.models.efficientnet_lite import EfficientNetLite, tap_channels
from vbt_tpu_torch.models.heads import PredictionHead


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

    @property
    def anchor_config(self) -> AnchorConfig:
        return AnchorConfig(input_size=self.input_size, anchor_scale=self.anchor_scale)


MODEL_SPECS = {
    "efficientdet_lite0": ModelSpec("efficientdet_lite0", "lite0", 320, 64, 3, 3),
    "efficientdet_lite1": ModelSpec("efficientdet_lite1", "lite1", 384, 88, 4, 3),
    "efficientdet_lite2": ModelSpec("efficientdet_lite2", "lite2", 448, 112, 5, 3),
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

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        self.backbone = EfficientNetLite(spec.backbone)
        self.fpn = BiFPN(tap_channels(spec.backbone), spec.fpn_channels, spec.fpn_repeats)
        self.box_net = PredictionHead(4, ANCHORS_PER_CELL, spec.fpn_channels,
                                      spec.head_repeats)
        self.class_net = PredictionHead(spec.num_classes, ANCHORS_PER_CELL,
                                        spec.fpn_channels, spec.head_repeats)

    def forward(self, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``images`` (B, 3, S, S) normalized -> (deltas, logits)."""
        return self.neck_and_heads(self.backbone(images))

    def neck_and_heads(self, feats: dict[int, torch.Tensor]):
        """BiFPN + heads on precomputed backbone taps {3, 4, 5}."""
        feats = self.fpn(feats)
        return (_flatten(self.box_net(feats), 4),
                _flatten(self.class_net(feats), self.spec.num_classes))
