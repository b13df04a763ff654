"""The forward's FLOPs a frame, analytic, from the model's spec: 2 x MACs
of every convolution of the stem, backbone, BiFPN and heads.

A frozen copy of ``vbt_tpu_torch/tools/roofline.py::analytic_flops`` (the
count ``torch.utils.flop_counter.FlopCounterMode`` makes of the forward),
walking the reference's copy of the spec, so every EfficientDet-Lite size
is counted: 1.719 GFLOP a frame for lite0 at 320, 5.956 for lite2 at 448.
Elementwise work counts 0.

A train step counts ``TRAIN_FACTOR`` forwards (forward and backward, the
backward's two products a convolution), the usual convention.
"""

from __future__ import annotations

import math

from benchmark.reference.model.anchors import ANCHORS_PER_CELL
from benchmark.reference.model.efficientdet import get_model_spec
from benchmark.reference.model.efficientnet_lite import (STEM_CHANNELS, TAPS, scaled_blocks,
                                                         tap_channels)

TRAIN_FACTOR = 3


def _conv_flops(hw_in, cin, cout, k, stride, batch, groups=1):
    hw_out = math.ceil(hw_in / stride)
    return 2 * batch * hw_out * hw_out * cout * (cin // groups) * k * k, hw_out


def analytic_flops(batch: int = 1, size: int | None = None, name: str = "efficientdet_lite0"):
    """Per-stage FLOPs of the model ``name`` at ``size`` (its input size by
    default): preprocess, backbone, bifpn, heads, postprocess."""
    spec = get_model_spec(name)
    size = size or spec.input_size
    b = batch
    backbone, hw = _conv_flops(size, 3, STEM_CHANNELS, 3, 2, b)
    cin = STEM_CHANNELS
    lv_hw = {}
    for gi, g in enumerate(scaled_blocks(spec.backbone)):
        for ri in range(g.repeats):
            stride = g.stride if ri == 0 else 1
            mid = cin * g.expand
            if g.expand != 1:
                backbone += _conv_flops(hw, cin, mid, 1, 1, b)[0]
            x, hw = _conv_flops(hw, mid, mid, g.kernel, stride, b, groups=mid)
            backbone += x + _conv_flops(hw, mid, g.out_ch, 1, 1, b)[0]
            cin = g.out_ch
        if gi in TAPS:
            lv_hw[TAPS[gi]] = hw
    lv_hw[6] = math.ceil(lv_hw[5] / 2)
    lv_hw[7] = math.ceil(lv_hw[6] / 2)
    ch = spec.fpn_channels

    def sep_conv(hw_l, cout):
        return (_conv_flops(hw_l, ch, ch, 3, 1, b, groups=ch)[0]
                + _conv_flops(hw_l, ch, cout, 1, 1, b)[0])

    c_taps = tap_channels(spec.backbone)
    fpn = sum(_conv_flops(lv_hw[lv], c_taps[lv], ch, 1, 1, b)[0]
              for lv in (3, 4, 5) if c_taps[lv] != ch)
    if c_taps[5] != ch:
        fpn += _conv_flops(lv_hw[5], c_taps[5], ch, 1, 1, b)[0]  # lateral_p6
    cell = sum(sep_conv(lv_hw[lv], ch) for lv in (6, 5, 4, 3, 4, 5, 6, 7))
    fpn += spec.fpn_repeats * cell
    heads = 0
    for out_per_anchor in (4, spec.num_classes):
        for lv in range(3, 8):
            heads += spec.head_repeats * sep_conv(lv_hw[lv], ch)
            heads += sep_conv(lv_hw[lv], out_per_anchor * ANCHORS_PER_CELL)
    return {"preprocess": 0, "backbone": backbone, "bifpn": fpn, "heads": heads,
            "postprocess": 0}


def forward_flops(name: str, size: int | None = None) -> int:
    """One frame's forward FLOPs."""
    return sum(analytic_flops(1, size, name).values())
