"""The forward's FLOPs a frame of EfficientDet-D7x, analytic: 2 x MACs of
every convolution of the stem, the B7 backbone (its squeeze-excite's two
1x1 convolutions on 1x1 maps included), the BiFPN over levels 3..8 (ten
nodes a cell: top-down P7..P3, bottom-up P4..P8) and the heads, walking
the reference's copy of the spec (``reference/effdet_d7x/model.py``).
Swish, the sigmoid gate and the sum fusion count 0, as every elementwise
op does in ``counts/flops.py``.
"""

from __future__ import annotations

import math

from benchmark.reference.effdet_d7x.model import (ANCHORS_PER_CELL, D_SPECS, blocks,
                                                  round_filters, tap_channels)


def _conv(hw: int, cin: int, cout: int, k: int = 1, groups: int = 1) -> int:
    return 2 * hw * hw * cout * (cin // groups) * k * k


def forward_flops(name: str) -> int:
    """One frame's forward FLOPs of the D spec ``name`` at its input size."""
    spec = D_SPECS[name]
    hw = math.ceil(spec.input_size / 2)
    total = _conv(hw, 3, round_filters(32, spec.width), 3)
    taps, bl = {}, blocks(spec)
    for i, b in enumerate(bl):
        mid = b["cin"] * b["expand"]
        if b["expand"] != 1:
            total += _conv(hw, b["cin"], mid)
        hw = math.ceil(hw / b["stride"])
        total += _conv(hw, mid, mid, b["kernel"], mid) + _conv(hw, mid, b["cout"])
        total += _conv(1, mid, b["se"]) + _conv(1, b["se"], mid)
        if i + 1 == len(bl) or bl[i + 1]["group"] != b["group"]:
            taps[b["group"]] = hw
    lv_hw = {3: taps[2], 4: taps[4], 5: taps[6]}
    for lv in range(6, spec.max_level + 1):
        lv_hw[lv] = math.ceil(lv_hw[lv - 1] / 2)
    ch = spec.fpn_channels
    c = tap_channels(spec)
    total += sum(_conv(lv_hw[lv], c[lv], ch) for lv in (3, 4, 5) if c[lv] != ch)
    total += _conv(lv_hw[5], c[5], ch) if c[5] != ch else 0  # the P6 source

    def sep(hw_l: int, cout: int) -> int:
        return _conv(hw_l, ch, ch, 3, ch) + _conv(hw_l, ch, cout)

    nodes = spec.levels[:-1] + spec.levels[1:]  # top-down, then bottom-up
    total += spec.fpn_repeats * sum(sep(lv_hw[lv], ch) for lv in nodes)
    for per_anchor in (4, spec.num_classes):
        for lv in spec.levels:
            total += spec.head_repeats * sep(lv_hw[lv], ch)
            total += sep(lv_hw[lv], per_anchor * ANCHORS_PER_CELL)
    return total
