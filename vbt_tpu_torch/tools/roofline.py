"""Per-stage roofline of the serving path (EfficientDet-Lite0 at 320, B = 128).

Port of the JAX package's ``tools/roofline.py`` for the H100. The count of
the work is analytic, read from the model's spec and not from an
implementation, so it is the same for the module convolutions, the turbo
backbone (kernel K2) and the int8 lane:

- :func:`analytic_bytes` is JAX's once-per-conv HBM walk
  (``tools/roofline.py:59-175``), key for key: every convolution reads its
  input and weights and writes its output once, elementwise work is free,
  residual adds read one more operand;
- :func:`analytic_flops` is the same walk counting 2 x MACs of every
  convolution of the stem, backbone, BiFPN and heads (the count
  ``torch.utils.flop_counter.FlopCounterMode`` makes of the port's forward;
  XLA's cost analysis of JAX's forward also counts elementwise work).

:func:`main` measures the full forward and the full detect on the card by
the marginal method (:mod:`._timing`) and prints, per stage, the analytic
bytes and FLOPs, ``t_hbm`` (bytes over the HBM rate), ``t_tc`` (FLOPs over
the dense bf16 tensor-core rate) and the bound, the larger; then the sum of
the forward's stage bounds beside the measured forward, and the card's name
and power limit. JAX's prefix programs and their XLA cost analysis have no
counterpart here. The record goes to ``out/roofline.json`` under the
checkout (``--out``).

Usage: ``python -m vbt_tpu_torch.tools.roofline [--batch 128] [--device cpu]``
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np

from vbt_tpu_torch.bench import CKPT, REPO

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12  # HBM3
TC_BF16_FLOPS = 989e12  # tensor cores, bf16 in, f32 accumulate

BATCH = 128
ACT = 2  # bf16 activation bytes
W = 4  # f32 parameter bytes
STAGES = ("preprocess", "backbone", "bifpn", "heads", "postprocess")
FORWARD_STAGES = STAGES[:4]
OUT = os.path.join(REPO, "out", "roofline.json")


def _conv_bytes(hw_in, cin, cout, k, stride, batch, groups=1):
    """(bytes, hw_out) for one conv: read in + read weights + write out."""
    hw_out = math.ceil(hw_in / stride)
    reads = hw_in * hw_in * cin * ACT * batch
    reads += k * k * (cin // groups) * cout * W
    writes = hw_out * hw_out * cout * ACT * batch
    return reads + writes, hw_out


def _conv_flops(hw_in, cin, cout, k, stride, batch, groups=1):
    """(FLOPs, hw_out) for one conv: 2 x MACs."""
    hw_out = math.ceil(hw_in / stride)
    return 2 * batch * hw_out * hw_out * cout * (cin // groups) * k * k, hw_out


def _level_hw(size):
    """The BiFPN's side per level 3..7 (JAX's rounding)."""
    hw = {3: size // 8, 4: size // 16, 5: size // 32}
    hw[6] = math.ceil(hw[5] / 2)
    hw[7] = math.ceil(hw[6] / 2)
    return hw


def analytic_bytes(batch=BATCH, size=320):
    """Per-stage once-per-conv HBM bytes for efficientdet_lite0 at ``size``
    (JAX's walk, its keys and ``_backbone_groups``/``_n_anchors``).

    Assumes perfect elementwise fusion (BN/ReLU6 free, residual adds read
    one extra operand) but no fusion across convs: the no-inter-conv-fusion
    envelope, not a lower bound."""
    from vbt_tpu_torch.models import get_model_spec
    from vbt_tpu_torch.models.anchors import ANCHORS_PER_CELL
    from vbt_tpu_torch.models.efficientnet_lite import (STEM_CHANNELS, scaled_blocks,
                                                        tap_channels)

    spec = get_model_spec("efficientdet_lite0")
    stages = {}
    # preprocess: read uint8 frames, write bf16 normalized images (the bench
    # feeds frames already at the input size).
    stages["preprocess"] = size * size * 3 * 1 * batch + size * size * 3 * ACT * batch

    total = 0
    b, hw = batch, size
    per_group = {}
    bb, hw = _conv_bytes(hw, 3, STEM_CHANNELS, 3, 2, b)
    per_group["stem"] = bb
    total += bb
    cin = STEM_CHANNELS
    for gi, g in enumerate(scaled_blocks(spec.backbone)):
        gbytes = 0
        for ri in range(g.repeats):
            stride = g.stride if ri == 0 else 1
            mid = cin * g.expand
            if g.expand != 1:
                gbytes += _conv_bytes(hw, cin, mid, 1, 1, b)[0]
            x, hw_mid = _conv_bytes(hw, mid, mid, g.kernel, stride, b, groups=mid)
            gbytes += x
            x, hw_out = _conv_bytes(hw_mid, mid, g.out_ch, 1, 1, b)
            gbytes += x
            if stride == 1 and cin == g.out_ch:
                gbytes += hw_out * hw_out * g.out_ch * ACT * b  # shortcut read
            cin, hw = g.out_ch, hw_out
        per_group[f"g{gi}"] = gbytes
        total += gbytes
    stages["backbone"] = total
    stages["_backbone_groups"] = per_group

    ch, repeats = spec.fpn_channels, spec.fpn_repeats
    lv_hw = _level_hw(size)
    c_taps = tap_channels(spec.backbone)
    fpn = 0
    for lv in (3, 4, 5):  # lateral 1x1 resamples
        fpn += _conv_bytes(lv_hw[lv], c_taps[lv], ch, 1, 1, b)[0]
    fpn += _conv_bytes(lv_hw[5], c_taps[5], ch, 1, 1, b)[0]  # lateral_p6
    # p6/p7 max-pool downsamples: read in + write out
    fpn += (lv_hw[5] ** 2 + lv_hw[6] ** 2) * ch * ACT * b
    fpn += (lv_hw[6] ** 2 + lv_hw[7] ** 2) * ch * ACT * b

    def fuse_node(hw_node, n_inputs):
        # The sum and ReLU6 fuse into the depthwise read; each extra operand
        # is one read. SepConv = depthwise 3x3 + pointwise 1x1.
        extra_reads = (n_inputs - 1) * hw_node * hw_node * ch * ACT * b
        dw, _ = _conv_bytes(hw_node, ch, ch, 3, 1, b, groups=ch)
        pw, _ = _conv_bytes(hw_node, ch, ch, 1, 1, b)
        return extra_reads + dw + pw

    cell = 0
    for lv in (6, 5, 4, 3):  # top-down: upsample read+write, then 2-fuse
        cell += (lv_hw[lv + 1] ** 2 + lv_hw[lv] ** 2) * ch * ACT * b
        cell += fuse_node(lv_hw[lv], 2)
    for lv in (4, 5, 6, 7):  # bottom-up: downsample + 2- or 3-fuse
        cell += (lv_hw[lv - 1] ** 2 + lv_hw[lv] ** 2) * ch * ACT * b
        cell += fuse_node(lv_hw[lv], 2 if lv == 7 else 3)
    fpn += repeats * cell
    stages["bifpn"] = fpn

    heads = 0
    for out_per_anchor in (4, spec.num_classes):  # box, class
        for lv in spec.levels:
            hw_l = lv_hw[lv]
            for _ in range(spec.head_repeats):
                heads += fuse_node(hw_l, 1)
            heads += _conv_bytes(hw_l, ch, ch, 3, 1, b, groups=ch)[0]
            heads += _conv_bytes(hw_l, ch, out_per_anchor * ANCHORS_PER_CELL, 1, 1, b)[0]
    stages["heads"] = heads

    # Postprocess: read the flattened (B, N, 4) + (B, N, 1) maps and the
    # anchors, then the top-512 candidates' working set a few times.
    n_anchors = sum(lv_hw[lv] ** 2 * ANCHORS_PER_CELL for lv in spec.levels)
    stages["postprocess"] = (n_anchors * 5 * ACT * b + n_anchors * 4 * W
                             + b * 512 * 6 * W * 4)
    stages["_n_anchors"] = n_anchors
    return stages


def analytic_flops(batch=BATCH, size=320, name="efficientdet_lite0"):
    """Per-stage FLOPs (2 x MACs of every convolution, squeeze-excite's
    included) of the model ``name`` at ``size``, keyed by :data:`STAGES`;
    preprocess and postprocess have no convolution and count 0, nor do the
    activations and the BiFPN's fusion."""
    from vbt_tpu_torch.models import get_model_spec
    from vbt_tpu_torch.models.anchors import ANCHORS_PER_CELL
    from vbt_tpu_torch.models.efficientnet_lite import (SE_RATIO, TAPS, is_lite, scaled_blocks,
                                                        stem_channels, tap_channels)

    spec = get_model_spec(name)
    b = batch
    stem = stem_channels(spec.backbone)
    backbone, hw = _conv_flops(size, 3, stem, 3, 2, b)
    cin = stem
    lv_hw = {}
    for gi, g in enumerate(scaled_blocks(spec.backbone)):
        for ri in range(g.repeats):
            stride = g.stride if ri == 0 else 1
            mid = cin * g.expand
            if g.expand != 1:
                backbone += _conv_flops(hw, cin, mid, 1, 1, b)[0]
            x, hw = _conv_flops(hw, mid, mid, g.kernel, stride, b, groups=mid)
            backbone += x + _conv_flops(hw, mid, g.out_ch, 1, 1, b)[0]
            if not is_lite(spec.backbone):  # squeeze-excite's two 1x1 convs on 1x1 maps
                se = max(1, int(cin * SE_RATIO))
                backbone += (_conv_flops(1, mid, se, 1, 1, b)[0]
                             + _conv_flops(1, se, mid, 1, 1, b)[0])
            cin = g.out_ch
        if gi in TAPS:
            lv_hw[TAPS[gi]] = hw
    for lv in spec.levels[3:]:  # P6 and above: one stride-2 pool a level
        lv_hw[lv] = math.ceil(lv_hw[lv - 1] / 2)

    ch = spec.fpn_channels

    def sep_conv(hw_l, cout):
        return (_conv_flops(hw_l, ch, ch, 3, 1, b, groups=ch)[0]
                + _conv_flops(hw_l, ch, cout, 1, 1, b)[0])

    c_taps = tap_channels(spec.backbone)
    fpn = sum(_conv_flops(lv_hw[lv], c_taps[lv], ch, 1, 1, b)[0]
              for lv in (3, 4, 5) if c_taps[lv] != ch)
    if c_taps[5] != ch:
        fpn += _conv_flops(lv_hw[5], c_taps[5], ch, 1, 1, b)[0]  # lateral_p6
    # A cell: a fuse node at every level but the top top-down and every
    # level but the bottom bottom-up (3..6 and 4..7 in a five-level pyramid).
    cell = sum(sep_conv(lv_hw[lv], ch) for lv in spec.levels[:-1] + spec.levels[1:])
    fpn += spec.fpn_repeats * cell

    heads = 0
    for out_per_anchor in (4, spec.num_classes):
        for lv in spec.levels:
            heads += spec.head_repeats * sep_conv(lv_hw[lv], ch)
            heads += sep_conv(lv_hw[lv], out_per_anchor * ANCHORS_PER_CELL)
    return {"preprocess": 0, "backbone": backbone, "bifpn": fpn, "heads": heads,
            "postprocess": 0}


def stage_rows(batch=BATCH, size=320) -> list[dict]:
    """A row a stage: analytic bytes and FLOPs, ``t_hbm``, ``t_tc`` and the
    bound (ms) at the card's peaks."""
    nbytes, flops = analytic_bytes(batch, size), analytic_flops(batch, size)
    rows = []
    for stage in STAGES:
        t_hbm = nbytes[stage] / HBM_BYTES_PER_S * 1e3
        t_tc = flops[stage] / TC_BF16_FLOPS * 1e3
        rows.append({"stage": stage, "gb": nbytes[stage] / 1e9, "gflop": flops[stage] / 1e9,
                     "t_hbm_ms": t_hbm, "t_tc_ms": t_tc,
                     "bound": "hbm" if t_hbm >= t_tc else "tensor cores",
                     "t_bound_ms": max(t_hbm, t_tc)})
    return rows


def main(argv=None) -> dict:
    """Measure, print the table, write the record; returns the record."""
    import torch

    from vbt_tpu_torch.ops.preprocess import preprocess_frames
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline
    from vbt_tpu_torch.tools import _timing

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=BATCH)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=OUT, help="the JSON record ('0': none)")
    args = parser.parse_args(argv)
    dev = _timing.prepare_device(args.device, "roofline")
    pipe = DetectionPipeline.from_model_arg(CKPT, device=dev)
    size = pipe.spec.input_size
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(
        rng.integers(0, 255, size=(args.batch, size, size, 3), dtype=np.uint8)).to(dev)

    def forward(_):
        with torch.inference_mode():
            images = preprocess_frames(frames, size, pipe.dtype)
            return pipe.run_model(images)

    fwd_ms = _timing.marginal_ms(forward)
    det_ms = _timing.marginal_ms(lambda _: pipe.detect_batch(frames))
    name, limit_w = _timing.card(dev)
    rows = stage_rows(args.batch, size)
    sum_bound = sum(r["t_bound_ms"] for r in rows if r["stage"] in FORWARD_STAGES)
    print(f"card: {name}, power limit {limit_w} W; lite0 at {size}, batch {args.batch}, "
          f"{pipe.dtype}")
    print(f"{'stage':12s} {'GB':>8s} {'GFLOP':>9s} {'t_hbm ms':>9s} {'t_tc ms':>8s} "
          f"{'bound ms':>9s} by")
    for r in rows:
        print(f"{r['stage']:12s} {r['gb']:8.4f} {r['gflop']:9.2f} {r['t_hbm_ms']:9.4f} "
              f"{r['t_tc_ms']:8.4f} {r['t_bound_ms']:9.4f} {r['bound']}")
    print(f"measured on {dev}: forward {fwd_ms:.3f} ms, detect {det_ms:.3f} ms, "
          f"postprocess (difference) {det_ms - fwd_ms:.3f} ms")
    print(f"sum of the forward's stage bounds {sum_bound:.4f} ms against the measured forward "
          f"{fwd_ms:.3f} ms ({fwd_ms / sum_bound:.2f}x)")
    record = {"batch": args.batch, "size": size, "device": name, "power_limit_w": limit_w,
              "peaks": {"hbm_bytes_per_s": HBM_BYTES_PER_S, "tc_bf16_flops": TC_BF16_FLOPS},
              "measured_ms": {"forward": fwd_ms, "detect": det_ms,
                              "postprocess_diff": det_ms - fwd_ms},
              "stage_rows": rows, "sum_stage_bound_ms_forward": sum_bound,
              "backbone_group_bytes": analytic_bytes(args.batch, size)["_backbone_groups"]}
    if args.out != "0":
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
        print(f"wrote {args.out}")
    return record


if __name__ == "__main__":
    main()
