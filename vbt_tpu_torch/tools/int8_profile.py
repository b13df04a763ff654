"""The int8 lane against bf16 on the card: whole model, stages, single convs.

Port of the JAX package's ``tools/int8_profile.py``, by the marginal method
of :mod:`._timing`:

1. the whole-model forward (``DetectionPipeline.forward``: preprocess and
   model) of the shipped lite0, bf16 against int8 calibrated on 16 frames of
   seed 0, at B = 64, 128 and 256;
2. the stage split at B = 128 (``--micro_batch``): the backbone against the
   BiFPN plus heads, each lane;
3. the conv micro-ablation on representative lite0 shapes (the 3-channel
   stem left out, as in JAX): the bf16 convolution, the full ``Conv2dSame``
   int8 path of ``models/quant.py`` (quantize the input, the int8 product by
   ``torch._int_mm``, dequantize), and the bare int8 core (pre-quantized
   operands, int32 out, no quantize or dequantize).

A fused int8 lane (quantize, product and dequantize in one kernel) is to be
judged by this tool. The report goes to ``out/int8_profile.json`` under the
checkout (``--out``).

Usage: ``python -m vbt_tpu_torch.tools.int8_profile [--batches 64 128 256] [--micro_batch 128] [--device cpu]``
"""

from __future__ import annotations

import argparse
import copy
import json
import os

import numpy as np

BATCHES = (64, 128, 256)
# (h, w, cin, cout, k, stride) at --micro_batch: the early pointwise expand at P3, a
# late pointwise expand, the final stage's pointwise, the BiFPN/head 3x3 at P3.
MICRO_SHAPES = ((40, 40, 24, 144, 1, 1), (20, 20, 112, 672, 1, 1), (10, 10, 1152, 320, 1, 1),
                (40, 40, 64, 64, 3, 1))


def conv_micro(batch, h, w, cin, cout, k, stride, device) -> dict:
    """bf16 conv, the int8 path with quantize/dequantize, and the bare int8
    core for one NCHW shape, ms each."""
    import torch

    from vbt_tpu_torch.models import quant as q
    from vbt_tpu_torch.models.conv import Conv2dSame, pad_same
    from vbt_tpu_torch.tools import _timing

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(batch, cin, h, w, generator=gen)
    conv = Conv2dSame(cin, cout, k, stride)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * (cin * k * k) ** -0.5)
    conv.act_scale = x.abs().amax()  # what calibration records on this input
    qconv = copy.deepcopy(conv)
    q.set_mode(qconv, q.INT8)
    conv = q.cast_model(conv, device, torch.bfloat16)
    qconv = q.cast_model(qconv, device, torch.bfloat16)
    x = x.to(device, torch.bfloat16)
    x_q = pad_same(q.quantize(x, q.input_scale(qconv.act_scale)), k, stride)
    with torch.inference_mode():
        row = {
            "shape": f"{batch}x{cin}x{h}x{w}->{cout} k{k}s{stride}",
            "gmacs": batch * -(-h // stride) * -(-w // stride) * cout * cin * k * k / 1e9,
            "bf16_ms": _timing.marginal_ms(lambda _: conv(x)),
            "int8_qdq_ms": _timing.marginal_ms(lambda _: qconv(x)),
            "int8_core_ms": _timing.marginal_ms(lambda _: q.int8_conv(x_q, qconv.w_int8, stride)),
        }
    return row


def main(argv=None) -> dict:
    """Print each row as a JSON line; returns the report."""
    import torch

    from vbt_tpu_torch.bench import CKPT, REPO, frame_batches
    from vbt_tpu_torch.ops.preprocess import preprocess_frames
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline
    from vbt_tpu_torch.tools import _timing

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    parser.add_argument("--micro_batch", type=int, default=128,
                        help="batch of the stage split and the conv micro-ablation")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=os.path.join(REPO, "out", "int8_profile.json"),
                        help="the JSON report ('0': none)")
    args = parser.parse_args(argv)
    dev = _timing.prepare_device(args.device, "int8_profile")
    name, limit_w = _timing.card(dev)
    rng = np.random.default_rng(0)
    bf16 = DetectionPipeline.from_model_arg(CKPT, device=dev)
    size = bf16.spec.input_size
    lanes = {"bf16": bf16,
             "int8": bf16.calibrate(rng.integers(0, 255, size=(16, size, size, 3))
                                    .astype(np.uint8))}
    report = {"device": name, "power_limit_w": limit_w, "whole_model": [], "stages": [],
              "conv_micro": []}

    def emit(part, row):
        report[part].append(row)
        print(json.dumps(row), flush=True)

    for batch in args.batches:
        frames = frame_batches(rng, batch, size, dev, n=1)[0]
        row = {"batch": batch}
        for tag, pipe in lanes.items():
            row[f"{tag}_ms"] = _timing.marginal_ms(lambda _, p=pipe: p.forward(frames))
        row["speedup"] = row["bf16_ms"] / row["int8_ms"]
        emit("whole_model", row)

    # The split materializes the backbone's taps, which the whole forward
    # also does (eager torch), so the two stages add up to the model.
    frames = frame_batches(rng, args.micro_batch, size, dev, n=1)[0]
    with torch.inference_mode():
        for tag, pipe in lanes.items():
            images = preprocess_frames(frames, size, pipe.dtype)
            feats = pipe.model.backbone(images)
            emit("stages", {
                "stage_profile": tag, "batch": args.micro_batch,
                "backbone_ms": _timing.marginal_ms(lambda _, p=pipe: p.model.backbone(images)),
                "neck_heads_ms": _timing.marginal_ms(
                    lambda _, p=pipe, f=feats: p.model.neck_and_heads(f)),
            })
    for shape in MICRO_SHAPES:
        emit("conv_micro", conv_micro(args.micro_batch, *shape, dev))
    if args.out != "0":
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
        print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
