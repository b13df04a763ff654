"""Timing probes of the detection pipeline's stages on the card.

Port of the JAX package's ``tools/perf_probe.py`` by the marginal method of
:mod:`._timing` (a host readback ends every timed region). EfficientDet-
Lite0 from :meth:`DetectionPipeline.init_variables` in the device's serving
dtype (bf16 with K1 on the card), ``--int8`` calibrated on 8 frames of seed
0. At each batch (64 and 128 by default) of uint8 320x320 frames already on
the device it prints the marginal ms of

- ``preprocess``: ``preprocess_frames``;
- ``forward``: the model on the preprocessed images;
- ``postprocess``: top-K prefilter, decode and NMS on the forward's outputs;
- ``detect``: the whole ``detect_batch``;

with frames/s and the forward's TFLOP/s (FLOPs of
``roofline.analytic_flops``).

Usage: ``python -m vbt_tpu_torch.tools.perf_probe [--int8] [--batches 64 128] [--device cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np

BATCHES = (64, 128)


def probe(pipe, batch: int, rng) -> dict:
    """Marginal ms of each stage at ``batch`` (module docstring)."""
    import torch

    from vbt_tpu_torch.bench import frame_batches
    from vbt_tpu_torch.ops.preprocess import preprocess_frames
    from vbt_tpu_torch.tools import _timing

    size = pipe.spec.input_size
    frames = frame_batches(rng, batch, size, pipe.device, n=1)[0]
    with torch.inference_mode():
        images = preprocess_frames(frames, size, pipe.dtype)
        deltas, logits = pipe.run_model(images)
        stages = {
            "preprocess": lambda _: preprocess_frames(frames, size, pipe.dtype),
            "forward": lambda _: pipe.run_model(images),
            "postprocess": lambda _: pipe.postprocess(deltas, logits),
            "detect": lambda _: pipe.detect_batch(frames),
        }
        return {name: _timing.marginal_ms(fn) for name, fn in stages.items()}


def main(argv=None) -> dict:
    """Print every stage at every batch; returns ``{batch: {stage: ms}}``."""
    from vbt_tpu_torch.models import get_model_spec
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline
    from vbt_tpu_torch.tools.roofline import analytic_flops
    from vbt_tpu_torch.tools._timing import prepare_device

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--int8", action="store_true")
    parser.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = prepare_device(args.device, "perf_probe")
    spec = get_model_spec("efficientdet_lite0")
    rng = np.random.default_rng(0)
    pipe = DetectionPipeline(spec, DetectionPipeline.init_variables(spec), device=dev)
    if args.int8:
        size = spec.input_size
        pipe = pipe.calibrate(rng.integers(0, 255, size=(8, size, size, 3)).astype(np.uint8))
    print(f"lite0 {pipe.dtype} {'int8 ' if args.int8 else ''}on {dev}", flush=True)
    out = {}
    for batch in args.batches:
        ms = out[batch] = probe(pipe, batch, rng)
        tflops = sum(analytic_flops(batch, spec.input_size).values()) / (ms["forward"] / 1e3) / 1e12
        print(f"batch {batch:4d}: " + ", ".join(f"{k} {v:8.3f} ms" for k, v in ms.items())
              + f"; detect {batch / ms['detect'] * 1e3:8.0f} frames/s, forward "
              f"{tflops:6.1f} TFLOP/s", flush=True)
    return out


if __name__ == "__main__":
    main()
