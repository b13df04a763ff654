"""Benchmark: EfficientDet-Lite0 at 320, batched detection throughput on one card.

Port of the JAX package's ``bench.py``. It measures the served path
(preprocess of uint8 frames already on the card, the bf16 backbone, BiFPN
and heads, the top-K prefilter, anchor decode and the NMS kernel K1; K2 in
``--turbo``) and prints ONE JSON line with JAX's keys and metric names,
plus the card's name (``device``) and power limit (``power_limit_w``):

    python -m vbt_tpu_torch.bench [--int8] [--turbo] [--approx_prefilter] [--device cpu]

- ``value`` is the median marginal frames/s of ``detect_batch`` at
  ``BENCH_BATCH`` (default 128) over 8 distinct uint8 batches, by the
  method of :mod:`vbt_tpu_torch.tools._timing` (host clock around a
  readback: what a user waits for); ``best_fps`` the fastest trial;
  ``vs_baseline`` against the north-star 2000 frames/s;
- ``forward_ms_per_batch`` the median marginal ms of
  :meth:`DetectionPipeline.forward` (preprocess and model);
- ``mfu`` the forward's FLOPs (:func:`~vbt_tpu_torch.tools.roofline.analytic_flops`,
  2 x MACs of every convolution, the same count in every lane) over its
  median time, divided by the H100's dense bf16 peak of 989 TFLOP/s (at
  700 W), in every lane, as JAX divides by its chip's bf16 peak; ``null``
  on the CPU.

The shipped ``models/efficientdet_lite0_whole.msgpack`` is served when
present, else :meth:`DetectionPipeline.init_variables`. ``--int8``
calibrates on 8 frames drawn first from ``np.random.default_rng(0)``, the
generator the batches come from next.

Run as a program, the bench first probes the card
(:func:`~vbt_tpu_torch.utils.health.require_healthy_device`, retrying for
``VBT_TORCH_HEALTH_RETRY_S``, default 600 s here), then measures in a
child process with a deadline of ``VBT_TORCH_BENCH_DEADLINE_S`` (default
850 s) less the probe's time, at least 30 s. A card that is missing, sick
or wedged, a child that times out or dies without a JSON line, and any
failure inside the measurement each end in one line with ``"invalid":
true`` and a reason, and exit code 1; nothing falls back to the CPU.
``VBT_TORCH_HEALTH_PROBE=0`` measures in this process without the probe.

Each valid run writes its raw record (every trial, the checkpoint, a
timestamp) to ``out/bench_last.json`` under the checkout, or to
``VBT_TORCH_BENCH_RAW`` ("0": nowhere).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models", "efficientdet_lite0_whole.msgpack")
# The bench's batch: the served operating point, recorded in the line.
BATCH = int(os.environ.get("BENCH_BATCH", "128"))
N_BATCHES = 8  # distinct frame batches, cycled
TARGET_FPS = 2000.0  # the north-star baseline (BASELINE.md)
METRIC = "efficientdet_lite0_320_detection_throughput"
UNIT = "frames/sec/chip"
RAW_ENV = "VBT_TORCH_BENCH_RAW"
DEADLINE_ENV = "VBT_TORCH_BENCH_DEADLINE_S"
INNER_ENV = "VBT_TORCH_BENCH_INNER"
DEFAULT_DEADLINE_S = 850.0
DEFAULT_RETRY_S = "600"  # the bench's health-probe retry window


def _metric_name(argv) -> str:
    metric = METRIC
    if "--int8" in argv:
        metric += "_int8"
    if "--turbo" in argv:
        metric += "_turbo"
    if "--approx_prefilter" in argv:
        metric += "_approx"
    return metric


def _invalid(metric: str, reason: str, raw_trials=None) -> int:
    verdict = {"metric": metric, "value": None, "unit": UNIT, "vs_baseline": None,
               "invalid": True, "reason": reason}
    if raw_trials is not None:
        verdict["raw_trials_s_per_iter"] = [round(r, 6) for r in raw_trials]
    print(json.dumps(verdict), flush=True)
    return 1


def build_pipeline(int8: bool, turbo: bool, prefilter: str, device, rng):
    """The bench's pipeline: the shipped lite0 (or ``init_variables``) in
    the device's serving dtype, the turbo backbone or not, int8-calibrated
    on 8 frames of ``rng`` or not."""
    from vbt_tpu_torch.models import get_model_spec
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline

    backbone = "turbo" if turbo else "xla"
    if os.path.isfile(CKPT):
        pipe = DetectionPipeline.from_model_arg(CKPT, device=device, backbone=backbone,
                                                prefilter=prefilter)
    else:
        spec = get_model_spec("efficientdet_lite0")
        pipe = DetectionPipeline(spec, DetectionPipeline.init_variables(spec), device=device,
                                 backbone=backbone, prefilter=prefilter)
    if int8:
        size = pipe.spec.input_size
        pipe = pipe.calibrate(rng.integers(0, 255, size=(8, size, size, 3)).astype(np.uint8))
    return pipe


def frame_batches(rng, batch: int, size: int, device, n: int = N_BATCHES) -> list:
    """``n`` distinct uint8 (batch, size, size, 3) batches on ``device``, so
    that no cache of a result can flatter the rate."""
    import torch

    return [torch.from_numpy(rng.integers(0, 255, size=(batch, size, size, 3)).astype(np.uint8))
            .to(device) for _ in range(n)]


def main(int8: bool = False, turbo: bool = False, prefilter: str = "exact",
         device: str = "cuda") -> dict:
    """Measure one lane and print its line; returns the headline. Raises
    ``SystemExit(1)`` after printing an invalid line."""
    from vbt_tpu_torch.tools import _timing
    from vbt_tpu_torch.tools.roofline import TC_BF16_FLOPS, analytic_flops
    from vbt_tpu_torch.utils.health import CUDAUnhealthyError

    metric = _metric_name(["--int8"] * int8 + ["--turbo"] * turbo
                          + ["--approx_prefilter"] * (prefilter == "approx"))
    try:
        dev = _timing.prepare_device(device, "bench")
    except (CUDAUnhealthyError, RuntimeError) as e:
        raise SystemExit(_invalid(metric, str(e)))
    batch = BATCH
    # Any failure from here on (a build, a launch, every trial swallowed)
    # still ends in one machine-readable line.
    try:
        rng = np.random.default_rng(0)
        pipe = build_pipeline(int8, turbo, prefilter, dev, rng)
        size = pipe.spec.input_size
        batches = frame_batches(rng, batch, size, dev)

        def detect(i):
            return pipe.detect_batch(batches[i % len(batches)])

        def forward(i):
            return pipe.forward(batches[i % len(batches)])

        _timing.timed_run(detect, 2)  # first launches, the kernels' build
        _timing.timed_run(forward, 2)
        det = _timing.marginal_seconds(detect)
        fwd = _timing.marginal_seconds(forward)
        name, limit_w = _timing.card(dev)
    except Exception as e:  # noqa: BLE001 - the verdict first, the traceback on stderr
        import traceback

        traceback.print_exc()
        raise SystemExit(_invalid(metric, f"{type(e).__name__}: {e}",
                                  getattr(e, "raw_trials", None)))

    fps = batch / det.median_s
    mfu = None
    if dev.type == "cuda":
        mfu = sum(analytic_flops(batch, size).values()) / fwd.median_s / TC_BF16_FLOPS
    headline = {
        "metric": metric,
        "value": round(fps, 1),
        "unit": UNIT,
        "vs_baseline": round(fps / TARGET_FPS, 3),
        "batch": batch,
        "best_fps": round(batch / det.best_s, 1),
        "forward_ms_per_batch": round(fwd.median_s * 1e3, 3),
        "mfu": round(mfu, 4) if mfu is not None else None,
        "device": name,
        "power_limit_w": limit_w,
    }
    print(json.dumps(headline), flush=True)
    raw_path = os.environ.get(RAW_ENV, os.path.join(REPO, "out", "bench_last.json"))
    if raw_path != "0":
        record = {
            "headline": headline,
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "n_short": _timing.N_SHORT,
            "n_long": _timing.N_LONG,
            "detect_trials_s_per_iter": [round(r, 6) for r in det.raw_trials],
            "forward_trials_s_per_iter": [round(r, 6) for r in fwd.raw_trials],
            "detect_trials_fps": [round(batch / r, 1) if r > 0 else None
                                  for r in det.raw_trials],
            "checkpoint": os.path.basename(CKPT) if os.path.isfile(CKPT) else "random-init",
        }
        try:
            os.makedirs(os.path.dirname(os.path.abspath(raw_path)), exist_ok=True)
            with open(raw_path, "w") as f:
                json.dump(record, f, indent=1)
                f.write("\n")
        except OSError:
            pass  # a read-only checkout must not lose the line
    return headline


def _parse(argv) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m vbt_tpu_torch.bench",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--int8", action="store_true")
    parser.add_argument("--turbo", action="store_true")
    parser.add_argument("--approx_prefilter", action="store_true")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def _outer(argv) -> int:
    """Probe, then measure in a deadlined child process (module docstring).

    A card can pass the probe and then wedge inside the measurement, where
    the parent would block in a readback that no signal interrupts; the
    child's deadline turns that into an invalid line instead of a silent
    kill with no line."""
    from vbt_tpu_torch.utils.health import CUDAUnhealthyError, require_healthy_device

    args = _parse(argv)
    metric = _metric_name(argv)
    t_start = time.monotonic()
    try:
        require_healthy_device(args.device, context="bench",
                               retry_window_s=float(os.environ.get("VBT_TORCH_HEALTH_RETRY_S",
                                                                   DEFAULT_RETRY_S)))
    except (CUDAUnhealthyError, RuntimeError) as e:
        return _invalid(metric, str(e))
    budget = max(30.0, float(os.environ.get(DEADLINE_ENV, DEFAULT_DEADLINE_S))
                 - (time.monotonic() - t_start))
    env = dict(os.environ)
    env[INNER_ENV] = "1"
    env["VBT_TORCH_HEALTH_PROBE"] = "0"  # probed above
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    try:
        proc = subprocess.run([sys.executable, "-m", "vbt_tpu_torch.bench", *argv], env=env,
                              timeout=budget, capture_output=True, text=True)
    except subprocess.TimeoutExpired:
        return _invalid(metric, (
            f"measurement wedged: health probe passed but the measurement subprocess "
            f"exceeded its {budget:.0f}s budget; the card stalled mid-measurement"))
    sys.stderr.write(proc.stderr or "")
    out = (proc.stdout or "").strip()
    if out and out.splitlines()[-1].startswith("{"):
        print(out, flush=True)  # the child's one JSON line (headline or invalid)
        return proc.returncode
    return _invalid(metric, f"bench subprocess died (rc={proc.returncode}) with no JSON line")


if __name__ == "__main__":
    argv = sys.argv[1:]
    if os.environ.get(INNER_ENV) == "1" or os.environ.get("VBT_TORCH_HEALTH_PROBE") == "0":
        args = _parse(argv)
        main(int8=args.int8, turbo=args.turbo,
             prefilter="approx" if args.approx_prefilter else "exact", device=args.device)
    else:
        sys.exit(_outer(argv))
