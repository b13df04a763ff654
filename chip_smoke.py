#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's track path on one CUDA card, check it, time it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
card and ``nvcc``; without a card it exits with code 2 and prints no result.

Phases, each of which raises on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of the path from ``vbt_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once);
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (B = 64 images, K = 512 candidates, float32), on random and
   adversarial inputs and on the candidates of a real frame batch: counts
   exact, scores within 1e-6, boxes within 1e-5;
4. the main path: the shipped EfficientDet-Lite0 weights served in bf16 on
   the card, 4 batches of 64 synthetic 720x1280 frames of a moving plate,
   ``detect_batch`` -> ``detections_to_tracker_inputs`` -> host OC-SORT ->
   ``tracks_to_data``, with every kernel's launch count read around it;
5. the bf16 pipeline against an f32 one on the same card, and the f32 card
   pipeline against the f32 CPU pipeline (plain versions) on two frames;
6. each kernel's time beside its plain version's and its bound;
7. where one batch's time goes: stage spans on the device stream, and the
   device's busy share and time by kernel from ``torch.profiler``.

The second-to-last line is the ``{"kernels": [...]}`` record; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "models", "efficientdet_lite0_whole.msgpack")
BATCH, BATCHES, HEIGHT, WIDTH = 64, 4, 720, 1280
K, D = 512, 25
SCORE_ATOL, BOX_ATOL = 1e-6, 1e-5
# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _nms_cases(gen, dev):
    """(label, logits (B, K), boxes (B, K, 4), kwargs) at the main-path shape,
    plus the adversarial cases the kernel's contract names."""
    import torch

    def boxes(b=BATCH, k=K):
        yx = torch.rand(b, k, 2, generator=gen) * 0.8
        hw = torch.rand(b, k, 2, generator=gen) * 0.28 + 0.02
        return torch.cat([yx, yx + hw], -1)

    def logits(b=BATCH, k=K):
        return torch.randn(b, k, generator=gen) * 3.0 - 2.0

    cases = [("random", logits(), boxes(), {})]
    tied = logits()
    tied[:, ::13] = 3.0  # exact score ties: the lowest candidate index wins
    cases.append(("ties", tied, boxes(), {}))
    same = boxes()[:, :1].expand(BATCH, K, 4).contiguous()
    cases.append(("all_suppressed", logits(), same, {}))
    cases.append(("threshold_above_all", logits().clamp(max=6.0), boxes(),
                  {"score_threshold": 0.999}))
    short = logits(k=300)
    short[:, :20] = float("-inf")
    short[:, 20:40] = -100.0  # underflows to a score of exactly 0
    cases.append(("k300_with_pads", short, boxes(k=300), {}))
    few = torch.full((BATCH, K), float("-inf"))
    few[:, [5, 17, 40]] = torch.tensor([1.0, 2.0, 3.0])
    cases.append(("stops_at_zero", few, boxes(), {}))
    return [(n, lg.to(dev), bx.to(dev), kw) for n, lg, bx, kw in cases]


def _hold_nms(label, logits, boxes, **kw) -> float:
    """Kernel vs plain version on the card; returns the max abs difference."""
    import torch
    from vbt_tpu_torch.ops.nms_cuda import nms
    from vbt_tpu_torch.ops.postprocess import nms_plain

    got = nms(logits, boxes, **kw)
    torch.cuda.synchronize()
    want = nms_plain(logits, boxes, **kw)
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"nms {label}: counts differ {got[0].tolist()} vs {want[0].tolist()}")
    ds = (got[1] - want[1]).abs().max().item()
    db = (got[2] - want[2]).abs().max().item()
    if not (ds <= SCORE_ATOL and db <= BOX_ATOL):
        raise AssertionError(f"nms {label}: scores differ by {ds}, boxes by {db}")
    print(f"nms vs plain [{label}]: counts equal (mean {got[0].float().mean().item():.2f}), "
          f"max |d score| {ds:.3g}, max |d box| {db:.3g}")
    return max(ds, db)


def _candidates(pipe, frames):
    """The NMS kernel's inputs on the main path for one frame batch."""
    from vbt_tpu_torch.ops.postprocess import gather_decode, top_k_candidates

    deltas, logits = pipe.forward(frames)
    top_logits, idx = top_k_candidates(logits[..., 0].float(), K)
    boxes = gather_decode(deltas, pipe.anchors, idx, pipe.spec.input_size)
    return top_logits.contiguous(), boxes.contiguous()


def _stage_spans(pipe, frames) -> dict:
    """Device-stream time (ms) between the stages of one ``detect_batch``,
    taken with CUDA events and no synchronisation between stages, so a span
    includes any time the card waited for the host to launch its work."""
    import torch
    from vbt_tpu_torch.ops.nms_cuda import nms
    from vbt_tpu_torch.ops.postprocess import gather_decode, top_k_candidates
    from vbt_tpu_torch.ops.preprocess import preprocess_frames

    names = ["upload", "preprocess", "forward", "topk+decode", "nms", "readback"]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    with torch.inference_mode():
        events[0].record()
        x = pipe._frames(frames)
        events[1].record()
        images = preprocess_frames(x, pipe.spec.input_size, pipe.dtype)
        events[2].record()
        deltas, logits = pipe.model(images)
        events[3].record()
        top_logits, idx = top_k_candidates(logits[..., 0].float(), K)
        boxes = gather_decode(deltas, pipe.anchors, idx, pipe.spec.input_size)
        events[4].record()
        out = nms(top_logits.contiguous(), boxes.contiguous())
        events[5].record()
        [t.cpu() for t in out]
        events[6].record()
    torch.cuda.synchronize()
    return {n: events[i].elapsed_time(events[i + 1]) for i, n in enumerate(names)}


def _profile(pipe, batches) -> None:
    """The device's busy share and its time by kernel over ``detect_batch``
    plus readback of ``batches``, from the device events of
    ``torch.profiler`` (the host clock inside the profiled region, which the
    profiler's own per-op cost lengthens, is the window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for frames in batches:
            pipe.detections_to_tracker_inputs(pipe.detect_batch(frames), 0.5)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith("Activity Buffer")]
    if not spans:
        print("profile: the profiler recorded no device time (not measured)")
        return
    busy_us, end = 0.0, float("-inf")
    by_name: dict[str, list] = {}
    for start, stop, name in sorted(spans):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += stop - start
        acc[1] += 1
    print(f"profile over {len(batches)} batches: host window {wall_us / 1e3:.2f} ms, "
          f"device busy {busy_us / 1e3:.2f} ms, idle share {1 - busy_us / wall_us:.3f}")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {us / 1e3:9.3f} ms {us / busy_us:6.1%} x{n:<5d} {name[:90]}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from vbt_tpu_torch.cli.track import run_host_tracker, tracks_to_data
    from vbt_tpu_torch.io.synthetic import plate_frames
    from vbt_tpu_torch.ops import _build
    from vbt_tpu_torch.ops.nms_cuda import nms
    from vbt_tpu_torch.ops.postprocess import nms_plain
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline

    t_all = time.perf_counter()
    # 1. The card.
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(_nvidia_smi())

    # 2. Build every kernel of the path.
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"built {built} in {time.perf_counter() - t0:.2f} s")

    # 3. Kernel vs plain version at the main-path shapes.
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    for label, logits, boxes, kw in _nms_cases(gen, dev):
        max_err = max(max_err, _hold_nms(label, logits, boxes, **kw))

    # 4. The main path, bf16 on the card.
    t0 = time.perf_counter()
    frames = plate_frames(BATCH * BATCHES, HEIGHT, WIDTH, seed=0)
    print(f"made {frames.shape[0]} frames {HEIGHT}x{WIDTH} in {time.perf_counter() - t0:.2f} s")
    pipe = DetectionPipeline.from_model_arg(CKPT, device="cuda")
    if pipe.dtype != torch.bfloat16 or not pipe.use_kernel:
        raise AssertionError(f"served lane is {pipe.dtype}, use_kernel={pipe.use_kernel}")
    pipe.detect_batch(frames[:BATCH])  # warm-up: cuDNN plans, first launches
    torch.cuda.synchronize()
    kernels = {"nms": nms}
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    rows, valid = [], []
    for i in range(BATCHES):
        det = pipe.detect_batch(frames[i * BATCH:(i + 1) * BATCH])
        r, v = pipe.detections_to_tracker_inputs(det, 0.5)
        rows.append(r)
        valid.append(v)
    t_detect = time.perf_counter() - t0
    rows, valid = np.concatenate(rows), np.concatenate(valid)
    tracks = run_host_tracker(rows, valid)
    data = tracks_to_data(tracks, fps=30.0)
    t_path = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"main path: launches {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    if rows.shape != (BATCH * BATCHES, D, 6) or not np.isfinite(rows).all():
        raise AssertionError(f"tracker rows {rows.shape} not finite or misshapen")
    if not valid[:, 0].all():
        raise AssertionError(f"the plate was missed in {int((~valid[:, 0]).sum())} frames")
    n_rows = len(data["id"])
    if n_rows < BATCH * BATCHES - 2 or not all(np.isfinite(data[c]).all() for c in data):
        raise AssertionError(f"track data has {n_rows} rows or non-finite values")
    ids = sorted(set(data["id"]))
    print(f"main path: {frames.shape[0]} frames, {n_rows} track rows, ids {ids}; "
          f"detect {t_detect:.3f} s ({frames.shape[0] / t_detect:.1f} frames/s), "
          f"host tracker+rows {t_path - t_detect:.3f} s, whole {t_path:.3f} s")

    # 5. bf16 vs f32 on the card; f32 card (kernel) vs f32 CPU (plain).
    small = frames[:BATCH]
    pipe32 = DetectionPipeline.from_model_arg(CKPT, device="cuda", dtype=torch.float32)
    l16 = pipe.forward(small)[1].float()
    l32 = pipe32.forward(small)[1]
    d16, d32 = pipe.detect_batch(small), pipe32.detect_batch(small)
    dlogit = (l16 - l32).abs().max().item()
    dbox = (d16.boxes[:, 0] - d32.boxes[:, 0]).abs().max().item()
    print(f"bf16 vs f32 on the card: max |d logit| {dlogit:.4g}, max |d top box| {dbox:.4g}")
    if dbox > 0.05:
        raise AssertionError("bf16 top boxes drift more than 0.05 of the frame from f32")
    cpu = DetectionPipeline.from_model_arg(CKPT, device="cpu")
    dc, dg = cpu.detect_batch(small[:2]), pipe32.detect_batch(small[:2])
    dl_cpu = (cpu.forward(small[:2])[1] - pipe32.forward(small[:2])[1].cpu()).abs().max().item()
    db_cpu = (dc.boxes[:, 0] - dg.boxes[:, 0].cpu()).abs().max().item()
    print(f"f32 card vs f32 CPU: max |d logit| {dl_cpu:.4g}, max |d top box| {db_cpu:.4g}")
    # Convolution sums in another order (cuDNN vs CPU), TF32 off: 1e-3 on
    # logits and 1e-4 on normalized boxes leave room for that and no more.
    if not torch.equal(dc.count, dg.count.cpu()) or dl_cpu > 1e-3 or db_cpu > 1e-4:
        raise AssertionError("the f32 card pipeline disagrees with the CPU pipeline")

    # 6. Kernel time at the main-path inputs, beside the plain version and the bound.
    logits_k, boxes_k = _candidates(pipe, small)
    max_err = max(max_err, _hold_nms("main_path_batch", logits_k, boxes_k))
    count = nms(logits_k, boxes_k)[0]
    ms = _cuda_ms(lambda: nms(logits_k, boxes_k), reps=200)
    plain_ms = _cuda_ms(lambda: nms_plain(logits_k, boxes_k), reps=10)
    b, k = logits_k.shape
    n_bytes = (logits_k.numel() + boxes_k.numel()) * 4 + b * 4 + b * D * 4 * 5
    # sigmoid + area per candidate (7 ops); per round that selects, the
    # argmax compare and the IoU test per candidate (14 ops).
    n_ops = b * k * 7 + int(count.sum().item()) * k * 14
    byte_ms, op_ms = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    record = {
        "name": "nms",
        "route": "cuda",
        "source": "vbt_tpu_torch/csrc/nms.cu",
        "replaces": "vbt_tpu/ops/nms_pallas.py:71",
        "launches": launches["nms"],
        "max_abs_err": max_err,
        "max_abs_diff_vs_plain": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
        "library_ms": None,
    }
    print(f"nms: {ms * 1e3:.2f} us/launch, plain {plain_ms:.3f} ms, bound "
          f"{record['bound_ms'] * 1e3:.3f} us ({record['bound_by']}); "
          f"whole run {time.perf_counter() - t_all:.1f} s")

    # 7. Where the time of one 64-frame batch goes.
    spans = [_stage_spans(pipe, frames[i * BATCH:(i + 1) * BATCH]) for i in range(3)]
    print("stage spans on the device stream, ms, 3 batches: " + ", ".join(
        f"{n} {sorted(s[n] for s in spans)[1]:.3f}" for n in spans[0]))
    _profile(pipe, [frames[i * BATCH:(i + 1) * BATCH] for i in range(2)])
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
