#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's track, stream and train paths on one CUDA card; check, time them.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
card and ``nvcc``; without a card it exits with code 2 and prints no result.
``--ptxas`` builds with ``-Xptxas -v`` and prints every kernel's registers,
spills and shared memory.

Phases, each of which raises on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of the path from ``vbt_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once);
3. each kernel against its plain PyTorch version at the main path's shapes.
   NMS (B = 64 images, K = 512 candidates, float32) on random and
   adversarial inputs: counts exact, scores within 1e-6, boxes within 1e-5.
   Fused MBConv on the five blocks the turbo backbone fuses in
   EfficientDet-Lite0 at 320 (B = 64) and the seven of Lite2 at 448 (B = 8),
   with the shipped folded weights, and on odd non-square blocks (ragged
   channels, no expand conv, more input channels than the ``"mma"`` kernel
   takes): the FMA kernel in float32 within 2e-4, and in bfloat16 the kernel
   the launch plan names (the tensor-core ``"mma"`` kernel on every Lite0
   and Lite2 block) within 2e-2, absolute plus relative (``K2_TOL``). The
   scan tracker K3 (float32) against its plain version on CPU copies of the
   same inputs, on the tracker's test scenes, four ragged clips in one
   launch (and each alone, bit for bit) and, after phase 4, the main path's
   real detections: report, ids and conf exact, boxes within 1e-6, dxdy
   within ``K3_DXDY_ATOL``;
4. the main path, both backbones: the shipped EfficientDet-Lite0 weights
   served in bf16 on the card, 4 batches of 64 synthetic 720x1280 frames of
   a moving plate (8 periods of 32 frames), ``detect_batch`` (through the
   pinned staging ring) -> ``detections_to_tracker_inputs`` -> the scan
   tracker on the card (K3) and the host OC-SORT, whose dataframes must
   agree (same ids and rows, positions and plate sizes within 1e-6, dx/dy
   within ``HOST_DXDY_ATOL``) -> the plot CLI's smoothing and phase
   segmentation on the host (numpy float64) and with torch on the card,
   which must give the same phases, at least 4 of them concentric; each
   rep's ROM and ACV are printed beside the scene's analytic values. Every
   kernel's launch count is set to 0 before and read after each lane: the
   XLA lane launches NMS 4 times and K3 once, the turbo lane NMS 4 times,
   K3 once and fused MBConv 20 times, all 20 through the ``"mma"`` kernel;
5. the bf16 pipeline against an f32 one on the same card, the f32 card
   pipeline against the f32 CPU pipeline (plain versions) on two frames, and
   the f32 turbo pipeline against the f32 XLA pipeline on the card;
6. each kernel's time beside its plain version's and its bound; NMS on the
   card alone (``ms``, the replay of a CUDA graph of 100 launches) and in a
   loop of eager launches (``eager_ms``, the host's share included); for
   fused MBConv per lite0 block, the served
   kernel on the channels-last memory the turbo backbone gives it (``ms``)
   and on contiguous NCHW (``nchw_ms``), the FMA kernel on the same bf16
   inputs (``fma_ms``) and the port's unfused block (cuDNN convs,
   ``unfused_ms``); K3 by CUDA events on the main path's detections (C = 1,
   T = 256) and on synthetic 60 s clips (C = 1 and C = 16, T = 1800),
   beside the host OC-SORT on the same detections and the plain version on
   the card over 16 frames;
7. where one batch's time goes, for each backbone: the forward's device
   time (CUDA events over 10 calls on one preprocessed batch), stage spans
   through the pinned ring (the host's fill of the staging buffer, the copy
   on the copy stream, then the compute stream), a pageable ``.to()`` of the
   same batch for comparison, and the device's busy share and time by
   kernel from ``torch.profiler``;
8. the tracker carried across chunks: K3 run chunk by chunk with its state
   in and out (chunks of 7 and 64 frames and an uneven split) equals one
   launch bit for bit, outputs and final state, on the tracker's test
   scenes and on the main path's detections (D = 25, S = 16); the final
   state equals the plain version's (integer fields exact, positions
   within ``K3_BOX_ATOL``, Kalman velocities within ``K3_DXDY_ATOL`` and
   covariances within it relative to 1 + |want|); the time-shard relay over
   ``[cuda:0] * 4`` equals one launch bit for bit;
9. the analysis scan K4 against its plain version (CPU copies, float64) on
   the main path's followed track and a fuzz series, in chunks of 7 and 64:
   events and both carries within ``K4_RTOL`` relative (the largest
   difference is printed);
10. the stream: ``StreamingPipeline`` over the 256 frames in chunks of 64,
   bf16 lite0, through K1, K3 (state carried) and K4, with every count at 0
   before and read after (4 launches each); its live lines; its final phases
   equal the offline lane's (the K3 dataframe through the host analysis)
   with types exact, times within 1e-9 and ROM within 1e-9 relative; its
   frames/s and the host-clock spans of a chunk (detect, K3, the followed
   id's selection, K4, phases), then K3's time a 64-frame chunk with the
   state in and out and K4's time a 64-sample chunk (CUDA-graph replay)
   against its plain version on the card and its bound;
11. int8: the shipped lite0 calibrated on the first 64 frames
   (``DetectionPipeline.calibrate``), then the int8 lane over the 256 frames
   with every count at 0 before and read after (NMS 4, K3 1; every dense
   conv through ``torch._int_mm``, none on the float path), its trackers and
   analysis checked as in phase 4; every distinct int8 product of lite0 at
   320, at batch 64 and at batch 1, on the card (``_int_mm`` after the
   zero-padding rule) against the plain version on CPU copies of the same
   int8 inputs, bit for bit; the int8 lane's top boxes and scores beside the
   bf16 lane's; the int8 forward's device time beside the bf16 forward's
   (CUDA events) and its share in ``_int_mm``, quantize and dequantize
   (``torch.profiler``);
12. eval: synthetic plate images at five sizes, batch 1 each as
   ``vbt-torch-eval`` feeds them, through the bf16 and the int8 lane (NMS
   once an image): ``create_detections_df``'s matching of each image's
   detections to the analytic ``plate_boxes`` and ``evaluate_model``'s COCO
   AP, AP50 and AP75, printed for both lanes; the staging rings alive at the
   end, within ``MAX_RINGS``;
13. training, EfficientDet-Lite0 at 320 in float32 from the port's own
   initialization: (a) one batch augmented with the same draws on the card
   and on the CPU, then two train steps on the card against the same on CPU
   copies from one state, in float32 (each device's batch) and in float64
   (the CPU's batch), within ``TRAIN_BOUNDS`` (each group's largest
   difference over its bound printed);
   (b) ``DeviceDataTrainer`` from scratch on 64 synthetic plate images,
   B = 32, 30 steps with mosaic: the mean loss of the last 5 steps below
   that of the first 5, and the validation loss; (c) heads-only from the
   shipped ``efficientdet_lite0_whole.msgpack`` as donor: backbone and BiFPN
   parameters and statistics bit for bit the donor's after 6 steps; (d)
   ``save_train_checkpoint`` -> ``load_train_checkpoint`` bit for bit, then
   the raw and the EMA parameters of (b) through ``DetectionPipeline`` on 40
   held-out images (batches of 32 as ``evaluate_model`` feeds them: NMS once
   a batch, counted), their AP, and the export reloaded from its file giving
   the same detections; (e) the fused step's and the augmentation's time
   (CUDA events), images/s and the peak memory, beside the card's name and
   power limit, and the step's device busy time split by part
   (``torch.profiler``);
14. the operational shell, the ground-truth CLIs and bf16 training: (a) the
   CUDA health probe ``require_healthy_device("cuda")`` passes, with the
   child's marginal lite0 bf16 forward at B = 128 and its K1 launch count
   printed, and the ``wedged`` fake is killed within its deadline plus 5 s;
   (b) the keyed build cache: a second ``build_all()`` builds nothing, a
   changed ``SOURCE_FLAGS`` entry gives a new key and a new file, each
   library's key printed; (c) ``utils.profiling.trace`` around the detect +
   K3 path of ``vbt-torch-track`` over the 256 frames: the trace file read
   back holds K1's and K3's kernel events in the counts the wrappers
   launched, its size and top five device operations printed; (d) the
   ground-truth validation of that track against Kinovea and Qualisys
   exports of the scene's analytic trajectory (30 Hz, cm, comma decimals;
   100 Hz, mm, x negated, 11 header rows): MSE and r of each axis, r_y above
   ``GT_R_Y_MIN`` (x is constant in the scene, so r_x is NaN and not held);
   (e) ``Trainer(dtype=torch.bfloat16)``: two steps on the card against the
   CPU port's on the CPU's batch within ``TRAIN_BOUNDS["bfloat16"]`` (the
   losses, and each group of the state as one vector against the
   devices' own bf16-against-float32 distances), phase 13's recipe from
   scratch in bf16 (the loss falls), and the fused step in bf16 and in
   float32 in turns (median of 6 each): time, images/s, idle share and peak
   memory;
15. checkpoint selection and the host SORT: (a) the
   host ``SortTracker`` (max_age 30, IoU 0.1) and K3 with
   ``ScanTrackerConfig.sort`` on phase 4's 256 frames of detections, with
   every count at 0 before and read after (K3 once): the same ids and rows,
   positions and plate sizes within ``ROW_ATOL``, dx/dy within
   ``HOST_DXDY_ATOL``, both times printed, and K3-SORT against its plain
   version on CPU copies as in phase 3; (b) the tools of
   ``vbt_tpu_torch.tools`` on a VOC tree written by ``write_voc`` (15 test
   images at phase 12's five sizes, 8 train images) laid out as the
   reference's data, ``reference/data/{train,test}`` under
   ``out/chip_smoke_tools``, from which they run with no ``data_dir`` (their
   default, ``tools/_reference.py``; the working directory is restored
   after): ``ckpt_sweep`` over phase 13's checkpoint and a second step
   trained from it, ``ckpt_soup --top_k 3 --out`` on that sweep's log, the soup reloaded
   through ``DetectionPipeline`` and equal bit for bit to the float64
   average of its members computed on the CPU; ``ckpt_soup --top_k 3
   --seed_msgpack`` the shipped lite0 over the same checkpoints, each KEEP
   or drop held to the gate's rule on its printed metric and at least one
   drop (the seed's AP is far above the 30-step checkpoints'); and
   ``int8_delta`` on the shipped lite0 with ``--calib_n 8`` (its exit code
   the gate's rule); K1's count set to 0 before and read after each tool,
   held to one launch a batch of 32 images an evaluation (4, 3, 4 and 2
   here);
16. the plot CLI's analysis engines timed: ``cli/plot.py::analyze_phases``
   with the torch engine on the card beside the host lane, each on the same
   plot-smoothed dataframe, phase 4's track (the id the plot CLI picks, 256
   samples) and the synthetic plate's exact track over 60 s (1800 samples
   at 30 fps), the median of ``ANALYSIS_REPS`` calls after one to warm up;
   the phases of the two engines equal under phase 4's bounds, at least 4
   concentric;
17. the bench, the entry points and the measurement tools as a user runs
   them: ``python -m vbt_tpu_torch.bench`` in each of its four lanes
   (plain, ``--int8``, ``--turbo``, ``--approx_prefilter``; the health
   probe, then the measurement in a child), each last JSON line valid
   under the lane's metric name with ``value > 0`` and ``0 < mfu <= 1``;
   then each lane's pipeline as the bench builds it, one ``detect_batch``
   at the bench's batch in this process with the counts at 0: K1 once, K2
   five times through ``"mma"`` in the turbo lane and never elsewhere;
   ``python -m vbt_tpu_torch.entry --devices cuda:0,cuda:0`` (``entry ok``,
   ``dryrun ok``, after a data-parallel train step over the two);
   ``tools.roofline``'s table; ``tools.turbo_check`` and
   ``tools.prefilter_check`` twice, each run's ``images:`` line's count
   and source held: from a directory without the reference tree (32
   synthetic plates, the speed half at B = 64 and 128; exit 0), then from
   one holding ``reference/data/test/`` of ``CHECK_JPEGS`` (32 ``write_voc``
   JPEGs, 16 at each of 240x320 and 480x640; the numerics alone; exit 0,
   but ``turbo_check``'s exit code is held to its printed verdict: its
   bf16 budget on these JPEGs is a finding, ``PERF.md`` §6), then
   ``turbo_check``'s two backbones on those JPEGs in float32 (K2's float32
   kernel) within its budgets, and in bf16 each image beyond them printed
   with its confident rows and their IoU with a higher row;
   ``tools.int8_profile`` and ``tools.perf_probe`` at B = 64 and 128; the
   tools in this process after phase 14's probe, K1 (and K2 in
   ``turbo_check``) counted per tool;
18. the data-parallel train step, ``Trainer(mesh=)``, lite0 at 320 on
   phase 13's synthetic plates augmented on the card (B = 32 global), over
   ``make_mesh()`` (every card) and one card as ``[cuda:0] * 2`` and
   ``* 4``, with every count at 0 before (a) and read after (b) (no kernel
   lies on this path): (a) two steps over each mesh against two one-device steps
   on the same card and batch, in float64 and float32 within
   ``TRAIN_BOUNDS``, and in bfloat16 within ``TRAIN_BOUNDS["bfloat16"]``
   (losses; each group of the state as one vector against the larger of
   the two lanes' own bf16-against-float32 distances); (b) the float32
   step over each mesh of more than one share beside the one-device step,
   by CUDA events in turns (median of 6 each), with the device's busy
   time, idle share and peak memory, beside the card's name and power
   limit; (c) ``entry.dryrun_multichip`` over ``[cuda:0] * 2`` in this
   process, its train step through the global BatchNorm statistics, the
   same number of reductions a share;
19. the end-to-end tools (``vbt_tpu_torch.tools.make_demo_video``,
   ``.e2e_acv_check``, ``.track_e2e_bench``) from a video file: (a)
   ``io/synthetic.py::write_demo_scene`` writes the stand-in scene into a
   temporary directory laid out as ``reference/data/test/``, under the
   pinned file name; (b) the JAX package's slow lane (3 reps, 30 fps, 9 s,
   270 frames), the card's lane (bf16, K1, K3) and a float32 CPU lane on
   the same video, each with the counts at 0: the same rep count, equal to
   3, the same ``max_travel_id`` track, each rep's ROM within
   ``E2E_ROM_RTOL`` of the CPU's and its duration (so its ACV) within
   ``E2E_DURATION_FRAMES`` frames, K1 ``ceil(270 / 64)`` and K3 once on the
   card and nothing on the CPU; both lanes' errors against the analytic
   truth and their verdicts printed, not held; (c) ``python -m
   vbt_tpu_torch.tools.e2e_acv_check`` run in that directory (its own
   probe of the card), its exit code the card lane's verdict, its record
   naming the card and ``pallas_nms``; (d) the time ``make_demo_video``
   takes to write a 60 s video, then ``track_e2e_bench`` at 60 s, B = 128
   in this process, its record printed, K1 once a batch in the warm and
   the recorded pass and K3 once a pass.

The second-to-last line is the ``{"kernels": [...]}`` record; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "models", "efficientdet_lite0_whole.msgpack")
LITE2_CKPT = os.path.join(REPO, "models", "efficientdet_lite2_whole.msgpack")
BATCH, BATCHES, HEIGHT, WIDTH = 64, 4, 720, 1280
PERIOD = 32  # frames per rep of the synthetic plate
LITE2_BATCH = 8
K, D = 512, 25
SCORE_ATOL, BOX_ATOL = 1e-6, 1e-5
# Fused MBConv against its plain version, absolute plus relative. float32:
# the 1x1 products are summed in another order (FMA loops vs cuBLAS).
# bfloat16: that order (the tensor cores' own in the "mma" kernel) can flip
# the bf16 rounding of one expanded or depthwise value (one step is 2^-8
# relative), which the later sums carry.
K2_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# The scan tracker K3 against its plain version, both float32: the kernel's
# 4x4 inverse and 7x7 products round in their own order, which the 1e4
# initial velocity covariance amplifies early in a track; ids, report and
# conf are exact, reported observations are copies.
K3_BOX_ATOL, K3_DXDY_ATOL = 1e-6, 1e-4
# K4 against its plain version, float64: both do the same operations in the
# same order (--fmad=false), so they should agree bit for bit; 1e-12
# relative leaves room for a math library's last bit and no more.
K4_RTOL = 1e-12
STREAM_CHUNK = 64  # frames a streamed chunk (the stream CLI's default)
# K3 (float32) against the host OC-SORT (numpy float64) on the main path:
# positions and plate sizes are float32 copies of the detections; dx/dy
# carry the float32 Kalman transient the JAX CLI documents as ~1e-2
# (vbt_tpu/cli/track.py:19-26).
ROW_ATOL, HOST_DXDY_ATOL = 1e-6, 1e-2
FPS, PLATE_DIAMETER = 30.0, 0.45
# Phases of the two analysis lanes: type and times exact, positions and ROM
# within 1e-9 relative (the same bound the JAX package holds its device lane
# to against the host lane, tests/test_velocity_jax.py).
PHASE_RTOL = 1e-9
ANALYSIS_SAMPLES, ANALYSIS_REPS = 1800, 3  # phase 16: 60 s at 30 fps
TIE_PAIRS = ((37, 38), (37, 53), (37, 69), (255, 256))  # i+1, i+16, i+32, across 255/256
# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12  # FP64 outside the tensor cores (NVIDIA data sheet, H100 SXM)
BF16_TENSOR_OPS_PER_S = 989e12
# Phase 13 (training).
TRAIN_SIZE, TRAIN_BATCH, TRAIN_STEPS, TRAIN_IMAGES = 320, 32, 30, 64
STEP_CHECK_BATCH = 8
# Two train steps, card against CPU, in float32 and in float64: (loss and
# running statistics relative, trace relative to its largest value, absolute
# floor). The trace (the clipped gradient) is the ill-conditioned part:
# train-mode BatchNorm makes float32 gradients differ by percents between
# two correct implementations (on the CPU, JAX's own float32 gradients
# differ from its float64 ones by 10-20% of a leaf's largest value at
# 64-128 px, tests/test_torch_train_step.py), and cuDNN's backward sums in
# its own order; float64 shows whether the card computes the same step.
# Parameters and EMA move by lr * trace in the second step (lr(0) = 0), so
# their bound is the floor plus lr times the trace's. The augmented batch:
# images within 1e-3, boxes within 1e-4, valid exact.
# bfloat16 (phase 14 (e)), on the CPU's batch: (loss relative; factor and
# floor of a group's bound). cuDNN's and the CPU's bf16 convolutions
# accumulate in float32 in their own order, so an output can round to a
# neighbouring bf16 value (2^-8 relative), which the later layers carry; on
# the CPU the port's bf16 loss is within 1e-2 of JAX's for the same reason
# (tests/test_torch_train_bf16.py). Leaf by leaf the gradients are not
# comparable in bf16 (float32's ill-conditioning, fed 2^-8 instead of 2^-24
# perturbations: the first chip run of phase 14 found leaves differing by
# more than the trace's largest value), so each group (params, EMA,
# running statistics, trace) is held as one vector: its relative L2
# distance between the devices within twice the larger of the two
# devices' own bf16-against-float32 distances (two independent bf16
# roundings differ by about sqrt(2) times one), plus the floor.
TRAIN_BOUNDS = {"float32": (1e-4, 5e-2, 1e-5), "float64": (1e-9, 1e-7, 1e-12),
                "bfloat16": (3e-2, 2.0, 1e-6)}
TRAIN_CHECK_LR = 0.01
FREEZE = ("backbone", "fpn")
# Phase 14.
WEDGED_DEADLINE_S = 3.0
# r_y of the card's track against the analytic trajectory. The Kinovea flow
# smooths x and y with a trailing rolling mean of 5 frames, which lags the
# 32-frame sine by 2 frames: r = cos(2 pi 2 / 32) = 0.924 at best. The
# Qualisys flow does not smooth.
GT_R_Y_MIN = {"kinovea": 0.9, "qualisys": 0.99}


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


def _graph_ms(fn, reps: int) -> float:
    """Device time of one call without the host's share: ``reps`` calls are
    captured into one CUDA graph and the graph's replay is timed, so the
    launches follow each other on the card as fast as it takes them."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
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
    # Equal top scores inside one lane's candidates, in neighbouring lanes,
    # across warps of an image (255/256) and with the last slot.
    for i, j in TIE_PAIRS:
        pair = logits().clamp(max=4.0)
        pair[:, [i, j]] = 5.0
        cases.append((f"tie_{i}_{j}", pair, boxes(), {}))
    last = logits().clamp(max=4.0)
    last[:, K - 1] = 6.0
    cases.append(("winner_in_last_slot", last, boxes(), {}))
    ragged = logits(k=300).clamp(max=4.0)
    ragged[:, 288:] = 5.0  # ties in the last, partly filled group of candidates
    cases.append(("k300_ties_in_last_group", ragged, boxes(k=300), {}))
    cases.append(("all_equal", torch.full((BATCH, K), 1.5), boxes(), {}))
    # IoUs with the winner on, just above and just below 0.5: the band in
    # which the kernel takes the exact division.
    near = logits().clamp(max=4.0)
    near[:, 0] = 6.0
    near_boxes = boxes()
    near_boxes[:, 0] = torch.tensor([0.0, 0.0, 1.0, 1.0])
    steps = (torch.arange(K // 2 - 1) - K // 4).float() * 2.0 ** -24
    near_boxes[:, 1:K // 2, :2] = 0.0
    near_boxes[:, 1:K // 2, 2] = 0.5 + steps
    near_boxes[:, 1:K // 2, 3] = 1.0
    cases.append(("iou_on_threshold", near, near_boxes, {}))
    # Thresholds for which every decision takes the exact division.
    cases.append(("iou_threshold_0", logits(), boxes(), {"iou_threshold": 0.0}))
    cases.append(("iou_threshold_1e-4", logits(), boxes(), {"iou_threshold": 1e-4}))
    return [(n, lg.to(dev), bx.to(dev), kw) for n, lg, bx, kw in cases]


def _hold_nms(label, logits, boxes, **kw) -> float:
    """Kernel vs plain version on the card; returns the max abs difference."""
    import torch
    from vbt_tpu_torch.ops.nms_cuda import nms
    from vbt_tpu_torch.ops.postprocess import nms_plain

    want = nms_plain(logits, boxes, **kw)
    got = nms(logits, boxes, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"nms {label}: counts differ {got[0].tolist()} vs "
                             f"{want[0].tolist()}")
    ds = (got[1] - want[1]).abs().max().item()
    db = (got[2] - want[2]).abs().max().item()
    if not (ds <= SCORE_ATOL and db <= BOX_ATOL):
        raise AssertionError(f"nms {label}: scores differ by {ds}, boxes by {db}")
    print(f"nms vs plain [{label}]: counts equal (mean {want[0].float().mean().item():.2f}), "
          f"max |d score| {ds:.3g}, max |d box| {db:.3g}")
    return max(ds, db)


def _fused_blocks(ckpt, dtype, dev):
    """(name, FusedBlockParams on ``dev``, the f32 ``MBConvBlock``) for every
    block the turbo backbone fuses at the model's input size, with the
    checkpoint's weights folded as the served pipeline folds them."""
    from vbt_tpu_torch.models.efficientdet import EfficientDet
    from vbt_tpu_torch.models.turbo import TurboBackbone
    from vbt_tpu_torch.ops.fused_mbconv import FusedBlockParams
    from vbt_tpu_torch.runtime.checkpoint import load_checkpoint, load_into
    from vbt_tpu_torch.runtime.pipeline import resolve_model

    spec, path = resolve_model(ckpt)
    model = load_into(EfficientDet(spec), load_checkpoint(path)).eval()
    turbo = TurboBackbone(model.backbone, (spec.input_size, spec.input_size), dtype, dev)
    return [(name, step, getattr(model.backbone, name)) for _, name, step in turbo.steps
            if isinstance(step, FusedBlockParams)]


def _block_input(p, b, dtype, gen, dev):
    import torch

    cin = p.we.shape[1] if p.has_expand else p.wd.shape[0]
    return torch.randn(b, cin, p.h * p.w, generator=gen).to(dev, dtype)


def _odd_blocks(gen, dtype, dev):
    """Random blocks with ragged channels and non-square odd sizes: stride 2
    k5, stride 1 k3 with a residual, one without expand, and two with more
    input channels than the "mma" kernel takes (48)."""
    import torch
    from vbt_tpu_torch.ops.fused_mbconv import FusedBlockParams

    def r(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dt)

    out = []
    for label, cin, cmid, cout, h, w, k, s, expand in [
        ("odd_s2_k5", 5, 37, 7, 37, 23, 5, 2, True),
        ("odd_s1_k3_residual", 24, 144, 24, 19, 45, 3, 1, True),
        ("odd_no_expand", 16, 16, 16, 21, 13, 3, 1, False),
        ("odd_cin56", 56, 96, 24, 17, 11, 3, 2, True),
        ("odd_cin64_residual", 64, 96, 64, 17, 11, 3, 1, True),
    ]:
        p = FusedBlockParams(
            we=r(cmid, cin, scale=0.3, dt=dtype) if expand else None,
            be=r(cmid, 1) if expand else None, wd=r(cmid, k * k, scale=0.5), bd=r(cmid, 1),
            wp=r(cout, cmid, scale=0.2, dt=dtype), bp=r(cout, 1), h=h, w=w, kernel=k, stride=s,
            residual=s == 1 and cin == cout)
        out.append((label, p))
    return out


def _k2_variant(x, p, variant=None) -> str:
    """The kernel the launch plan sends this block to."""
    from vbt_tpu_torch.ops.fused_mbconv import launch_plan

    cmid, cout = p.wd.shape[0], p.wp.shape[0]
    return launch_plan(x.dtype, x.shape[1], cmid, cout, p.h, p.w, p.kernel, p.stride,
                       p.has_expand, variant).variant


def _channels_last(x, p):
    """(B, C, H*W) -> the same values as (B, C, H, W) in channels-last memory."""
    import torch

    return x.reshape(x.shape[0], x.shape[1], p.h, p.w).contiguous(
        memory_format=torch.channels_last)


def _hold_k2(label, x, p, dtype_name, variant=None) -> float:
    """Kernel vs plain version on the card; returns the max abs difference.
    The "mma" kernel is held on contiguous and on channels-last input, and
    the two layouts must give the same values bit for bit."""
    import torch
    from vbt_tpu_torch.ops.fused_mbconv import fused_mbconv, fused_mbconv_plain

    got = fused_mbconv(x, p, variant)
    torch.cuda.synchronize()
    want = fused_mbconv_plain(x, p).float()
    served = _k2_variant(x, p, variant)
    label = f"{label} {served}"
    if served == "mma":
        got_cl = fused_mbconv(_channels_last(x, p), p, variant)
        torch.cuda.synchronize()
        if got_cl.stride(1) != 1 or not torch.equal(got_cl, got):
            raise AssertionError(f"fused_mbconv {label}: channels-last and contiguous input "
                                 f"disagree (output strides {got_cl.stride()})")
    got = got.float()
    diff = (got - want).abs()
    tol = K2_TOL[dtype_name]
    worst = (diff / (1.0 + want.abs())).max().item()
    if not torch.isfinite(got).all() or worst > tol:
        raise AssertionError(f"fused_mbconv {label} {dtype_name}: |d| / (1 + |want|) reaches "
                             f"{worst:.3g} > {tol} (max |d| {diff.max().item():.3g})")
    print(f"fused_mbconv vs plain [{label} {dtype_name} B={x.shape[0]} {p.h}x{p.w} "
          f"k{p.kernel} s{p.stride}]: max |d| {diff.max().item():.3g}, "
          f"max |d|/(1+|want|) {worst:.3g}")
    return diff.max().item()


def _k2_work(x, p) -> tuple[int, int, int]:
    """(bytes, 1x1 flops, depthwise flops) one fused block needs: x read
    once, weights read once, the output written once; the expand over every
    input position, the depthwise and project over every output position."""
    b = x.shape[0]
    cmid, cout = p.wd.shape[0], p.wp.shape[0]
    cin = x.shape[1]
    ho, wo = p.out_hw
    weights = [t for t in (p.we, p.be, p.wd, p.bd, p.wp, p.bp) if t is not None]
    n_bytes = (x.numel() + b * cout * ho * wo) * x.element_size()
    n_bytes += sum(t.numel() * t.element_size() for t in weights)
    mm = 2 * b * (p.h * p.w * cin * cmid * p.has_expand + ho * wo * cmid * cout)
    dw = 2 * b * ho * wo * cmid * p.kernel ** 2
    return n_bytes, mm, dw


def _candidates(pipe, frames):
    """The NMS kernel's inputs on the main path for one frame batch."""
    from vbt_tpu_torch.ops.postprocess import gather_decode, top_k_candidates

    deltas, logits = pipe.forward(frames)
    top_logits, idx = top_k_candidates(logits[..., 0].float(), K)
    boxes = gather_decode(deltas, pipe.anchors, idx, pipe.spec.input_size)
    return top_logits.contiguous(), boxes.contiguous()


def _k3_cfg(kind="ocsort", **kw):
    from vbt_tpu_torch.tracking.scan import ScanTrackerConfig

    return getattr(ScanTrackerConfig, kind)(**kw)


def _hold_k3(label, cfg, dets, det_valid, frame_valid, skip=True) -> float:
    """K3 on the card against its plain version on CPU copies of the same
    float32 inputs ((C, T, D, 6) numpy). Returns the max abs difference of
    boxes and dxdy on reported rows."""
    import torch
    from vbt_tpu_torch.runtime.batch_runner import track_clips

    arrays = [torch.from_numpy(np.ascontiguousarray(a)) for a in
              (dets.astype(np.float32), det_valid, frame_valid)]
    got = track_clips(cfg, *(a.cuda() for a in arrays), skip_empty_frames=skip)
    torch.cuda.synchronize()
    want = track_clips(cfg, *arrays, skip_empty_frames=skip)
    rep = want.report
    if not torch.equal(got.report.cpu(), rep):
        raise AssertionError(f"track_scan {label}: report differs in "
                             f"{int((got.report.cpu() != rep).sum())} slots")
    for field in ("track_id", "conf"):
        if not torch.equal(getattr(got, field).cpu()[rep], getattr(want, field)[rep]):
            raise AssertionError(f"track_scan {label}: {field} differs")
    db = (got.box.cpu()[rep] - want.box[rep]).abs().max().item() if rep.any() else 0.0
    dd = (got.dxdy.cpu()[rep] - want.dxdy[rep]).abs().max().item() if rep.any() else 0.0
    if not (db <= K3_BOX_ATOL and dd <= K3_DXDY_ATOL):
        raise AssertionError(f"track_scan {label}: boxes differ by {db}, dxdy by {dd}")
    print(f"track_scan vs plain [{label}]: C={dets.shape[0]} T={dets.shape[1]} "
          f"D={dets.shape[2]} S={cfg.max_tracks}, {int(rep.sum())} reported rows, ids equal "
          f"({sorted(set(got.track_id.cpu()[rep].tolist()))[:12]}), "
          f"max |d box| {db:.3g}, max |d dxdy| {dd:.3g}")
    return max(db, dd)


def _hold_k3_scenes() -> float:
    """Phase 3, K3: every test scene, then four ragged clips in one launch
    against the plain version and against one launch per clip, bit for bit."""
    import torch
    from vbt_tpu_torch.io.synthetic import ragged_clips, tracker_cases
    from vbt_tpu_torch.runtime.batch_runner import pad_clips, track_clips
    from vbt_tpu_torch.tracking.scan import track_video

    err = 0.0
    for name, (kind, kw, (dets, valid), skip) in tracker_cases().items():
        err = max(err, _hold_k3(name, _k3_cfg(kind, **kw), dets[None], valid[None],
                                np.ones((1, dets.shape[0]), bool), skip))
    cfg = _k3_cfg(max_age=10, asso="diou", iou_threshold=0.1, max_tracks=8)
    clips = ragged_clips()
    arrays = pad_clips([d.astype(np.float32) for d, _ in clips], [v for _, v in clips])
    err = max(err, _hold_k3("4 ragged clips", cfg, *arrays))
    batched = track_clips(cfg, *(torch.from_numpy(a).cuda() for a in arrays))
    for i, (d, v) in enumerate(clips):
        single = track_video(cfg, torch.from_numpy(d.astype(np.float32)).cuda(),
                             torch.from_numpy(v).cuda())
        t = d.shape[0]
        if not all(torch.equal(b[i, :t], o) for b, o in zip(batched, single)):
            raise AssertionError(f"track_scan: clip {i} of 4 differs from its own launch")
        if batched.report[i, t:].any():
            raise AssertionError(f"track_scan: padding frames of clip {i} report")
    print("track_scan: 4 ragged clips in one launch equal 4 single-clip launches bit for bit")
    return err


def _splits(t: int) -> dict[str, list[int]]:
    """Chunk lengths that cover t frames: 7 a chunk, 64 a chunk, uneven."""
    def equal(n):
        return [n] * (t // n) + ([t % n] if t % n else [])

    third = max(1, t // 3)
    uneven = [third + 5, 1, third - 4] if t > 2 * third + 2 else [t]
    return {"7": equal(7), "64": equal(64), "uneven": uneven + ([t - sum(uneven)]
                                                              if t > sum(uneven) else [])}


def _assert_k3_state(label, got, want, exact: bool) -> float:
    """TrackerState ``got`` (on the card) against ``want`` (CPU): integer and
    bool fields exact; float fields bit for bit (``exact``) or positions
    within K3_BOX_ATOL, Kalman velocities within K3_DXDY_ATOL and
    covariances within it relative to 1 + |want|. Returns the largest
    difference of positions and velocities."""
    import torch

    worst = 0.0
    for name, g, w in zip(want._fields, got, want):
        g, w = g.cpu(), w.cpu()
        if exact or not w.dtype.is_floating_point:
            if not torch.equal(g, w):
                raise AssertionError(f"{label}: state.{name} differs")
            continue
        d = (g - w).abs()
        if name in ("p", "frozen_p"):
            ok = bool((d <= K3_DXDY_ATOL * (1 + w.abs())).all())
        elif name in ("x", "frozen_x"):
            ok = d[..., :4].max().item() <= K3_BOX_ATOL and d[..., 4:].max().item() <= K3_DXDY_ATOL
            worst = max(worst, d.max().item())
        else:
            ok = d.max().item() <= K3_BOX_ATOL
            worst = max(worst, d.max().item())
        if not ok:
            raise AssertionError(f"{label}: state.{name} differs from the plain version's by "
                                 f"{d.max().item():.3g}")
    return worst


def _hold_k3_chunks(label, cfg, dets, valid, skip=True) -> float:
    """K3 chunk by chunk with the state carried against one launch, bit for
    bit (outputs and final state), for each split of :func:`_splits`; the
    final state against the plain version's (CPU copies). ``dets`` (T, D, 6)."""
    import torch
    from vbt_tpu_torch.ops.track_scan_cuda import track_scan
    from vbt_tpu_torch.tracking.scan import init_state, scan_clips_plain

    d = torch.from_numpy(np.ascontiguousarray(dets, np.float32))[None]
    v = torch.from_numpy(np.ascontiguousarray(valid))[None]
    f = torch.ones(d.shape[:2], dtype=torch.bool)
    t = d.shape[1]
    whole_state, whole = track_scan(cfg, d.cuda(), v.cuda(), f.cuda(), skip, return_state=True)
    for name, sizes in _splits(t).items():
        state, parts, a = init_state(cfg, 1, torch.float32, "cuda"), [], 0
        for n in sizes:
            chunk = [x[:, a:a + n].contiguous().cuda() for x in (d, v, f)]
            state, out = track_scan(cfg, *chunk, skip, state=state, return_state=True)
            parts.append(out)
            a += n
        for i, field in enumerate(whole):
            if not torch.equal(torch.cat([p[i] for p in parts], dim=1), field):
                raise AssertionError(f"track_scan {label}: chunks of {name} differ from one "
                                     f"launch in output {i}")
        _assert_k3_state(f"track_scan {label}, chunks of {name}", state, whole_state, exact=True)
    torch.cuda.synchronize()
    plain_state, _ = scan_clips_plain(cfg, d, v, f, skip, return_state=True)
    err = _assert_k3_state(f"track_scan {label}", whole_state, plain_state, exact=False)
    print(f"track_scan in chunks [{label}]: T={t} D={d.shape[2]} S={cfg.max_tracks}: chunks of "
          f"7, 64 and {_splits(t)['uneven']} with the state carried equal one launch bit for "
          f"bit, final state included; final state vs plain: integer fields equal, max |d| "
          f"positions and velocities {err:.3g}")
    return err


def _hold_k3_chunk_scenes() -> float:
    from vbt_tpu_torch.io.synthetic import tracker_cases

    return max(_hold_k3_chunks(name, _k3_cfg(kind, **kw), dets, valid, skip)
               for name, (kind, kw, (dets, valid), skip) in tracker_cases().items())


def _hold_relay(cfg, dets, valid) -> int:
    """The time-shard relay over [cuda:0] * 4 against one launch, bit for
    bit. Returns the relay's K3 launches."""
    import torch
    from vbt_tpu_torch.ops.track_scan_cuda import track_scan
    from vbt_tpu_torch.parallel.time_shard import track_video_time_sharded
    from vbt_tpu_torch.tracking.scan import track_video

    d = torch.from_numpy(np.ascontiguousarray(dets, np.float32))
    v = torch.from_numpy(np.ascontiguousarray(valid))
    for t in (d.shape[0], d.shape[0] - 3):  # 4 equal chunks, then padded ones
        whole = track_video(cfg, d[:t].cuda(), v[:t].cuda())
        before = track_scan.launches
        relay = track_video_time_sharded(cfg, d[:t], v[:t], [torch.device("cuda", 0)] * 4)
        launches = track_scan.launches - before
        if not all(torch.equal(a, b.cpu()) for a, b in zip(relay, whole)):
            raise AssertionError(f"time-shard relay over 4 chunks differs from one launch (T={t})")
    print(f"time shard: the relay over [cuda:0] * 4 ({launches} K3 launches, T = {d.shape[0]} "
          f"and {d.shape[0] - 3}) equals one launch bit for bit")
    return launches


def _follow_series(data, follow_id: int = 1) -> list[np.ndarray]:
    """The followed id's raw samples as the stream feeds K4: time, x, y, dy,
    norm_plate_height, norm_plate_width."""
    ids = np.asarray(data["id"])
    return [np.asarray(data[c], np.float64)[ids == follow_id]
            for c in ("time", "x", "y", "dy", "norm_plate_height", "norm_plate_width")]


def _fuzz_series(n: int, seed: int = 7) -> list[np.ndarray]:
    """A noisy sinusoidal bar path (the fuzz of tests/test_velocity_jax.py)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FPS
    y = 0.5 + 0.2 * np.sin(2 * np.pi * 0.4 * t) + rng.normal(0, 0.002, n)
    x = 0.4 + rng.normal(0, 0.005, n)
    return [t, x, y, np.gradient(y), np.full(n, 0.16) + rng.normal(0, 0.01, n),
            np.full(n, 0.28) + rng.normal(0, 0.01, n)]


def _rel_diff(got, want) -> float:
    """The largest |got - want| / |want| over entries that differ (0 where
    equal, infinities included); integer fields must be equal."""
    import torch

    got = got.cpu()
    if not want.dtype.is_floating_point:
        return 0.0 if torch.equal(got, want) else float("inf")
    differ = got != want
    if not differ.any():
        return 0.0
    return ((got - want).abs() / want.abs())[differ].max().item()


def _hold_k4(label, cols, chunk) -> float:
    """K4 on the card chunk by chunk against its plain version on CPU copies,
    both carries carried: every event and both carries within K4_RTOL
    relative. Returns the largest absolute difference."""
    import torch
    from vbt_tpu_torch.analysis.smoother_scan import initial_smoother
    from vbt_tpu_torch.analysis.velocity_torch import initial_carry
    from vbt_tpu_torch.ops.analysis_scan_cuda import analysis_chunk_plain, analysis_scan

    cols = [torch.from_numpy(np.ascontiguousarray(c, np.float64)) for c in cols]
    pd_cpu = torch.tensor(PLATE_DIAMETER, dtype=torch.float64)
    got = (initial_smoother(device="cuda"), initial_carry(device="cuda"))
    want = (initial_smoother(), initial_carry())
    rel = err = 0.0
    fired = 0
    for i in range(0, cols[0].shape[0], chunk):
        part = [c[i:i + chunk].contiguous() for c in cols]
        *got, got_ev = analysis_scan(pd_cpu.cuda(), *got, [c.cuda() for c in part])
        *want, want_ev = analysis_chunk_plain(pd_cpu, *want, part)
        pairs = list(zip(got_ev, want_ev)) + [p for g, w in zip(got, want) for p in zip(g, w)]
        for g, w in pairs:
            rel = max(rel, _rel_diff(g, w))
            if w.dtype.is_floating_point:
                finite = torch.isfinite(w)
                if finite.any():
                    err = max(err, (g.cpu() - w)[finite].abs().max().item())
        fired += int(want_ev.fired.sum())
    print(f"analysis_scan vs plain [{label}, chunks of {chunk}]: {cols[0].shape[0]} samples, "
          f"{fired} phase ends; events and carries: max relative difference {rel:.3g}, max "
          f"|d| {err:.3g}")
    if rel > K4_RTOL:
        raise AssertionError(f"analysis_scan {label}: differs from the plain version by {rel} "
                             f"relative")
    return err


def _stream_path(pipe, frames, kernels, offline) -> dict:
    """Phase 10: the stream over ``frames`` in chunks, every count at 0
    before and read after; its final phases against the offline lane's."""
    import torch
    from vbt_tpu_torch.cli.stream import LiveReps
    from vbt_tpu_torch.runtime.streaming import StreamingPipeline

    warm = StreamingPipeline(pipe, fps=FPS)  # first launches of this chunk shape
    warm.process_frames(frames[:STREAM_CHUNK])
    warm.phases()
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    stream = StreamingPipeline(pipe, fps=FPS, plate_diameter=PLATE_DIAMETER)
    live = LiveReps(sys.stdout)
    print(f"stream [xla]: {len(frames)} frames in chunks of {STREAM_CHUNK}, live lines:")
    t0 = time.perf_counter()
    for i in range(0, len(frames), STREAM_CHUNK):
        stream.process_frames(frames[i:i + STREAM_CHUNK])
        live.update(stream.phases(include_open=False))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    phases = stream.phases()
    live.summary(phases)
    n_chunks = -(-len(frames) // STREAM_CHUNK)
    want = {"nms": n_chunks, "fused_mbconv": 0, "track_scan": n_chunks,
            "analysis_scan": n_chunks}
    print(f"stream [xla]: launches {launches}")
    if launches != want:
        raise AssertionError(f"stream: launches {launches}, want {want}")
    same = len(phases) == len(offline) and all(
        a.type == b.type and abs(a.time_start - b.time_start) <= 1e-9
        and abs(a.time_end - b.time_end) <= 1e-9 and abs(a.rom - b.rom) <= 1e-9 * abs(b.rom)
        for a, b in zip(phases, offline))
    if not same:
        raise AssertionError(f"stream: phases {phases} differ from the offline lane's {offline}")
    rom_rel = max(abs(a.rom - b.rom) / abs(b.rom) for a, b in zip(phases, offline))
    spans = {name: stream.timer.totals[name] / stream.timer.counts[name] * 1e3
             for name in ("detect", "track", "select", "analysis", "phases")}
    print(f"stream [xla]: {len(phases)} phases equal the offline lane's (types and times exact "
          f"to 1e-9, max relative ROM difference {rom_rel:.3g}); {len(frames) / wall:.1f} "
          f"frames/s ({wall:.3f} s); per chunk, host clock, ms: "
          + ", ".join(f"{n} {v:.3f}" for n, v in spans.items()))
    return {"fps": len(frames) / wall, "launches": launches, "spans_ms": spans}


def _compare_track_data(lane, scan, host, host_name="OC-SORT") -> float:
    """The scan tracker's and the host tracker's columnar capture dicts: the
    same ids, times and row order; positions and plate sizes within
    ROW_ATOL, dx/dy within HOST_DXDY_ATOL. Returns the max |d dx/dy|."""
    if scan["id"] != host["id"] or scan["time"] != host["time"]:
        raise AssertionError(f"{lane}: scan and host trackers give other rows or ids "
                             f"({len(scan['id'])} vs {len(host['id'])} rows)")
    err = {c: float(np.abs(np.subtract(scan[c], host[c])).max()) if scan[c] else 0.0
           for c in ("x", "y", "norm_plate_height", "norm_plate_width", "dx", "dy")}
    row_err, dxdy_err = max(err[c] for c in list(err)[:4]), max(err["dx"], err["dy"])
    print(f"main path [{lane}]: scan (K3, float32) vs host {host_name} (float64): "
          f"{len(scan['id'])} rows, ids equal, max |d| x/y/plate {row_err:.3g}, "
          f"dx/dy {dxdy_err:.3g}")
    if row_err > ROW_ATOL or dxdy_err > HOST_DXDY_ATOL:
        raise AssertionError(f"{lane}: scan and host dataframes differ: {err}")
    return dxdy_err


def _track_series(data) -> list[np.ndarray]:
    """The plotted track's raw series (the id with the most rows)."""
    ids = np.asarray(data["id"])
    tid = max(set(data["id"]), key=data["id"].count)
    cols = ("time", "x", "y", "dx", "dy", "norm_plate_height", "norm_plate_width")
    return [np.asarray(data[c], np.float64)[ids == tid] for c in cols]


def _same_phases(got, want) -> bool:
    """Phase 4's bounds: the same phases, type and times exact, positions and
    ROM within ``PHASE_RTOL`` relative."""
    return len(got) == len(want) and all(
        (a.type, a.time_start, a.time_end) == (b.type, b.time_start, b.time_end)
        and all(abs(getattr(a, f) - getattr(b, f)) <= PHASE_RTOL * abs(getattr(b, f))
                for f in ("y_start", "y_end", "rom"))
        for a, b in zip(got, want))


def _analyse(lane, data):
    """The plot CLI's analysis of the scan dataframe in both engines: host
    (numpy float64 smoothing and the VelocityTracker) and torch on the card
    (presmoothing included). Returns (phases, host s, torch s)."""
    import torch
    from vbt_tpu_torch.analysis.phase import CONCENTRIC
    from vbt_tpu_torch.analysis.smoothing import expanding_mean_np, rolling_mean_np
    from vbt_tpu_torch.analysis.velocity import VelocityTracker
    from vbt_tpu_torch.analysis.velocity_torch import analyze_series, to_phase_list
    from vbt_tpu_torch.io.synthetic import PLATE_AMPLITUDE, PLATE_RADIUS

    series = _track_series(data)
    t0 = time.perf_counter()
    t, x, y, dx, dy, h, w = series
    smoothed = [t, *(rolling_mean_np(a, 5) for a in (x, y, dx, dy)),
                expanding_mean_np(h), expanding_mean_np(w)]
    vt = VelocityTracker(PLATE_DIAMETER)
    for row in zip(*smoothed):
        vt.process_measurements(*row)
    vt.end_processing()
    host = vt.phases
    t1 = time.perf_counter()
    on_card = to_phase_list(analyze_series(*series, plate_diameter=PLATE_DIAMETER,
                                           device="cuda"))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not _same_phases(on_card, host):
        raise AssertionError(f"{lane}: the analysis engines disagree: host {host}, "
                             f"torch {on_card}")
    reps = [p for p in host if p.type == CONCENTRIC]
    # The disc's center travels 2 * amplitude of the frame height in half a
    # period; the plate's box is 2 * radius high, which the analysis scales
    # to the plate diameter.
    rom = 2 * PLATE_AMPLITUDE / (2 * PLATE_RADIUS) * PLATE_DIAMETER
    acv = rom / (PERIOD / 2 / FPS)
    print(f"main path [{lane}]: analysis host {t1 - t0:.3f} s, torch on the card "
          f"{t2 - t1:.3f} s: {len(host)} phases, the same in both engines, "
          f"{len(reps)} concentric; analytic ROM {rom:.4f} m, ACV {acv:.4f} m/s (disc "
          f"{2 * PLATE_RADIUS:.2f} of the frame high; the boxes' mean height "
          f"{h.mean():.4f}); per rep "
          + ", ".join(f"ROM {p.rom:.4f} ACV {p.rom / p.duration:.4f}" for p in reps))
    if len(reps) < 4:
        raise AssertionError(f"{lane}: {len(reps)} concentric phases, want at least 4")
    return host, t1 - t0, t2 - t1


def _detect_all(pipe, frames, pageable: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """``detect_batch`` over every 64-frame batch, all queued on the card
    before the first readback (``collect_detections`` queues up to 8), then
    the tracker rows. ``pageable`` composes the path before the staging
    ring from the pipeline's stages: a pageable ``.to()`` of each batch."""
    import torch
    from vbt_tpu_torch.ops.preprocess import preprocess_frames

    dets = []
    for i in range(0, len(frames), BATCH):
        batch = frames[i:i + BATCH]
        if pageable:
            with torch.inference_mode():
                x = torch.from_numpy(batch).to(pipe.device, non_blocking=True)
                images = preprocess_frames(x, pipe.spec.input_size, pipe.dtype)
                dets.append(pipe.postprocess(*pipe.run_model(images)))
        else:
            dets.append(pipe.detect_batch(batch))
    out = [pipe.detections_to_tracker_inputs(d, 0.5) for d in dets]
    return np.concatenate([r for r, _ in out]), np.concatenate([v for _, v in out])


def _main_path(lane, pipe, frames, kernels, want_launches) -> dict:
    """Drive one backbone's main path with every count at 0; check the
    launches, the two trackers' dataframes and the analysis. Returns the
    detect frames/s, the launches by kernel and the tracker inputs."""
    import torch
    from vbt_tpu_torch.cli.track import run_host_tracker, run_scan_tracker, tracks_to_data

    if pipe.dtype != torch.bfloat16 or not pipe.use_kernel:
        raise AssertionError(f"{lane}: served lane is {pipe.dtype}, use_kernel={pipe.use_kernel}")
    pipe.detect_batch(frames[:BATCH])  # warm-up: cuDNN plans, first launches
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    by_variant = kernels["fused_mbconv"].launches_by_variant
    for variant in by_variant:
        by_variant[variant] = 0
    t0 = time.perf_counter()
    rows, valid = _detect_all(pipe, frames)
    t_detect = time.perf_counter() - t0
    t1 = time.perf_counter()
    tracks = run_scan_tracker(rows, valid, pipe.device)  # K3; reads the result back
    t_scan = time.perf_counter() - t1
    t1 = time.perf_counter()
    host_tracks = run_host_tracker(rows, valid)
    t_host = time.perf_counter() - t1
    data = tracks_to_data(tracks, fps=FPS)
    dxdy_err = _compare_track_data(lane, data, tracks_to_data(host_tracks, fps=FPS))
    phases = _analyse(lane, data)[0]
    launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"main path [{lane}]: launches {launches}")
    if launches != want_launches:
        raise AssertionError(f"{lane}: launches {launches}, want {want_launches}")
    # Every fused block of the served bf16 lane goes through the tensor-core kernel.
    if by_variant != {"mma": want_launches["fused_mbconv"], "fma": 0}:
        raise AssertionError(f"{lane}: fused MBConv launches by kernel {by_variant}")
    if rows.shape != (BATCH * BATCHES, D, 6) or not np.isfinite(rows).all():
        raise AssertionError(f"{lane}: tracker rows {rows.shape} not finite or misshapen")
    if not valid[:, 0].all():
        raise AssertionError(f"{lane}: the plate was missed in {int((~valid[:, 0]).sum())} frames")
    n_rows = len(data["id"])
    if n_rows < BATCH * BATCHES - 2 or not all(np.isfinite(data[c]).all() for c in data):
        raise AssertionError(f"{lane}: track data has {n_rows} rows or non-finite values")
    print(f"main path [{lane}]: {frames.shape[0]} frames, {n_rows} track rows, ids "
          f"{sorted(set(data['id']))}; detect {t_detect:.3f} s "
          f"({frames.shape[0] / t_detect:.1f} frames/s), scan tracker (K3) {t_scan:.4f} s, "
          f"host OC-SORT {t_host:.3f} s")
    return {"fps": frames.shape[0] / t_detect, "launches": launches, "rows": rows,
            "valid": valid, "dxdy_vs_host": dxdy_err, "phases": phases, "data": data}


def _stage_spans(pipe, frames) -> dict:
    """Where one ``detect_batch`` of ``frames`` goes through the pinned ring,
    in ms: the host's fill of a staging buffer (host clock), the copy on the
    copy stream, the compute stream's wait for it, then the compute stream's
    stages (CUDA events, no synchronisation between stages, so a span
    includes any time the card waited for the host to launch its work)."""
    import torch
    from vbt_tpu_torch.ops.nms_cuda import nms
    from vbt_tpu_torch.ops.postprocess import gather_decode, top_k_candidates
    from vbt_tpu_torch.ops.preprocess import preprocess_frames

    ring = pipe.staging(frames.shape)
    names = ["wait", "preprocess", "forward", "topk+decode", "nms", "readback"]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    copy = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    with torch.inference_mode():
        t0 = time.perf_counter()
        buf = ring.fill(frames)
        fill_ms = (time.perf_counter() - t0) * 1e3
        events[0].record()
        copy[0].record(ring.copy_stream)
        x = ring.upload(buf)
        copy[1].record(ring.copy_stream)
        events[1].record()  # after the compute stream's wait for the copy
        images = preprocess_frames(x, pipe.spec.input_size, pipe.dtype)
        events[2].record()
        deltas, logits = pipe.run_model(images)
        events[3].record()
        top_logits, idx = top_k_candidates(logits[..., 0].float(), K)
        boxes = gather_decode(deltas, pipe.anchors, idx, pipe.spec.input_size)
        events[4].record()
        out = nms(top_logits.contiguous(), boxes.contiguous())
        events[5].record()
        [t.cpu() for t in out]
        events[6].record()
    torch.cuda.synchronize()
    spans = {"fill (host)": fill_ms, "upload (copy stream)": copy[0].elapsed_time(copy[1])}
    spans.update({n: events[i].elapsed_time(events[i + 1]) for i, n in enumerate(names)})
    return spans


def _upload_compare(lane, pipe, frames) -> None:
    """The upload before the staging ring against the ring, in one run: one
    batch's copy alone (pageable ``.to()`` against the pinned buffer's
    non-blocking copy), then the whole detect loop composed both ways, in
    turns (pageable, ring, ring, pageable)."""
    import torch

    batch = frames[:BATCH]
    host = torch.from_numpy(batch)
    pageable = _cuda_ms(lambda: host.to("cuda"), reps=3, warmup=1)
    pinned_buf = pipe.staging(batch.shape).buffers[0]
    pinned = _cuda_ms(lambda: pinned_buf.to("cuda", non_blocking=True), reps=3, warmup=1)
    mb = batch.nbytes / 1e6
    fps = {True: [], False: []}
    for use_pageable in (True, False, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _detect_all(pipe, frames, pageable=use_pageable)
        fps[use_pageable].append(len(frames) / (time.perf_counter() - t0))
    print(f"upload [{lane}] of one batch ({mb:.1f} MB uint8): pageable .to() {pageable:.3f} ms "
          f"({mb / pageable:.2f} GB/s), pinned non-blocking copy {pinned:.3f} ms "
          f"({mb / pinned:.2f} GB/s); detect loop over {len(frames)} frames, frames/s: "
          f"pageable {fps[True][0]:.1f} {fps[True][1]:.1f}, ring {fps[False][0]:.1f} "
          f"{fps[False][1]:.1f}")


def _profile(lane, pipe, frames) -> None:
    """The device's busy share and its time by kernel over the detect loop
    of ``frames`` (:func:`_detect_all`), from the device events of
    ``torch.profiler`` (the host clock inside the profiled region, which the
    profiler's own per-op cost lengthens, is the window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _detect_all(pipe, frames)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith("Activity Buffer")]
    if not spans:
        print(f"profile [{lane}]: the profiler recorded no device time (not measured)")
        return
    busy_us, end = 0.0, float("-inf")
    by_name: dict[str, list] = {}
    for start, stop, name in sorted(spans):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += stop - start
        acc[1] += 1
    print(f"profile [{lane}] over {len(frames) // BATCH} batches: host window {wall_us / 1e3:.2f} ms, "
          f"device busy {busy_us / 1e3:.2f} ms, idle share {1 - busy_us / wall_us:.3f}")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {us / 1e3:9.3f} ms {us / busy_us:6.1%} x{n:<5d} {name[:90]}")


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ptxas", action="store_true",
                        help="build with -Xptxas -v and print the compiler's report")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from vbt_tpu_torch.io.synthetic import plate_frames
    from vbt_tpu_torch.ops import _build
    from vbt_tpu_torch.ops.analysis_scan_cuda import analysis_scan
    from vbt_tpu_torch.ops.fused_mbconv import fused_mbconv
    from vbt_tpu_torch.ops.nms_cuda import nms
    from vbt_tpu_torch.ops.track_scan_cuda import track_scan
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline
    from vbt_tpu_torch.utils.cache import enable_persistent_cache
    from vbt_tpu_torch.utils.device import resolve_device

    t_all = time.perf_counter()
    # 1. The card.
    dev = resolve_device("cuda")  # also the f32 policy: TF32 off for matmul and cuDNN
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(_nvidia_smi())

    # 2. Build every kernel of the path.
    t0 = time.perf_counter()
    build_dir = enable_persistent_cache()
    built = _build.build_all(_build.PTXAS_VERBOSE if args.ptxas else ())
    print(f"built {built} in {time.perf_counter() - t0:.2f} s into {build_dir}")
    if args.ptxas:
        for name in built:
            print(f"nvcc -Xptxas -v csrc/{name}.cu:\n{_build.build_log[name]}")

    # 3. Each kernel vs its plain version at the main-path shapes.
    gen = torch.Generator().manual_seed(0)
    nms_err = 0.0
    for label, logits, boxes, kw in _nms_cases(gen, dev):
        nms_err = max(nms_err, _hold_nms(label, logits, boxes, **kw))
    k2_err = {"float32": 0.0, "bfloat16": 0.0}
    k2_timing_inputs = []  # lite0's fused blocks in bf16 at B = 64, timed in phase 6
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        groups = [("lite0", BATCH, _fused_blocks(CKPT, dtype, dev)),
                  ("lite2", LITE2_BATCH, _fused_blocks(LITE2_CKPT, dtype, dev))]
        for model, b, blocks in groups:
            for name, p, block in blocks:
                x = _block_input(p, b, dtype, gen, dev)
                err = _hold_k2(f"{model} {name}", x, p, dtype_name)
                k2_err[dtype_name] = max(k2_err[dtype_name], err)
                if model == "lite0" and dtype == torch.bfloat16:
                    k2_timing_inputs.append((name, x, p, block))
        for label, p in _odd_blocks(gen, dtype, dev):
            x = _block_input(p, 3, dtype, gen, dev)
            k2_err[dtype_name] = max(k2_err[dtype_name], _hold_k2(label, x, p, dtype_name))

    k3_err = _hold_k3_scenes()

    # 4. The main path, bf16 on the card, each backbone with the counts at 0.
    t0 = time.perf_counter()
    frames = plate_frames(BATCH * BATCHES, HEIGHT, WIDTH, seed=0, period=PERIOD)
    print(f"made {frames.shape[0]} frames {HEIGHT}x{WIDTH} in {time.perf_counter() - t0:.2f} s")
    kernels = {"nms": nms, "fused_mbconv": fused_mbconv, "track_scan": track_scan,
               "analysis_scan": analysis_scan}
    pipe = DetectionPipeline.from_model_arg(CKPT, device="cuda")
    small = frames[:BATCH]
    xla = _main_path("xla", pipe, frames, kernels,
                     {"nms": BATCHES, "fused_mbconv": 0, "track_scan": 1, "analysis_scan": 0})
    turbo = DetectionPipeline.from_model_arg(CKPT, device="cuda", backbone="turbo")
    n_fused = len(turbo.turbo.fused_names)
    turbo_run = _main_path("turbo", turbo, frames, kernels,
                           {"nms": BATCHES, "fused_mbconv": n_fused * BATCHES, "track_scan": 1,
                            "analysis_scan": 0})
    print(f"detect throughput, bf16, B = {BATCH}: xla {xla['fps']:.1f} frames/s, turbo "
          f"{turbo_run['fps']:.1f} frames/s ({n_fused} fused blocks: {turbo.turbo.fused_names})")
    # 3 (continued). K3 against its plain version on the main path's detections.
    cfg = _k3_cfg(max_age=30, asso="diou", iou_threshold=0.1, max_tracks=16)
    for lane, run in (("xla", xla), ("turbo", turbo_run)):
        k3_err = max(k3_err, _hold_k3(f"main path detections, {lane}", cfg, run["rows"][None],
                                      run["valid"][None], np.ones((1, len(run["rows"])), bool)))
    _compare_pipelines(pipe, turbo, small)

    records = _time_kernels(pipe, small, dev, nms_err, k2_err, k2_timing_inputs,
                            xla["launches"], turbo_run["launches"])
    print(f"whole run {time.perf_counter() - t_all:.1f} s")
    _where_the_time_goes(pipe, turbo, frames)

    # 8. The tracker carried across chunks, and the relay on one card.
    k3_chunk_err = _hold_k3_chunk_scenes()
    k3_chunk_err = max(k3_chunk_err, _hold_k3_chunks("main path detections, xla", cfg,
                                                     xla["rows"], xla["valid"]))
    relay_launches = _hold_relay(cfg, xla["rows"], xla["valid"])
    # 9. K4 against its plain version.
    series = _follow_series(xla["data"])
    k4_err = max(_hold_k4(label, cols, chunk)
                 for label, cols in (("main path followed track", series),
                                     ("fuzz series", _fuzz_series(300)))
                 for chunk in (7, STREAM_CHUNK))
    # 10. The stream.
    stream = _stream_path(pipe, frames, kernels, xla["phases"])
    records.append(_time_k3(cfg, xla, max(k3_err, k3_chunk_err), stream, relay_launches))
    records.append(_time_k4(series, k4_err, stream))
    # 11. int8.
    qpipe = _int8_lane(pipe, frames, kernels, xla)
    # 12. Evaluation, batch 1 an image, both lanes.
    _eval_lanes({"bf16": pipe, "int8": qpipe}, kernels)
    # 13. Training.
    records[0]["train_launches"] = _train_phase(kernels)
    # 14. The operational shell, the ground-truth CLIs and bf16 training.
    records[0]["probe_launches"], records[0]["trace_launches"] = _shell_phase(pipe, frames,
                                                                             kernels)
    # 15. Checkpoint selection and the host SORT.
    records[0]["tools_launches"], records[2]["sort_launches"] = _selection_phase(
        frames, xla, kernels)
    # 16. The plot CLI's analysis engines timed.
    _analysis_engines_phase(xla)
    # 17. The bench, the entry points and the measurement tools.
    records[0]["bench_launches"], records[1]["bench_launches"], records[0]["measure_launches"], \
        records[1]["measure_launches"] = _bench_phase(kernels)
    # 18. The data-parallel train step.
    dp = _dp_train_phase(kernels)
    for record in records:
        record["dp_train_launches"] = dp[record["name"]]
    # 19. The end-to-end tools.
    e2e = _e2e_tools_phase(kernels)
    for record in records:
        record["e2e_launches"] = e2e[record["name"]]
    print(f"whole run {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def _compare_pipelines(pipe, turbo, small) -> None:
    """Phase 5: bf16 vs f32 on the card; f32 card vs f32 CPU; f32 turbo vs f32 XLA."""
    import torch
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline

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
    turbo32 = DetectionPipeline.from_model_arg(CKPT, device="cuda", dtype=torch.float32,
                                               backbone="turbo")
    lt32 = turbo32.forward(small)[1]
    dt32, dt16 = turbo32.detect_batch(small), turbo.detect_batch(small)
    dl_turbo = (lt32 - l32).abs().max().item()
    db_turbo = (dt32.boxes[:, 0] - d32.boxes[:, 0]).abs().max().item()
    db_turbo16 = (dt16.boxes[:, 0] - d32.boxes[:, 0]).abs().max().item()
    print(f"f32 turbo vs f32 xla on the card: counts equal "
          f"{torch.equal(dt32.count, d32.count)}, max |d logit| {dl_turbo:.4g}, "
          f"max |d top box| {db_turbo:.4g}; bf16 turbo vs f32 xla: max |d top box| "
          f"{db_turbo16:.4g}")
    # Same f32 model, the fused blocks' sums in another order: the same bounds
    # as the card against the CPU.
    if not torch.equal(dt32.count, d32.count) or dl_turbo > 1e-3 or db_turbo > 1e-4:
        raise AssertionError("the f32 turbo pipeline disagrees with the f32 XLA pipeline")
    if db_turbo16 > 0.05:
        raise AssertionError("bf16 turbo top boxes drift more than 0.05 of the frame from f32")


def _time_kernels(pipe, small, dev, nms_err, k2_err, k2_timing_inputs, seen_xla,
                  seen_turbo) -> list[dict]:
    """Phase 6: kernel time at the main-path inputs, beside the plain version
    and the bound. Returns the kernels' records."""
    import torch
    from vbt_tpu_torch.ops.fused_mbconv import fused_mbconv, fused_mbconv_plain
    from vbt_tpu_torch.ops.nms_cuda import nms
    from vbt_tpu_torch.ops.postprocess import nms_plain

    logits_k, boxes_k = _candidates(pipe, small)
    nms_err = max(nms_err, _hold_nms("main_path_batch", logits_k, boxes_k))
    count = nms(logits_k, boxes_k)[0]
    # ms is the kernel's own time, the replay of a CUDA graph; the loop of eager
    # launches also holds the host's share of a launch (three allocations and a
    # ctypes call, 20-40 us on a shared host, more than the kernel takes).
    eager_ms = _cuda_ms(lambda: nms(logits_k, boxes_k), reps=200)
    ms = _graph_ms(lambda: nms(logits_k, boxes_k), reps=100)
    plain_ms = _cuda_ms(lambda: nms_plain(logits_k, boxes_k), reps=10)
    b, k = logits_k.shape
    n_bytes = (logits_k.numel() + boxes_k.numel()) * 4 + b * 4 + b * D * 4 * 5
    # sigmoid + area per candidate (7 ops); per round that selects, the
    # argmax compare and the IoU test per candidate (14 ops).
    n_ops = b * k * 7 + int(count.sum().item()) * k * 14
    byte_ms, op_ms = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    nms_record = {
        "name": "nms",
        "route": "cuda",
        "source": "vbt_tpu_torch/csrc/nms.cu",
        "replaces": "vbt_tpu/ops/nms_pallas.py:71",
        "launches": seen_xla["nms"],
        "max_abs_err": nms_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
        "library_ms": None,
        "timed": "ms: replay of a CUDA graph of 100 launches; eager_ms: a loop of 200 eager "
                 "launches, the host's share included",
        "eager_ms": eager_ms,
    }
    print(f"nms: {ms * 1e3:.2f} us/launch on the card (CUDA-graph replay), "
          f"{eager_ms * 1e3:.2f} us in a loop of eager launches, plain {plain_ms:.3f} ms, "
          f"bound {nms_record['bound_ms'] * 1e3:.3f} us ({nms_record['bound_by']})")

    shapes = []
    totals = dict.fromkeys(("ms", "fma_ms", "plain_ms", "unfused_ms", "bytes", "mm", "dw"), 0)
    for name, x, p, block in k2_timing_inputs:
        b = x.shape[0]
        variant = _k2_variant(x, p)
        # The FMA kernel on the same bf16 inputs, held like the served one, then
        # timed in turns with it: fma, served, served, fma.
        k2_err["bfloat16"] = max(k2_err["bfloat16"],
                                 _hold_k2(f"lite0 {name}", x, p, "bfloat16", variant="fma"))
        # The served kernel takes what the turbo backbone gives it:
        # channels-last memory for "mma", contiguous for "fma".
        x_served = _channels_last(x, p) if variant == "mma" else x
        turns = [_cuda_ms(lambda: fused_mbconv(x if v == "fma" else x_served, p, v), reps=20)
                 for v in ("fma", None, None, "fma")]
        ms, fma_ms = min(turns[1:3]), min(turns[0], turns[3])
        nchw_ms = _cuda_ms(lambda: fused_mbconv(x, p), reps=20)  # served kernel, contiguous x
        if ms > fma_ms:
            raise AssertionError(f"fused_mbconv {name}: the served {variant} kernel takes "
                                 f"{ms:.4f} ms, the fma kernel {fma_ms:.4f} ms")
        plain_ms = _cuda_ms(lambda: fused_mbconv_plain(x, p), reps=3, warmup=1)
        # The yardstick: the port's unfused block (cuDNN convs, BN, ReLU6) on
        # the same input, channels-last as the XLA lane runs it, and NCHW.
        unfused = copy.deepcopy(block).to(dev, torch.bfloat16)
        x4 = x.reshape(b, x.shape[1], p.h, p.w)
        x4_cl = x4.contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            unfused_ms = _cuda_ms(lambda: unfused(x4_cl), reps=20)
            unfused_nchw_ms = _cuda_ms(lambda: unfused(x4), reps=20)
        n_bytes, mm, dw = _k2_work(x, p)
        byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        op_ms = (mm / BF16_TENSOR_OPS_PER_S + dw / F32_OPS_PER_S) * 1e3
        cin, cmid, cout = x.shape[1], p.wd.shape[0], p.wp.shape[0]
        shapes.append({
            "block": name, "batch": b, "hw": [p.h, p.w], "channels": [cin, cmid, cout],
            "kernel": p.kernel, "stride": p.stride, "variant": variant, "ms": ms,
            "nchw_ms": nchw_ms, "fma_ms": fma_ms, "plain_ms": plain_ms,
            "unfused_ms": unfused_ms, "unfused_nchw_ms": unfused_nchw_ms,
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations", "mbytes": n_bytes / 1e6,
        })
        print(f"fused_mbconv {name} B={b} {p.h}x{p.w} {cin}->{cmid}->{cout} k{p.kernel} "
              f"s{p.stride}: {variant} {ms:.4f} ms (contiguous NCHW input {nchw_ms:.4f} ms), "
              f"fma {fma_ms:.4f} ms, unfused torch block "
              f"{unfused_ms:.4f} ms (NCHW {unfused_nchw_ms:.4f} ms), plain "
              f"{plain_ms:.3f} ms, bound {max(byte_ms, op_ms) * 1e3:.2f} us (bytes "
              f"{byte_ms * 1e3:.2f} us for {n_bytes / 1e6:.1f} MB, operations "
              f"{op_ms * 1e3:.2f} us)")
        for key, val in (("ms", ms), ("fma_ms", fma_ms), ("plain_ms", plain_ms),
                         ("unfused_ms", unfused_ms), ("bytes", n_bytes), ("mm", mm), ("dw", dw)):
            totals[key] += val
    byte_ms = totals["bytes"] / HBM_BYTES_PER_S * 1e3
    op_ms = (totals["mm"] / BF16_TENSOR_OPS_PER_S + totals["dw"] / F32_OPS_PER_S) * 1e3
    # One 64-frame batch runs the fused blocks once each: the record's times
    # are the sums over those launches.
    k2_record = {
        "name": "fused_mbconv",
        "route": "cuda",
        "source": "vbt_tpu_torch/csrc/fused_mbconv_mma.cu",
        "replaces": "vbt_tpu/ops/fused_mbconv.py:87",
        "launches": seen_turbo["fused_mbconv"],
        "max_abs_err": max(k2_err.values()),
        "max_abs_err_f32": k2_err["float32"],
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
        "library_ms": None,
        "unfused_ms": totals["unfused_ms"],
        "fma_ms": totals["fma_ms"],
        "fma_source": "vbt_tpu_torch/csrc/fused_mbconv.cu",
        "per": f"the {len(shapes)} fused blocks of one {BATCH}-frame batch, bf16",
        "shapes": shapes,
    }
    print(f"fused_mbconv per {BATCH}-frame batch ({len(shapes)} launches): {totals['ms']:.4f} ms, "
          f"fma kernel {totals['fma_ms']:.4f} ms, unfused torch blocks "
          f"{totals['unfused_ms']:.4f} ms, plain {totals['plain_ms']:.3f} ms, "
          f"bound {k2_record['bound_ms'] * 1e3:.2f} us ({k2_record['bound_by']})")
    return [nms_record, k2_record]


def _k3_work(dets, valid, report, s) -> tuple[int, int]:
    """(bytes, operations) of one scan over these inputs: the detections and
    masks read once and every output written once; per active frame the
    predict of every live slot (about 150 operations), the affinity and
    momentum of every valid detection against every slot (about 60) and the
    update of every reported slot (about 750; 4x4 inverse and 7x7 products).
    The Hungarian's share is left out, so the bound is low."""
    c, t, d, _ = dets.shape
    n_bytes = dets.numel() * 4 + valid.numel() + c * t * s * (1 + 4 * 4 + 4 + 4 + 4 + 2 * 4)
    n_valid = int(valid.sum())
    n_ops = c * t * s * 150 + n_valid * s * 60 + int(report.sum()) * 750
    return n_bytes, n_ops


def _time_k3(cfg, xla, k3_err, stream, relay_launches) -> dict:
    """Phase 6, K3: CUDA events on the main path's detections (C = 1,
    T = 256), on its first 64 frames with the state in and out (a streamed
    chunk) and on synthetic 60 s clips (C = 1 and 16, T = 1800), the host
    OC-SORT on the same 256 frames, the plain version on the card over the
    first 16 of them."""
    import torch
    from vbt_tpu_torch.cli.track import run_host_tracker
    from vbt_tpu_torch.io.synthetic import plate_detections
    from vbt_tpu_torch.ops.track_scan_cuda import track_scan
    from vbt_tpu_torch.tracking.scan import init_state, scan_clips_plain

    def inputs(rows, valid):
        dets = torch.from_numpy(np.ascontiguousarray(rows, np.float32)).cuda()
        mask = torch.from_numpy(np.ascontiguousarray(valid)).cuda()
        return dets, mask, torch.ones(dets.shape[:2], dtype=torch.bool, device="cuda")

    main = inputs(xla["rows"][None], xla["valid"][None])
    t = main[0].shape[1]
    ms = _cuda_ms(lambda: track_scan(cfg, *main), reps=10)
    report = track_scan(cfg, *main)[0]
    chunk = tuple(a[:, :STREAM_CHUNK].contiguous() for a in main)
    state0 = init_state(cfg, 1, torch.float32, "cuda")
    chunk_ms = _cuda_ms(lambda: track_scan(cfg, *chunk, state=state0, return_state=True),
                        reps=10)
    long_clips = [plate_detections(1800, 1, seed=100 + i, dropout=0.02, d_cap=D)
                  for i in range(16)]
    clips16 = inputs(np.stack([c[0] for c in long_clips]), np.stack([c[1] for c in long_clips]))
    clip1 = tuple(a[:1].contiguous() for a in clips16)
    ms_1800 = _cuda_ms(lambda: track_scan(cfg, *clip1), reps=3, warmup=1)
    ms_1800_c16 = _cuda_ms(lambda: track_scan(cfg, *clips16), reps=3, warmup=1)
    host_s = min(_host_s(lambda: run_host_tracker(xla["rows"], xla["valid"])) for _ in range(3))
    head = tuple(a[:, :16].contiguous() for a in main)
    plain_s = min(_host_s(lambda: (scan_clips_plain(cfg, *head), torch.cuda.synchronize()))
                  for _ in range(2))
    n_bytes, n_ops = _k3_work(main[0], main[1], report, cfg.max_tracks)
    byte_ms, op_ms = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    record = {
        "name": "track_scan",
        "route": "cuda",
        "source": "vbt_tpu_torch/csrc/track_scan.cu",
        "replaces": "vbt_tpu/tracking/scan.py:476",
        "launches": xla["launches"]["track_scan"],
        "max_abs_err": k3_err,
        "ms": ms,
        "plain_ms": plain_s * 1e3,
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
        "library_ms": None,
        "timed": f"ms: the main path's {t} frames, C = 1, CUDA events over 10 launches; "
                 "plain_ms: the plain version on the card over the first 16 of those frames, "
                 "host clock",
        "ms_per_frame": ms / t,
        "chunk64_state_ms": chunk_ms,
        "stream_launches": stream["launches"]["track_scan"],
        "relay_launches": relay_launches,
        "plain_ms_per_frame": plain_s * 1e3 / 16,
        "host_ocsort_ms": host_s * 1e3,
        "t1800_c1_ms": ms_1800,
        "t1800_c16_ms": ms_1800_c16,
        "replaces_also": "vbt_tpu/runtime/batch_runner.py:24 (track_clips); no Pallas kernel",
    }
    print(f"track_scan: {ms:.4f} ms for {t} frames ({ms / t * 1e3:.2f} us a frame), C = 1; "
          f"a {STREAM_CHUNK}-frame chunk with the state in and out {chunk_ms:.4f} ms; "
          f"T = 1800: C = 1 {ms_1800:.3f} ms, C = 16 {ms_1800_c16:.3f} ms; host OC-SORT "
          f"{host_s * 1e3:.2f} ms for the same {t} frames; plain version on the card "
          f"{plain_s * 1e3 / 16:.2f} ms a frame (16 frames); bound "
          f"{record['bound_ms'] * 1e3:.3f} us ({record['bound_by']}: {n_bytes / 1e6:.3f} MB, "
          f"{n_ops / 1e6:.2f} M operations)")
    return record


def _k4_work(n: int) -> tuple[int, int]:
    """(bytes, float64 operations) of K4 over n samples: six float64 inputs
    read a sample, nine event fields written (one byte, four, seven times
    eight), both carries read and written once; about 70 operations a
    sample (the ring sums, three means, two running-average pushes, two
    path-length increments, the comparisons of the state machine)."""
    carries = (10 + 2 + 30 + 2 + 1) * 8 + 5 * 4 + 1 + (12 * 8 + 3 * 4 + 1)
    return n * (6 * 8 + 1 + 4 + 7 * 8) + 2 * carries, n * 70


def _time_k4(series, k4_err, stream) -> dict:
    """K4 on one 64-sample chunk of the followed track from the fresh
    carries: the card's own time (replay of a CUDA graph of 50 launches),
    eager launches (the host's share included), and the plain version on the
    card (host clock, one chunk)."""
    import torch
    from vbt_tpu_torch.analysis.smoother_scan import initial_smoother
    from vbt_tpu_torch.analysis.velocity_torch import initial_carry
    from vbt_tpu_torch.ops.analysis_scan_cuda import analysis_chunk_plain, analysis_scan

    cols = [torch.from_numpy(np.ascontiguousarray(c[:STREAM_CHUNK])).cuda() for c in series]
    pd_ = torch.tensor(PLATE_DIAMETER, dtype=torch.float64, device="cuda")
    sm, vc = initial_smoother(device="cuda"), initial_carry(device="cuda")
    n = cols[0].shape[0]
    ms = _graph_ms(lambda: analysis_scan(pd_, sm, vc, cols), reps=50)
    eager_ms = _cuda_ms(lambda: analysis_scan(pd_, sm, vc, cols), reps=50)
    plain_s = min(_host_s(lambda: (analysis_chunk_plain(pd_, sm, vc, cols),
                                   torch.cuda.synchronize())) for _ in range(2))
    n_bytes, n_ops = _k4_work(n)
    byte_ms, op_ms = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F64_OPS_PER_S * 1e3
    record = {
        "name": "analysis_scan",
        "route": "cuda",
        "source": "vbt_tpu_torch/csrc/analysis_scan.cu",
        "replaces": "vbt_tpu/runtime/streaming.py:68",
        "launches": stream["launches"]["analysis_scan"],
        "max_abs_err": k4_err,
        "ms": ms,
        "plain_ms": plain_s * 1e3,
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
        "library_ms": None,
        "timed": f"one {n}-sample chunk of the followed track: ms by the replay of a CUDA "
                 "graph of 50 launches, eager_ms by a loop of 50 eager launches (the host's "
                 "share included), plain_ms the plain version on the card, host clock",
        "eager_ms": eager_ms,
        "samples": n,
        "replaces_also": "what XLA compiled from analysis_chunk (smoother_step + "
                         "velocity_step in one lax.scan); no Pallas kernel",
    }
    print(f"analysis_scan: {ms * 1e3:.2f} us a {n}-sample chunk on the card (graph replay), "
          f"{eager_ms * 1e3:.2f} us eager, plain version on the card {plain_s * 1e3:.2f} ms; "
          f"bound {record['bound_ms'] * 1e6:.3f} ns ({record['bound_by']}: {n_bytes} bytes, "
          f"{n_ops} float64 operations)")
    return record


def _int8_products(qpipe, images) -> dict:
    """Every distinct int8 product one forward of ``images`` makes:
    ``{(x shape, w shape, stride): (padded int8 input, int8 weight, stride)}``."""
    from vbt_tpu_torch.models import quant as q

    seen, launch = {}, q.int8_conv

    def capture(x_q, w_q, stride):
        seen.setdefault((tuple(x_q.shape), tuple(w_q.shape), stride), (x_q, w_q, stride))
        return launch(x_q, w_q, stride)

    q.int8_conv = capture
    try:
        qpipe.run_model(images)
    finally:
        q.int8_conv = launch
    return seen


def _forward_profile(pipe, images, labels=(), reps: int = 3) -> tuple[float, dict]:
    """``torch.profiler`` over ``reps`` forwards of ``images``: see
    :func:`_device_profile`."""
    return _device_profile(lambda: pipe.run_model(images), labels, reps)


def _device_profile(fn, labels=(), reps: int = 3) -> tuple[float, dict]:
    """``torch.profiler`` over ``reps`` calls of ``fn``: the device's busy
    time a call in us (the union of its kernels' spans), and for each
    ``record_function`` label the time a call of the kernels launched
    inside it (the host-side range's ops and their kernels; the
    device-side range of the same name spans the gaps between them too, so
    it is left out of both)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == cuda and e.name not in labels
                   and not e.name.startswith("Activity Buffer"))
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    parts = {label: sum(e.device_time_total for e in prof.events()
                        if e.name == label and e.device_type == cpu) / reps
             for label in labels}
    return busy / reps, parts


def _int8_profile(pipe, qpipe, images) -> None:
    """The bf16 and the int8 forward's device time from ``torch.profiler``,
    and the int8 forward's by part: quantize, the int8 product (im2col,
    padding and ``_int_mm``) and dequantize each run inside a
    ``record_function`` of its name, and ``_int_mm`` alone."""
    from torch.profiler import record_function
    from vbt_tpu_torch.models import quant as q

    parts = {"quantize": q.quantize, "int8_conv": q.int8_conv, "dequantize": q.dequantize}

    def labelled(name, fn):
        def call(*args):
            with record_function(name):
                return fn(*args)
        return call

    bf16_us, _ = _forward_profile(pipe, images)
    for name, fn in parts.items():
        setattr(q, name, labelled(name, fn))
    try:
        int8_us, by_part = _forward_profile(qpipe, images, (*parts, "aten::_int_mm"))
    finally:
        for name, fn in parts.items():
            setattr(q, name, fn)
    if not int8_us:
        print("int8 profile: the profiler recorded no device time (not measured)")
        return
    print(f"profile, mean of 3 forwards (B = {images.shape[0]}): device busy bf16 "
          f"{bf16_us / 1e3:.3f} ms, int8 {int8_us / 1e3:.3f} ms a forward; int8 kernels by "
          f"part: " + ", ".join(f"{name} {us / 1e3:.3f} ms ({us / int8_us:.1%})"
                                for name, us in by_part.items()))


def _int8_lane(pipe, frames, kernels, xla):
    """Phase 11: calibrate, drive the int8 lane with the counts at 0, hold
    every int8 product of lite0 at batch 64 and 1 bit for bit against the
    plain version on the CPU, compare with the bf16 lane, time and profile
    the int8 forward. Returns the int8 pipeline."""
    import torch
    from vbt_tpu_torch.models import quant as q
    from vbt_tpu_torch.ops.preprocess import preprocess_frames

    t0 = time.perf_counter()
    qpipe = pipe.calibrate(frames[:BATCH])
    n_scales = sum(k.endswith(".act_scale") for k in qpipe.weights)
    print(f"int8: calibrated {n_scales} activation scales on {BATCH} frames in "
          f"{time.perf_counter() - t0:.2f} s")
    with torch.inference_mode():
        images = preprocess_frames(pipe._frames(frames[:BATCH]), pipe.spec.input_size,
                                   pipe.dtype)
        q.int8_matmul.calls = 0
        qpipe.run_model(images)
        per_forward = q.int8_matmul.calls
    q.int8_matmul.calls = 0
    run = _main_path("int8", qpipe, frames, kernels,
                     {"nms": BATCHES, "fused_mbconv": 0, "track_scan": 1, "analysis_scan": 0})
    calls = q.int8_matmul.calls  # the main path's warm-up batch, then its BATCHES
    print(f"int8: {calls} int8 products on the main path ({per_forward} a forward, "
          f"{len(q.dense_convs(qpipe.model))} dense convs)")
    if per_forward < len(q.dense_convs(qpipe.model)) or calls != per_forward * (BATCHES + 1):
        raise AssertionError(f"int8: {calls} int8 products, want {per_forward} x {BATCHES + 1}")

    n_shapes, t0 = 0, time.perf_counter()
    with torch.inference_mode():
        for batch in (images, images[:1]):
            for (xs, ws, stride), (x_q, w_q, _) in _int8_products(qpipe, batch).items():
                got = q.int8_conv_gemm(x_q, w_q, stride).cpu()
                want = q.int8_conv_plain(x_q.cpu(), w_q.cpu(), stride)
                if got.dtype != torch.int32 or not torch.equal(got, want):
                    raise AssertionError(f"int8 product x {xs} w {ws} s{stride}: card and "
                                         f"plain accumulators differ by "
                                         f"{(got.double() - want.double()).abs().max().item()}")
                n_shapes += 1
    print(f"int8: {n_shapes} distinct int8 products (B = {BATCH} and B = 1, shapes (m, k, n) "
          f"padded per int_mm_shape) equal the plain version on the CPU bit for bit "
          f"({time.perf_counter() - t0:.1f} s)")

    top = lambda r: (r["rows"][:, 0, :4], r["rows"][:, 0, 4])  # noqa: E731
    (qb, qs), (fb, fs) = top(run), top(xla)
    dbox, dscore = float(np.abs(qb - fb).max()), float(np.abs(qs - fs).max())
    print(f"int8 vs bf16 on the same {len(frames)} frames: max |d top box| {dbox:.4g} of the "
          f"frame, max |d top score| {dscore:.4g}; mean top score int8 {qs.mean():.4f}, "
          f"bf16 {fs.mean():.4f}")
    if dbox > 0.05:
        raise AssertionError("int8 top boxes drift more than 0.05 of the frame from bf16")

    with torch.inference_mode():
        turns = [_cuda_ms(lambda: p.run_model(images), reps=20)
                 for p in (pipe, qpipe, qpipe, pipe)]
        _int8_profile(pipe, qpipe, images)
    print(f"forward, B = {BATCH}, CUDA events over 20 eager calls (the host's launch gaps "
          f"included), in turns (bf16, int8, int8, bf16): "
          + ", ".join(f"{t:.3f}" for t in turns) + " ms")
    return qpipe


def _eval_lanes(lanes, kernels) -> None:
    """Phase 12: the eval CLI's lane in memory, batch 1 an image, for each
    pipeline: launches, ``create_detections_df``'s matching rows and the
    COCO AP of ``evaluate_model`` against ``plate_boxes``; then the
    staging rings alive."""
    import torch
    from vbt_tpu_torch.cli.eval import detection_rows, image_detections
    from vbt_tpu_torch.io.synthetic import plate_boxes, plate_frames
    from vbt_tpu_torch.runtime.pipeline import MAX_RINGS
    from vbt_tpu_torch.train.coco_eval import coco_metrics
    from vbt_tpu_torch.train.evaluate import detect_images

    sizes = ((240, 320), (360, 480), (288, 512), (480, 640), (720, 1280))
    images, truth = {}, {}
    for h, w in sizes:
        for i, (img, box) in enumerate(zip(plate_frames(3, h, w, seed=h + w, period=5),
                                           plate_boxes(3, h, w, period=5))):
            images[f"plate_{h}x{w}_{i}"], truth[f"plate_{h}x{w}_{i}"] = img, box[None]
    for lane, pipe in lanes.items():
        image_detections(pipe, images[next(iter(images))])  # first launches of batch 1
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        dets = {name: image_detections(pipe, img) for name, img in images.items()}
        scores, _, ious = detection_rows(truth, {lane: dets})
        metrics = coco_metrics(detect_images(pipe, list(images.values())), list(truth.values()))
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernels.items()}
        want = {"nms": 2 * len(images), "fused_mbconv": 0, "track_scan": 0, "analysis_scan": 0}
        if launches != want:
            raise AssertionError(f"eval [{lane}]: launches {launches}, want {want}")
        best = np.array([iou for iou in ious if iou > 0])
        print(f"eval [{lane}]: {len(images)} images at {len(sizes)} sizes, batch 1, twice "
              f"({wall:.2f} s, launches {launches}); {len(scores)} matched rows, "
              f"{len(best)} with IoU > 0 (mean {best.mean():.4f}); AP {metrics['AP']:.4f} "
              f"AP50 {metrics['AP50']:.4f} AP75 {metrics['AP75']:.4f}")
        if not (len(best) == len(images) and metrics["AP50"] > 0.9):
            raise AssertionError(f"eval [{lane}]: the plate is not found in every image: "
                                 f"{metrics}")
    alive = {lane: len(pipe.rings) for lane, pipe in lanes.items()}
    print(f"eval: staging rings alive {alive} (bound {MAX_RINGS})")
    if max(alive.values()) > MAX_RINGS:
        raise AssertionError(f"staging rings {alive} exceed {MAX_RINGS}")


def _train_data(n: int, seed: int):
    """``n`` synthetic 320x320 plate images with their analytic boxes, padded
    to 16 rows as ``load_voc_dataset`` pads."""
    from vbt_tpu_torch.io.synthetic import plate_boxes, plate_frames
    from vbt_tpu_torch.train.data import DetectionDataset

    boxes, valid = np.zeros((n, 16, 4), np.float32), np.zeros((n, 16), bool)
    boxes[:, 0], valid[:, 0] = plate_boxes(n, TRAIN_SIZE, TRAIN_SIZE, period=PERIOD), True
    return DetectionDataset(plate_frames(n, TRAIN_SIZE, TRAIN_SIZE, seed=seed, period=PERIOD),
                            boxes, valid, [f"plate_{seed}_{i}" for i in range(n)])


def _step_ratios(cpu, card, bounds) -> dict:
    """Each group's largest card-against-CPU difference over its bound
    (``TRAIN_BOUNDS``); 1 is the bound."""
    rtol, trace_rtol, atol = bounds
    trace_max = max(float(t.abs().max()) for t in cpu.opt_state.trace.values())

    def worst(name, bound):
        want, got = getattr(cpu, name), getattr(card, name)
        if name == "opt_state":
            want, got = want.trace, got.trace
        return max(float((got[k].cpu().double() - w.cpu().double()).abs().max()) / bound(w)
                   for k, w in want.items())

    moved = lambda w: atol + TRAIN_CHECK_LR * trace_rtol * trace_max  # noqa: E731
    return {"params": worst("params", moved), "ema_params": worst("ema_params", moved),
            "batch_stats": worst("batch_stats", lambda w: atol + rtol * float(w.abs().max())),
            "trace": worst("opt_state", lambda w: trace_rtol * trace_max)}


def _check_batches(n: int = STEP_CHECK_BATCH, devices=("cpu", "cuda")) -> dict:
    """One batch of ``n`` plate images augmented with the same draws on each
    of ``devices``: ``{device: batch}``."""
    import torch
    from vbt_tpu_torch.train.augment import augment_mosaic_and_normalize, draw_mosaic

    data = _train_data(n, seed=3)
    draws = draw_mosaic(torch.Generator().manual_seed(0), n, TRAIN_SIZE)
    batches = {}
    for device in devices:
        on = lambda t: None if t is None else t.to(device)  # noqa: E731
        batches[device] = dict(zip(("images", "gt_boxes", "gt_valid"), augment_mosaic_and_normalize(
            *(torch.from_numpy(a).to(device) for a in (data.images, data.boxes, data.valid)),
            type(draws)(*map(on, draws)))))
    return batches


def _two_steps(spec, device, dtype, batch, mesh=None, variables=None):
    """Two train steps from the seed-0 state (``variables``, if given, are
    its model variables) on ``device`` in ``dtype``, over ``mesh`` if one is
    given: (losses, final state, seconds)."""
    from vbt_tpu_torch.train.train_step import Trainer

    t0 = time.perf_counter()
    trainer = Trainer(spec, base_lr=TRAIN_CHECK_LR, total_steps=10, warmup_steps=1,
                      input_size=TRAIN_SIZE, dtype=dtype, device=device, mesh=mesh)
    state = trainer.init_state(seed=0) if variables is None else trainer.state_from(variables)
    batch = {k: v.to(device) for k, v in batch.items()}
    losses = []
    for _ in range(2):
        state, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses, state, time.perf_counter() - t0


def _hold_train_step(spec) -> None:
    """Phase 13 (a): two train steps on the card against CPU copies, float32
    on each device's own augmentation of one batch, then float64 on the
    CPU's."""
    import torch

    batches = _check_batches()
    cb, gb = batches["cpu"], batches["cuda"]
    img_err = float((gb["images"].cpu() - cb["images"]).abs().max())
    box_err = float((gb["gt_boxes"].cpu() - cb["gt_boxes"]).abs().max())
    same_valid = torch.equal(gb["gt_valid"].cpu(), cb["gt_valid"])
    print(f"train augmentation, B = {STEP_CHECK_BATCH}, the same draws, card against CPU: "
          f"images {img_err:.3g}, boxes {box_err:.3g}, valid {'equal' if same_valid else 'DIFFER'}")
    ok = img_err <= 1e-3 and box_err <= 1e-4 and same_valid
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        runs = {device: _two_steps(spec, device, dtype,
                                   batches[device] if dtype == torch.float32 else cb)
                for device in ("cpu", "cuda")}
        (closs, cpu, cpu_s), (gloss, card, card_s) = runs["cpu"], runs["cuda"]
        loss_rel = max(abs(g - c) / abs(c) for g, c in zip(gloss, closs))
        ratios = _step_ratios(cpu, card, TRAIN_BOUNDS[name])
        print(f"train step, lite0 {TRAIN_SIZE}, B = {STEP_CHECK_BATCH}, {name}, card against CPU "
              f"(CPU {cpu_s:.1f} s, card {card_s:.1f} s for 2 steps): losses {closs} / {gloss} "
              f"(max rel {loss_rel:.3g}); largest difference over its bound "
              f"{TRAIN_BOUNDS[name]}: " + ", ".join(f"{k} {v:.3g}" for k, v in ratios.items()))
        ok = ok and loss_rel <= TRAIN_BOUNDS[name][0] and max(ratios.values()) <= 1
    if not ok:
        raise AssertionError("train step: the card disagrees with the CPU beyond the bounds")


def _distances(a, b) -> dict:
    """Relative L2 distance of state ``a`` from state ``b`` in each group
    (all its leaves as one vector): ``|a - b| / |b|``."""
    out = {}
    for group in ("params", "ema_params", "batch_stats", "trace"):
        want = b.opt_state.trace if group == "trace" else getattr(b, group)
        got = a.opt_state.trace if group == "trace" else getattr(a, group)
        diff = sum(float((got[k].cpu().double() - w.cpu().double()).square().sum())
                   for k, w in want.items())
        norm = sum(float(w.cpu().double().square().sum()) for w in want.values())
        out[group] = (diff / norm) ** 0.5
    return out


def _hold_bf16_step(spec) -> None:
    """Phase 14 (e): two bfloat16 train steps on the card against the CPU
    port's, on the CPU's batch, beside each device's float32 steps on it:
    the losses within ``TRAIN_BOUNDS["bfloat16"]``, and each group's
    distance between the devices within its factor of the larger of the two
    devices' own bfloat16-against-float32 distances."""
    import torch

    cb = _check_batches()["cpu"]
    runs = {(device, dtype): _two_steps(spec, device, dtype, cb)
            for device in ("cpu", "cuda") for dtype in (torch.bfloat16, torch.float32)}
    loss_rtol, factor, floor = TRAIN_BOUNDS["bfloat16"]
    (closs, cpu, cpu_s), (gloss, card, card_s) = (runs["cpu", torch.bfloat16],
                                                  runs["cuda", torch.bfloat16])
    loss_rel = max(abs(g - c) / abs(c) for g, c in zip(gloss, closs))
    f32 = {d: runs[d, torch.float32] for d in ("cpu", "cuda")}
    gaps = {d: abs(runs[d, torch.bfloat16][0][0] - f32[d][0][0]) / abs(f32[d][0][0])
            for d in ("cpu", "cuda")}
    across = _distances(card, cpu)
    own = {d: _distances(runs[d, torch.bfloat16][1], f32[d][1]) for d in ("cpu", "cuda")}
    ratios = {g: across[g] / (factor * max(own["cpu"][g], own["cuda"][g]) + floor)
              for g in across}
    print(f"train step, lite0 {TRAIN_SIZE}, B = {STEP_CHECK_BATCH}, bfloat16, card against CPU "
          f"on the CPU's batch (CPU {cpu_s:.1f} s, card {card_s:.1f} s for 2 steps): losses "
          f"{closs} / {gloss} (max rel {loss_rel:.3g}, bound {loss_rtol}); float32 losses CPU "
          f"{f32['cpu'][0][0]}, card {f32['cuda'][0][0]}: bf16 moves the first loss by "
          f"{gaps['cpu']:.3g} on the CPU, {gaps['cuda']:.3g} on the card")
    for g in across:
        print(f"  {g}: relative L2 distance card-CPU in bf16 {across[g]:.4g}; bf16 against "
              f"float32 on the CPU {own['cpu'][g]:.4g}, on the card {own['cuda'][g]:.4g}; "
              f"over its bound ({factor} x the larger + {floor}) {ratios[g]:.3g}")
    leaf = _step_ratios(cpu, card, TRAIN_BOUNDS["float32"])
    print("  largest difference of a leaf over phase 13's float32 bound (not held in bf16): "
          + ", ".join(f"{k} {v:.3g}" for k, v in leaf.items()))
    if loss_rel > loss_rtol or max(ratios.values()) > 1:
        raise AssertionError("bf16 train step: the card disagrees with the CPU beyond the bounds")


def _train_profile(ddt, state, idx, gen, step_ms) -> None:
    """Phase 13 (e): where a fused step's device time goes, and the device's
    idle share of the step. Each part of the step runs inside a
    ``record_function`` of its name (the functions are wrapped for the
    profile and restored after it)."""
    import torch
    from torch.profiler import record_function
    from vbt_tpu_torch.train import fused
    from vbt_tpu_torch.train import train_step as ts

    def labelled(name, fn):
        def call(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return call

    # The backward's kernels are launched from autograd's own thread, outside
    # any range of this one: they fall in "the rest".
    patches = [(fused, "draw_mosaic", "augment"), (fused, "augment_mosaic_and_normalize",
                                                   "augment"),
               (ts, "assign_targets", "targets"), (ts, "functional_call", "forward"),
               (ts, "detection_loss", "loss"), (ts.SGDChain, "update", "optimizer"),
               (ts, "apply_updates", "optimizer")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, label in patches:
        setattr(obj, attr, labelled(label, getattr(obj, attr)))
    labels = ("augment", "targets", "forward", "loss", "optimizer")
    try:
        busy_us, parts = _device_profile(lambda: ddt.step(state, idx, gen, 0.5), labels)
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    if not busy_us:
        print("train profile: the profiler recorded no device time (not measured)")
        return
    rest = busy_us - sum(parts.values())
    print(f"train profile, mean of 3 fused steps (B = {idx.shape[0]}): device busy "
          f"{busy_us / 1e3:.3f} ms of the {step_ms:.3f} ms step (idle share "
          f"{1 - busy_us / 1e3 / step_ms:.3f}); by part: "
          + ", ".join(f"{k} {v / 1e3:.3f} ms ({v / busy_us:.1%})" for k, v in parts.items())
          + f", the rest (the backward, the gather, the EMA) {rest / 1e3:.3f} ms "
          f"({rest / busy_us:.1%})")


def _train_phase(kernels) -> int:
    """Phase 13: training (see the module docstring). Returns NMS launches
    in the evaluation of the trained parameters."""
    import torch
    from vbt_tpu_torch.cli.train import donor_state
    from vbt_tpu_torch.models import get_model_spec
    from vbt_tpu_torch.runtime.checkpoint import (
        latest_train_checkpoint,
        load_checkpoint,
        load_train_checkpoint,
        save_params,
        save_train_checkpoint,
    )
    from vbt_tpu_torch.train.coco_eval import coco_metrics
    from vbt_tpu_torch.train.evaluate import EVAL_BATCH, detect_resized
    from vbt_tpu_torch.train.fused import DeviceDataTrainer
    from vbt_tpu_torch.train.train_step import Trainer

    t_phase = time.perf_counter()
    spec = get_model_spec("efficientdet_lite0_whole")
    _hold_train_step(spec)

    # (b) From scratch, the device-resident loop.
    trainer = Trainer(spec, base_lr=0.08 * TRAIN_BATCH / 64, total_steps=TRAIN_STEPS,
                      warmup_steps=max(TRAIN_STEPS // 20, 1), input_size=TRAIN_SIZE,
                      device="cuda")
    state = trainer.init_state(seed=0)
    ddt = DeviceDataTrainer(trainer, _train_data(TRAIN_IMAGES, 0), _train_data(16, 1))
    rng, gen = np.random.default_rng(0), torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = []
    while len(metrics) < TRAIN_STEPS:
        state, more, gen = ddt.epoch(state, rng, TRAIN_BATCH, gen,
                                     max_batches=TRAIN_STEPS - len(metrics))
        metrics += more
    losses = torch.stack([m["loss"] for m in metrics]).cpu().numpy()  # one read back
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    val = ddt.val_loss(state)
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    print(f"train from scratch, lite0 {TRAIN_SIZE}, B = {TRAIN_BATCH}, {TRAIN_IMAGES} images "
          f"resident, {len(losses)} fused steps (mosaic 0.5) in {wall:.2f} s: mean loss of the "
          f"first 5 steps {first:.4f}, of the last 5 {last:.4f}; val_loss {val:.4f}; losses "
          + " ".join(f"{v:.3f}" for v in losses))
    if not (np.isfinite(losses).all() and np.isfinite(val) and last < first):
        raise AssertionError(f"train from scratch: the loss did not fall ({first} -> {last})")

    # (e) Time and memory of a fused step at B = 32.
    idx = torch.arange(TRAIN_BATCH, device="cuda")
    step_ms = _cuda_ms(lambda: ddt.step(state, idx, gen, 0.5), reps=10, warmup=2)
    aug_ms = _cuda_ms(lambda: ddt.augment(idx, gen, 0.5), reps=10)
    print(f"train step time ({_nvidia_smi()}): fused step {step_ms:.3f} ms "
          f"({TRAIN_BATCH / step_ms * 1e3:.1f} images/s), of which augmentation {aug_ms:.3f} ms "
          f"({aug_ms / step_ms:.1%}); peak memory {peak:.3f} GiB "
          f"(torch.cuda.max_memory_allocated, steps of (b))")

    _train_profile(ddt, state, idx, gen, step_ms)

    # (c) Heads-only from the shipped donor: frozen subtrees bit for bit.
    heads = Trainer(spec, base_lr=0.01, total_steps=10, warmup_steps=1, freeze_top_keys=FREEZE,
                    input_size=TRAIN_SIZE, device="cuda")
    h_state = donor_state(heads, heads.init_state(seed=0), CKPT)
    h_ddt = DeviceDataTrainer(heads, _train_data(TRAIN_IMAGES, 2))
    h_gen = torch.Generator(device="cuda").manual_seed(1)
    for _ in range(3):
        h_state, _, h_gen = h_ddt.epoch(h_state, rng, TRAIN_BATCH, h_gen)
    donor, got = load_checkpoint(CKPT), heads.variables(h_state)
    frozen = [k for k in donor if k.split(".")[0] in FREEZE]
    moved = sum(not torch.equal(got[k].cpu(), donor[k]) for k in donor if k not in frozen)
    same = all(torch.equal(got[k].cpu(), donor[k]) for k in frozen)
    print(f"heads-only from {os.path.basename(CKPT)}, {h_state.step} steps: {len(frozen)} "
          f"backbone/BiFPN tensors {'bit for bit the donor' if same else 'CHANGED'}, "
          f"{moved} of the heads' {len(donor) - len(frozen)} moved")
    if not (same and moved):
        raise AssertionError("heads-only: frozen subtrees changed or the heads did not train")

    # (d) Checkpoint round trip, then export and evaluation through K1.
    out = os.path.join(REPO, "out", "chip_smoke_train")
    save_train_checkpoint(out, 1, state)
    back = load_train_checkpoint(out, latest_train_checkpoint(out), state)
    exact = (back.step == state.step and back.opt_state.count == state.opt_state.count
             and all(torch.equal(a[k], b[k]) for a, b in (
                 (back.params, state.params), (back.batch_stats, state.batch_stats),
                 (back.opt_state.trace, state.opt_state.trace),
                 (back.ema_params, state.ema_params)) for k in b))
    print(f"train checkpoint {os.path.join('out', 'chip_smoke_train')}: save -> load "
          f"{'bit for bit' if exact else 'DIFFERS'}")
    if not exact:
        raise AssertionError("train checkpoint round trip is not exact")
    from vbt_tpu_torch.io.synthetic import plate_boxes, plate_frames
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline

    n_eval = 40
    images = list(plate_frames(n_eval, TRAIN_SIZE, TRAIN_SIZE, seed=9, period=PERIOD))
    truth = [b[None].astype(np.float64)
             for b in plate_boxes(n_eval, TRAIN_SIZE, TRAIN_SIZE, period=PERIOD)]
    dims = [(TRAIN_SIZE, TRAIN_SIZE)] * n_eval
    results, launches = {}, 0
    for tag, use_ema in (("raw", False), ("ema", True)):
        pipe = DetectionPipeline(spec, trainer.variables(state, use_ema=use_ema), device="cuda")
        detect_resized(pipe, images[:1], dims[:1])  # first launches
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        dets = detect_resized(pipe, images, dims)
        lane = {name: fn.launches for name, fn in kernels.items()}
        want = {"nms": -(-n_eval // EVAL_BATCH), "fused_mbconv": 0, "track_scan": 0,
                "analysis_scan": 0}
        if lane != want:
            raise AssertionError(f"train eval [{tag}]: launches {lane}, want {want}")
        launches += lane["nms"]
        results[tag] = (coco_metrics(dets, truth), dets)
    best = max(results, key=lambda t: results[t][0]["AP"])
    path = os.path.join(out, f"{spec.name}.msgpack")
    save_params(path, trainer.variables(state, use_ema=best == "ema"))
    reloaded = detect_resized(DetectionPipeline.from_model_arg(path, device="cuda"), images, dims)
    same_dets = all(np.array_equal(a["boxes"], b["boxes"]) and np.array_equal(a["scores"],
                                                                              b["scores"])
                    for a, b in zip(reloaded, results[best][1]))
    print(f"train eval, {n_eval} held-out images, batches of {EVAL_BATCH}: NMS {launches} "
          f"launches; " + "; ".join(
              f"{tag} AP {m['AP']:.4f} AP50 {m['AP50']:.4f} AP75 {m['AP75']:.4f}"
              for tag, (m, _) in results.items())
          + f"; exported {best} to {os.path.join('out', 'chip_smoke_train', spec.name)}.msgpack, "
          f"reloaded: detections {'the same' if same_dets else 'DIFFER'}")
    if not same_dets:
        raise AssertionError("the exported checkpoint does not give the same detections")
    print(f"phase 13 (training) {time.perf_counter() - t_phase:.1f} s")
    return launches


def _probe_phase() -> int:
    """Phase 14 (a): the health probe of the card, then the wedged fake
    killed at its deadline. Returns the K1 launches of the probe's child."""
    from vbt_tpu_torch.utils import health

    t0 = time.perf_counter()
    rep = health.require_healthy_device("cuda", context="chip_smoke")
    print(f"health probe ({_nvidia_smi()}): {rep.reason} in {time.perf_counter() - t0:.1f} s; "
          f"marginal lite0 bf16 detect_batch at B = {health.BATCH}, {health.SIZE}x{health.SIZE} "
          f"uint8, random init: {rep.forward_ms} ms (threshold {health.SLOW_MS} ms); K1 launches "
          f"in the child {rep.nms_launches}")
    if not rep.ok or rep.forward_ms is None or rep.nms_launches != 16:  # run(12) + run(4)
        raise AssertionError(f"health probe: {rep}")
    os.environ[health.FAKE_ENV] = "wedged"
    try:
        t0 = time.perf_counter()
        wedged = health.probe_device("cuda", deadline_s=WEDGED_DEADLINE_S)
        took = time.perf_counter() - t0
    finally:
        del os.environ[health.FAKE_ENV]
    print(f"health probe, wedged fake, deadline {WEDGED_DEADLINE_S} s: killed after {took:.2f} "
          f"s: {wedged.reason}")
    if wedged.ok or "wedged" not in wedged.reason or took > WEDGED_DEADLINE_S + 5:
        raise AssertionError(f"wedged probe: ok={wedged.ok}, {took:.2f} s")
    return rep.nms_launches


def _cache_phase() -> None:
    """Phase 14 (b): the keyed build cache."""
    from vbt_tpu_torch.ops import _build

    again = _build.build_all()
    keys = {name: _build.library_key(name) for name in _build.SOURCES}
    print(f"build cache {_build.BUILD_DIR}: a second build_all() built {again}; keys "
          + ", ".join(f"{n} {k}" for n, k in keys.items()))
    saved = _build.SOURCE_FLAGS.get("nms")
    _build.SOURCE_FLAGS["nms"] = [*(saved or []), "-DVBT_CACHE_CHECK=1"]
    try:
        new_key, new_path = _build.library_key("nms"), _build.library_path("nms")
        t0 = time.perf_counter()
        rebuilt = _build.build_all()
        took = time.perf_counter() - t0
    finally:
        if saved is None:
            del _build.SOURCE_FLAGS["nms"]
        else:
            _build.SOURCE_FLAGS["nms"] = saved
    old_path = _build.library_path("nms")
    print(f"build cache: SOURCE_FLAGS['nms'] + -DVBT_CACHE_CHECK=1 -> key {new_key}, built "
          f"{rebuilt} in {took:.2f} s into {new_path.name} beside {old_path.name}")
    if again or rebuilt != ["nms"] or new_key == keys["nms"] or not (
            new_path.exists() and old_path.exists() and new_path != old_path):
        raise AssertionError("build cache: not keyed as it should be")


def _trace_phase(pipe, frames, kernels) -> tuple[dict, dict]:
    """Phase 14 (c): ``trace`` around the detect + K3 path of
    ``vbt-torch-track``; the trace file read back. Returns the tracks and
    the launches."""
    import glob
    import shutil

    import torch
    from vbt_tpu_torch.cli.track import run_scan_tracker
    from vbt_tpu_torch.utils.profiling import trace

    log_dir = os.path.join(REPO, "out", "chip_smoke_trace")
    shutil.rmtree(log_dir, ignore_errors=True)
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with trace(log_dir):
        rows, valid = _detect_all(pipe, frames)
        tracks = run_scan_tracker(rows, valid, pipe.device)
        torch.cuda.synchronize()
    took = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_name: dict[str, list] = {}
    for e in events:
        if e.get("cat") == "kernel":
            acc = by_name.setdefault(e["name"], [0.0, 0])
            acc[0] += float(e.get("dur", 0.0))
            acc[1] += 1
    found = {k: sum(n for name, (_, n) in by_name.items() if k + "_kernel" in name)
             for k in ("nms", "track_scan")}
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    print(f"trace {os.path.relpath(path, REPO)}: {os.path.getsize(path) / 2**20:.2f} MiB, "
          f"{len(events)} events, traced run {took:.2f} s; kernel events: nms_kernel "
          f"{found['nms']}, track_scan_kernel {found['track_scan']} against launches {launches}; "
          f"top five device operations of {busy_ms:.3f} ms:")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]:
        print(f"  {us / 1e3:9.3f} ms x{n:<5d} {name[:100]}")
    want = {"nms": BATCHES, "fused_mbconv": 0, "track_scan": 1, "analysis_scan": 0}
    if launches != want or found != {"nms": want["nms"], "track_scan": want["track_scan"]}:
        raise AssertionError(f"trace: launches {launches}, kernel events {found}, want {want}")
    return tracks, launches


def _groundtruth_phase(tracks) -> None:
    """Phase 14 (d): the card's track of the scene against Kinovea and
    Qualisys exports of its analytic trajectory."""
    import shutil

    from vbt_tpu_torch.cli import kinovea, qualisys
    from vbt_tpu_torch.cli._groundtruth import run_validation
    from vbt_tpu_torch.cli.track import tracks_to_data
    from vbt_tpu_torch.contract.schema import build_df_filename, build_track_df, max_travel_id
    from vbt_tpu_torch.io.synthetic import (
        plate_track_meters,
        write_kinovea_export,
        write_qualisys_export,
    )

    root = os.path.join(REPO, "out", "chip_smoke_groundtruth")
    shutil.rmtree(root, ignore_errors=True)
    df_dir = os.path.join(root, "dfs")
    os.makedirs(df_dir)
    df = build_track_df(tracks_to_data(tracks, fps=FPS))
    df.to_pickle(os.path.join(df_dir, build_df_filename("synthetic_plate.mp4", max_travel_id(df),
                                                        os.path.basename(CKPT))))
    seconds = len(tracks["report"]) / FPS
    for name, cli, write, hz, suffix in (("kinovea", kinovea, write_kinovea_export, 30, "txt"),
                                         ("qualisys", qualisys, write_qualisys_export, 100, "tsv")):
        export_dir = os.path.join(root, name)
        os.makedirs(export_dir)
        time_s = np.arange(1, int(seconds * hz) + 1) / hz
        x, y = plate_track_meters(time_s, HEIGHT, WIDTH, period=PERIOD, fps=FPS,
                                  plate_diameter=PLATE_DIAMETER)
        write(os.path.join(export_dir, f"synthetic_plate.{suffix}"), time_s, x, y)
        (r,) = run_validation(export_dir, df_dir, False, None, PLATE_DIAMETER, cli.CONFIG)
        print(f"ground truth [{name}, {hz} Hz export]: MSE x {r.mse_x:.6g} m^2, y {r.mse_y:.6g} "
              f"m^2; r_x {r.r_x:.6g} (x constant in the scene), r_y {r.r_y:.6f} "
              f"(bound > {GT_R_Y_MIN[name]})")
        if not (np.isfinite(r.mse_y) and r.r_y > GT_R_Y_MIN[name]):
            raise AssertionError(f"ground truth [{name}]: r_y {r.r_y}")


def _bf16_train_phase() -> None:
    """Phase 14 (e): bfloat16 training against the CPU port, from scratch,
    and its fused step beside float32's."""
    import torch
    from vbt_tpu_torch.models import get_model_spec
    from vbt_tpu_torch.train.fused import DeviceDataTrainer
    from vbt_tpu_torch.train.train_step import Trainer

    spec = get_model_spec("efficientdet_lite0_whole")
    _hold_bf16_step(spec)
    runs = {}
    for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        trainer = Trainer(spec, base_lr=0.08 * TRAIN_BATCH / 64, total_steps=TRAIN_STEPS,
                          warmup_steps=max(TRAIN_STEPS // 20, 1), input_size=TRAIN_SIZE,
                          dtype=dtype, device="cuda")
        ddt = DeviceDataTrainer(trainer, _train_data(TRAIN_IMAGES, 0), _train_data(16, 1))
        runs[name] = [ddt, trainer.init_state(seed=0),
                      torch.Generator(device="cuda").manual_seed(0)]
    ddt, state, gen = runs["bfloat16"]
    rng = np.random.default_rng(0)
    metrics = []
    t0 = time.perf_counter()
    while len(metrics) < TRAIN_STEPS:
        state, more, gen = ddt.epoch(state, rng, TRAIN_BATCH, gen,
                                     max_batches=TRAIN_STEPS - len(metrics))
        metrics += more
    losses = torch.stack([m["loss"] for m in metrics]).cpu().numpy()
    wall = time.perf_counter() - t0
    val = ddt.val_loss(state)
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    leaves = [*state.params.values(), *state.ema_params.values(), *state.batch_stats.values()]
    dtypes = sorted({str(v.dtype) for v in leaves})
    print(f"train from scratch in bf16, lite0 {TRAIN_SIZE}, B = {TRAIN_BATCH}, {len(losses)} fused "
          f"steps in {wall:.2f} s: mean loss of the first 5 steps {first:.4f}, of the last 5 "
          f"{last:.4f}; val_loss {val:.4f}; state dtypes {dtypes}; losses "
          + " ".join(f"{v:.3f}" for v in losses))
    if not (np.isfinite(losses).all() and np.isfinite(val) and last < first
            and dtypes == ["torch.float32"]):
        raise AssertionError(f"bf16 training: loss {first} -> {last}, state {dtypes}")
    runs["bfloat16"][1:] = [state, gen]

    idx = torch.arange(TRAIN_BATCH, device="cuda")
    step_ms = {"bfloat16": [], "float32": []}
    for name in ("float32", "bfloat16", "bfloat16", "float32") * 3:  # in turns
        ddt, st, g = runs[name]
        step_ms[name].append(_cuda_ms(lambda: ddt.step(st, idx, g, 0.5), reps=10, warmup=2))
    for name in ("bfloat16", "float32"):
        ddt, st, g = runs[name]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            ddt.step(st, idx, g, 0.5)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        busy_us, _ = _device_profile(lambda: ddt.step(st, idx, g, 0.5))
        ms = float(np.median(step_ms[name]))
        idle = f"{1 - busy_us / 1e3 / ms:.3f}" if busy_us else "not measured"
        print(f"train step [{name}] ({_nvidia_smi()}): fused step median {ms:.3f} ms of "
              + " / ".join(f"{t:.3f}" for t in step_ms[name])
              + f" in turns ({TRAIN_BATCH / ms * 1e3:.1f} images/s); device busy "
              f"{busy_us / 1e3:.3f} ms a step, idle share {idle}; peak memory "
              f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above the "
              f"{base / 2**30:.3f} GiB held before the steps)")
    ratio = np.median(step_ms["bfloat16"]) / np.median(step_ms["float32"])
    print(f"train step: bf16 takes {ratio:.3f}x the float32 step's time (medians)")


def _shell_phase(pipe, frames, kernels) -> tuple[int, int]:
    """Phase 14 (see the module docstring). Returns the K1 launches of the
    probe's child and of the traced run."""
    t_phase = time.perf_counter()
    probe_launches = _probe_phase()
    _cache_phase()
    tracks, launches = _trace_phase(pipe, frames, kernels)
    _groundtruth_phase(tracks)
    _bf16_train_phase()
    print(f"phase 14 (operational shell, ground truth, bf16 training) "
          f"{time.perf_counter() - t_phase:.1f} s")
    return probe_launches, launches["nms"]


def _sort_hold(xla, kernels) -> int:
    """Phase 15 (a): the host SORT against K3 with the SORT flags on the
    main path's detections. Returns K3's launches."""
    import torch
    from vbt_tpu_torch.cli.track import run_host_tracker, run_scan_tracker, tracks_to_data
    from vbt_tpu_torch.tracking import SortTracker
    from vbt_tpu_torch.tracking.scan import track_video

    cfg = _k3_cfg("sort", max_age=30, iou_threshold=0.1, max_tracks=16)
    rows, valid = xla["rows"], xla["valid"]
    run_scan_tracker(rows[:BATCH], valid[:BATCH], "cuda", cfg=cfg)  # first launch
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    scan = run_scan_tracker(rows, valid, "cuda", cfg=cfg)
    t_scan = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    want = {"nms": 0, "fused_mbconv": 0, "track_scan": 1, "analysis_scan": 0}
    if launches != want:
        raise AssertionError(f"sort: launches {launches}, want {want}")
    t0 = time.perf_counter()
    host = run_host_tracker(rows, valid, SortTracker(max_age=30, iou_threshold=0.1))
    t_host = time.perf_counter() - t0
    _compare_track_data("sort", tracks_to_data(scan, fps=FPS), tracks_to_data(host, fps=FPS),
                        host_name="SORT")
    dets = torch.from_numpy(np.ascontiguousarray(rows, np.float32)).cuda()
    mask = torch.from_numpy(np.ascontiguousarray(valid)).cuda()
    k3_ms = _cuda_ms(lambda: track_video(cfg, dets, mask), reps=10)
    print(f"sort: {len(rows)} frames: K3 (SORT flags) {k3_ms:.4f} ms by CUDA events, "
          f"{t_scan * 1e3:.3f} ms by the host clock with upload and readback; host SORT "
          f"{t_host * 1e3:.3f} ms ({_nvidia_smi()})")
    _hold_k3("main path detections, sort", cfg, rows[None], valid[None],
             np.ones((1, len(rows)), bool))
    return launches["track_scan"]


def _count_nms(kernels, label, want, fn):
    """Run ``fn`` with K1's count at 0 and hold the count to ``want``."""
    kernels["nms"].launches = 0
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    got = kernels["nms"].launches
    print(f"{label}: {wall:.2f} s, NMS {got} launches")
    if got != want:
        raise AssertionError(f"{label}: NMS launched {got} times, want {want}")
    return out, got


def _hold_soup_decisions(lines: str, members, final, seed) -> None:
    """Phase 15 (b): the soup seeded with the shipped lite0 over phase 13's
    30-step checkpoints. Each ``+`` line's KEEP or drop must follow the
    gate's rule on its printed metric (keep when it does not drop below the
    best so far; a tie within the printed 4 decimals is not judged), at
    least one candidate must be dropped, the members must be the seed and
    the kept lines, and a soup of the seed alone must be the seed's weights
    bit for bit."""
    import torch

    lines = lines.splitlines()
    best = float(lines[0].split()[-1])
    kept, drops = [], 0
    for line in lines[1:]:
        if not line.startswith("+ "):
            continue
        words = line.split()
        value, keep = float(words[words.index("->") + 3]), words[-1] == "[KEEP]"
        if abs(value - best) >= 1e-4 and keep != (value >= best):
            raise AssertionError(f"soup: {line!r} against the best {best}")
        if keep:
            best = value
            step, tag = words[1].split("/")
            kept.append((int(step), tag))
        drops += not keep
    if drops == 0 or list(members[1:]) != kept or members[0][1] != "seed":
        raise AssertionError(f"soup from the seed: members {members}, kept {kept}, "
                             f"{drops} drops")
    if len(members) == 1 and not all(torch.equal(final[k], seed[k].float()) for k in final):
        raise AssertionError("a soup of the seed alone differs from the seed")
    print(f"soup from the seed: {drops} of {drops + len(kept)} candidates dropped, members "
          f"{members}, each decision the gate's rule")


def _selection_phase(frames, xla, kernels) -> tuple[dict, int]:
    """Phase 15 (see the module docstring). Returns K1's launches by tool
    and K3's in (a)."""
    import shutil

    from vbt_tpu_torch.io.synthetic import write_voc
    from vbt_tpu_torch.runtime.checkpoint import load_train_checkpoint, save_train_checkpoint
    from vbt_tpu_torch.tools import _reference, ckpt_sweep
    from vbt_tpu_torch.train.evaluate import EVAL_BATCH

    t_phase = time.perf_counter()
    sort_launches = _sort_hold(xla, kernels)

    # (b) The tools on phase 13's run and a VOC tree laid out as the
    # reference's data under the working directory, read by their default.
    arch = "efficientdet_lite0"
    work = os.path.join(REPO, "out", "chip_smoke_tools")
    shutil.rmtree(work, ignore_errors=True)
    voc, ckpt = os.path.join(work, _reference.DATA_DIR), os.path.join(work, "ckpt")
    sizes = ((240, 320), (360, 480), (288, 512), (480, 640), (720, 1280))
    for part, part_sizes, n in (("train", sizes[:4], 2), ("test", sizes, 3)):
        os.makedirs(os.path.join(voc, part))
        write_voc(os.path.join(voc, part), part_sizes, n=n)
    n_test = len(sizes) * 3
    per_eval = -(-n_test // EVAL_BATCH)
    os.makedirs(ckpt)
    shutil.copy(os.path.join(REPO, "out", "chip_smoke_train", "step_00000001.msgpack"), ckpt)
    trainer, template = ckpt_sweep.selection_trainer(arch, "cuda")
    state = load_train_checkpoint(ckpt, 1, template)
    state, _ = trainer.train_step(state, _check_batches()["cuda"])
    save_train_checkpoint(ckpt, 2, state)

    cwd = os.getcwd()
    os.chdir(work)
    try:
        launches = _selection_tools(arch, ckpt, work, per_eval, frames, kernels)
    finally:
        os.chdir(cwd)
    print(f"phase 15 (checkpoint selection, host SORT) "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches, sort_launches


def _selection_tools(arch, ckpt, work, per_eval, frames, kernels) -> dict:
    """Phase 15 (b) from the directory ``work`` that holds the reference
    tree: each tool with no ``data_dir``. Returns K1's launches by tool."""
    import io

    import torch
    from vbt_tpu_torch.runtime.checkpoint import (load_checkpoint, load_params,
                                                  load_train_checkpoint)
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline
    from vbt_tpu_torch.tools import ckpt_soup, ckpt_sweep, int8_delta

    launches = {}
    out = io.StringIO()
    _, launches["sweep"] = _count_nms(kernels, "ckpt_sweep, 2 checkpoints x raw/ema",
                                      4 * per_eval, lambda: ckpt_sweep.sweep(
                                          arch, ckpt, device="cuda", out=out))
    print(out.getvalue(), end="")
    log = os.path.join(work, "sweep.txt")
    with open(log, "w") as f:
        f.write(out.getvalue())
    soup_path = os.path.join(work, f"{arch}.msgpack")
    out = io.StringIO()
    (final, members, _), launches["soup"] = _count_nms(
        kernels, "ckpt_soup --top_k 3", 3 * per_eval, lambda: ckpt_soup.soup(
            arch, ckpt, log, top_k=3, out=soup_path, device="cuda", stream=out))
    print(out.getvalue(), end="")
    cpu_trainer, cpu_template = ckpt_sweep.selection_trainer(arch, "cpu")
    total = None
    for step, tag in members:
        v = cpu_trainer.variables(load_train_checkpoint(ckpt, step, cpu_template),
                                  use_ema=tag == "ema")
        v = {k: t.to(torch.float64) for k, t in v.items()}
        total = v if total is None else {k: total[k] + v[k] for k in total}
    average = {k: (t / len(members)).to(torch.float32) for k, t in total.items()}
    soup_pipe = DetectionPipeline.from_model_arg(soup_path, device="cuda")
    saved = load_checkpoint(soup_path)
    same = (saved.keys() == average.keys() == final.keys()
            and all(torch.equal(saved[k], average[k]) and torch.equal(final[k], average[k])
                    and torch.equal(soup_pipe.weights[k], average[k]) for k in average))
    det = soup_pipe.detect_batch(frames[:2])
    print(f"soup of {members}: file {os.path.getsize(soup_path)} bytes, reloaded through "
          f"DetectionPipeline: {'bit for bit' if same else 'DIFFERS from'} the float64 average "
          f"on the CPU; detect_batch counts {det.count.tolist()}")
    if not same:
        raise AssertionError("the soup is not the float64 average of its members")
    out = io.StringIO()
    (final, members, _), launches["soup_seed"] = _count_nms(
        kernels, "ckpt_soup --seed_msgpack lite0 --top_k 3", 4 * per_eval,
        lambda: ckpt_soup.soup(arch, ckpt, log, top_k=3, seed_msgpack=CKPT, device="cuda",
                               stream=out))
    print(out.getvalue(), end="")
    _hold_soup_decisions(out.getvalue(), members, final, load_params(CKPT, final))

    out, err = io.StringIO(), io.StringIO()
    (code, m_float, m_int8), launches["int8_delta"] = _count_nms(
        kernels, "int8_delta --calib_n 8", 2 * per_eval, lambda: int8_delta.int8_delta(
            CKPT, calib_n=8, device="cuda", out=out, err=err))
    print(out.getvalue() + err.getvalue(), end="")
    delta75 = m_int8["AP75"] - m_float["AP75"]
    if code != int(delta75 < -0.01) or not m_float["AP50"] > 0.9:
        raise AssertionError(f"int8_delta: exit code {code} for AP75 delta {delta75}, "
                             f"float {m_float}")
    return launches


def _analysis_engines_phase(xla) -> None:
    """Phase 16 (see the module docstring)."""
    import statistics

    import torch
    from vbt_tpu_torch.analysis.phase import CONCENTRIC
    from vbt_tpu_torch.cli.plot import analyze_phases, smooth_track_df
    from vbt_tpu_torch.contract.schema import build_track_df, max_travel_id
    from vbt_tpu_torch.io.synthetic import plate_track_data

    t_phase = time.perf_counter()
    main_df = build_track_df(xla["data"])
    inputs = {
        "phase 4's track":
            main_df.query(f"id == {max_travel_id(main_df)}").drop(columns=["id"]),
        "the plate's exact 60 s track":
            build_track_df(plate_track_data(ANALYSIS_SAMPLES, HEIGHT, WIDTH, PERIOD, FPS))
            .drop(columns=["id"]),
    }
    for label, raw in inputs.items():
        df = smooth_track_df(raw)
        phases, ms = {}, {}
        for engine, device in (("host", "cpu"), ("torch", "cuda")):
            times = []
            for _ in range(ANALYSIS_REPS + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                phases[engine] = analyze_phases(df, PLATE_DIAMETER, engine, device)
                times.append(1e3 * (time.perf_counter() - t0))  # the phases are on the host
            ms[engine] = statistics.median(times[1:])
        if not _same_phases(phases["torch"], phases["host"]):
            raise AssertionError(f"analysis engines on {label}: host {phases['host']}, torch "
                                 f"{phases['torch']}")
        reps = sum(p.type == CONCENTRIC for p in phases["host"])
        print(f"analysis engines [{label}, {len(df)} samples], median of {ANALYSIS_REPS} after "
              f"a warm-up: host {ms['host']:.3f} ms, torch on the card {ms['torch']:.3f} ms "
              f"({ms['torch'] / ms['host']:.1f}x the host, {ms['torch'] / len(df):.4f} ms a "
              f"sample); {len(phases['host'])} phases, the same in both engines, {reps} "
              f"concentric; {_nvidia_smi()}")
        if reps < 4:
            raise AssertionError(f"analysis engines on {label}: {reps} concentric phases")
    print(f"phase 16 {time.perf_counter() - t_phase:.1f} s")


BENCH_LANES = {"plain": [], "int8": ["--int8"], "turbo": ["--turbo"],
               "approx": ["--approx_prefilter"]}
BENCH_TIMEOUT_S = 300  # a lane: the probe's child and the measurement's
TOOL_BATCHES = ["64", "128"]
# Phase 17: the checks' second run reads a reference test set of this many
# write_voc JPEGs at each (height, width).
CHECK_JPEGS, CHECK_JPEGS_EACH = ((240, 320), (480, 640)), 16
# Phase 18: one card as this many devices, beside every card; turns of the timing.
DP_SHARES = (2, 4)
# Phase 19: the slow lane of the JAX package's e2e check, and its track bench.
E2E_REPS, E2E_FPS, E2E_SECONDS = 3, 30.0, 9.0
E2E_BENCH_SECONDS = 60.0
# Each rep, the card's bf16 lane against the CPU's float32 lane on the same
# video: ROM within E2E_ROM_RTOL relative, the duration within
# E2E_DURATION_FRAMES frames; ACV = ROM / duration follows (at most 8.6%
# for the stand-in's 43-frame reps). The first chip run (H100, 700 W)
# measured ROM 8.5e-4 to 3.7e-3 apart, durations 0 to 2 frames and ACV
# 8.5e-4 to 4.3e-2: bf16 moves where a rep starts or ends by a frame or
# two, 2.3% of its duration each.
E2E_ROM_RTOL, E2E_DURATION_FRAMES = 1e-2, 3
DP_TURNS = 2


def _bench_phase(kernels) -> tuple[dict, dict, dict, dict]:
    """Phase 17 (see the module docstring). Returns K1's and K2's launches
    by bench lane (one in-process detect at the bench's batch) and by tool."""
    import functools
    import tempfile

    import torch
    from vbt_tpu_torch import bench
    from vbt_tpu_torch.io.synthetic import write_voc
    from vbt_tpu_torch.ops import _build
    from vbt_tpu_torch.tools import (_reference, int8_profile, perf_probe, prefilter_check,
                                     roofline, turbo_check)

    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=REPO, VBT_TORCH_BUILD_DIR=str(_build.BUILD_DIR))
    for lane, flags in BENCH_LANES.items():
        t0 = time.perf_counter()
        env[bench.RAW_ENV] = os.path.join(REPO, "out", f"chip_smoke_bench_{lane}.json")
        proc = subprocess.run([sys.executable, "-m", "vbt_tpu_torch.bench", *flags], cwd=REPO,
                              env=env, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
        lines = proc.stdout.strip().splitlines()
        line = json.loads(lines[-1]) if lines else {}
        print(f"bench {lane} ({time.perf_counter() - t0:.1f} s, exit {proc.returncode}): "
              f"{json.dumps(line)}")
        if (proc.returncode != 0 or line.get("invalid") or line.get("metric")
                != bench._metric_name(flags) or not line.get("value", 0) > 0
                or not 0 < (line.get("mfu") or 0) <= 1):
            raise AssertionError(f"bench {lane}: {proc.stderr[-4000:]}")

    bench_k1, bench_k2 = {}, {}
    rng = np.random.default_rng(0)
    for lane, flags in BENCH_LANES.items():
        pipe = bench.build_pipeline("--int8" in flags, "--turbo" in flags,
                                    "approx" if "--approx_prefilter" in flags else "exact",
                                    "cuda", rng)
        frames = bench.frame_batches(rng, bench.BATCH, pipe.spec.input_size, "cuda", n=1)[0]
        for k in kernels.values():
            k.launches = 0
        mma = kernels["fused_mbconv"].launches_by_variant["mma"]
        det = pipe.detect_batch(frames)
        torch.cuda.synchronize()
        bench_k1[lane] = kernels["nms"].launches
        bench_k2[lane] = kernels["fused_mbconv"].launches
        by_mma = kernels["fused_mbconv"].launches_by_variant["mma"] - mma
        want_k2 = 5 if lane == "turbo" else 0
        print(f"bench {lane} pipeline, one detect_batch at B = {bench.BATCH}: NMS "
              f"{bench_k1[lane]}, fused MBConv {bench_k2[lane]} ({by_mma} mma), found in "
              f"{int((det.count > 0).sum())} of {bench.BATCH} random frames")
        if bench_k1[lane] != 1 or bench_k2[lane] != want_k2 or by_mma != want_k2 or any(
                k.launches for n, k in kernels.items() if n not in ("nms", "fused_mbconv")):
            raise AssertionError(f"bench {lane} lane's launches: {bench_k1[lane]}, "
                                 f"{bench_k2[lane]} ({by_mma} mma)")

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "vbt_tpu_torch.entry", "--devices",
                           "cuda:0,cuda:0"], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    print(f"python -m vbt_tpu_torch.entry --devices cuda:0,cuda:0 "
          f"({time.perf_counter() - t0:.1f} s, exit {proc.returncode}):\n{proc.stdout.strip()}")
    if proc.returncode != 0 or "entry ok" not in proc.stdout or "dryrun ok" not in proc.stdout:
        raise AssertionError(f"entry: {proc.stderr[-4000:]}")

    # The tools in this process; phase 14 probed the card. The checks run
    # twice: from a directory without the reference tree (the synthetic
    # plates, and the speed half) and from one holding its test set of
    # CHECK_JPEGS (the numerics alone).
    tool_k1, tool_k2 = {}, {}
    with tempfile.TemporaryDirectory() as root, \
            mock.patch.dict(os.environ, {"VBT_TORCH_HEALTH_PROBE": "0"}):
        empty, tree = os.path.join(root, "empty"), os.path.join(root, "tree")
        test_dir = os.path.join(tree, _reference.TEST_DIR)
        os.makedirs(empty)
        os.makedirs(test_dir)
        write_voc(test_dir, CHECK_JPEGS, n=CHECK_JPEGS_EACH)
        n_jpegs = len(CHECK_JPEGS) * CHECK_JPEGS_EACH
        checks = {"turbo_check": turbo_check, "prefilter_check": prefilter_check}
        tools = {
            "roofline": lambda: roofline.main(
                ["--out", os.path.join(REPO, "out", "chip_smoke_roofline.json")]),
            **{name: functools.partial(_run_check, tool, empty, speed=True)
               for name, tool in checks.items()},
            **{f"{name}_jpeg": functools.partial(_run_check, tool, tree, speed=False)
               for name, tool in checks.items()},
            "int8_profile": lambda: int8_profile.main(
                ["--batches", *TOOL_BATCHES, "--out",
                 os.path.join(REPO, "out", "chip_smoke_int8_profile.json")]),
            "perf_probe": lambda: perf_probe.main(["--batches", *TOOL_BATCHES]),
        }
        want_images = {**{name: f"images: {turbo_check.N_IMAGES} (synthetic)" for name in checks},
                       **{f"{name}_jpeg": f"images: {n_jpegs} ({_reference.TEST_DIR})"
                          for name in checks}}
        for name, run in tools.items():
            for k in kernels.values():
                k.launches = 0
            t0 = time.perf_counter()
            out = run()
            tool_k1[name], tool_k2[name] = (kernels["nms"].launches,
                                            kernels["fused_mbconv"].launches)
            print(f"tools.{name} ({time.perf_counter() - t0:.1f} s): NMS {tool_k1[name]} "
                  f"launches, fused MBConv {tool_k2[name]}; {_nvidia_smi()}")
            if name in want_images:
                code, printed = out
                verdict = [json.loads(line[len("JSON: "):])["numerics_ok"] for line in printed
                           if line.startswith("JSON: ")]
                # turbo_check's bf16 budget on the JPEGs is a finding either
                # way (PERF.md §6): its exit code must be its verdict.
                if code != 0 and not (name == "turbo_check_jpeg" and code == 1
                                      and verdict == [False]):
                    raise AssertionError(f"tools.{name} exited {code}")
                if not any(line.startswith(want_images[name]) for line in printed):
                    raise AssertionError(f"tools.{name}: no line {want_images[name]!r}")
            if tool_k1[name] == 0 and name != "int8_profile":
                raise AssertionError(f"tools.{name} launched no NMS")
        if tool_k2["turbo_check"] == 0 or tool_k2["turbo_check_jpeg"] == 0:
            raise AssertionError("tools.turbo_check launched no fused MBConv")
        _turbo_jpeg_lanes(tree)
    print(f"phase 17 {time.perf_counter() - t_phase:.1f} s")
    return bench_k1, bench_k2, tool_k1, tool_k2


def _turbo_jpeg_lanes(tree) -> None:
    """Phase 17: the JPEGs of the reference tree under ``tree`` through
    turbo_check's two backbones on the card in float32 (K2's float32
    kernel), held to its budgets, then in the serving bf16 with every image
    beyond them printed: each lane's confident rows, each with its largest
    IoU with a higher-scored row of the image (K1 suppresses above 0.5)."""
    import torch
    from vbt_tpu_torch.tools import _reference, turbo_check

    lanes = {label: turbo_check.pipelines("cuda", xla={"dtype": dtype},
                                          turbo={"backbone": "turbo", "dtype": dtype})
             for label, dtype in (("float32", torch.float32), ("bf16", None))}
    names = sorted(f for f in os.listdir(os.path.join(tree, _reference.TEST_DIR))
                   if f.endswith(".jpg"))
    cwd = os.getcwd()
    os.chdir(tree)
    try:
        images, _ = turbo_check.test_images(lanes["bf16"]["xla"].spec.input_size)
    finally:
        os.chdir(cwd)
    for label, pipes in lanes.items():
        det = turbo_check.detections(pipes, images)
        r = turbo_check.compare(*det)
        print(f"turbo_check's {len(images)} JPEGs, {label} on the card: count-equal "
              f"{r['count_match']}/{r['images']}, confident max |score d| "
              f"{r['score_delta']:.4g}, max |box d| {r['box_delta']:.4g}, unmatched "
              f"{r['unmatched_confident']}; within the budgets: {r['numerics_ok']}")
        if label == "float32" and not r["numerics_ok"]:
            raise AssertionError("the turbo backbone in float32 leaves the budgets")
        counts, boxes, scores = det
        for i, name in enumerate(names):
            if turbo_check.compare(*({k: v[i:i + 1] for k, v in d.items()}
                                     for d in det))["numerics_ok"]:
                continue
            rows = []
            for lane in ("xla", "turbo"):
                s, b = (a[lane][i, :int(counts[lane][i])] for a in (scores, boxes))
                rows.append(f"{lane} " + ", ".join(
                    f"{s[j]:.4f} (IoU {turbo_check._iou_one_to_many(b[j], b[:j]).max():.4f})"
                    if j else f"{s[j]:.4f}" for j in range(len(s)) if s[j] > turbo_check.CONFIDENT))
            print(f"  {name} beyond the budgets, confident rows: {'; '.join(rows)}")


def _run_check(tool, directory, speed: bool) -> tuple[int, list[str]]:
    """Phase 17: ``tool.main`` (turbo_check or prefilter_check) at
    ``TOOL_BATCHES`` from ``directory``, the speed half cut unless
    ``speed``. Returns its exit code and the lines it printed (echoed)."""
    import contextlib
    import io

    from vbt_tpu_torch.tools import turbo_check

    cwd, buf = os.getcwd(), io.StringIO()
    os.chdir(directory)
    try:
        cut = (contextlib.nullcontext() if speed
               else mock.patch.object(turbo_check, "speed", lambda *a, **k: {}))
        with contextlib.redirect_stdout(buf), cut:
            code = tool.main(["--batches", *TOOL_BATCHES])
    finally:
        os.chdir(cwd)
        print(buf.getvalue(), end="", flush=True)
    return code, buf.getvalue().splitlines()


def _dp_meshes() -> dict:
    """Phase 18's meshes: every card of the machine, and one card as 2 and
    4 devices (``DP_SHARES``), by label."""
    import torch
    from vbt_tpu_torch.parallel.mesh import make_mesh

    cards = make_mesh()
    meshes = {f"make_mesh() ({len(cards)} card{'s' * (len(cards) > 1)})": cards}
    for n in DP_SHARES:
        meshes[f"[cuda:0] * {n}"] = [torch.device("cuda", 0)] * n
    return meshes


def _hold_dp_steps(spec, batch, meshes) -> None:
    """Phase 18 (a): two steps over each mesh against two one-device steps
    on the same card and batch, in float64 and float32 under
    ``TRAIN_BOUNDS``, then in bfloat16: the losses within
    ``TRAIN_BOUNDS["bfloat16"]`` and each group's distance from the
    one-device bf16 state within its factor of the larger of the two
    lanes' own bf16-against-float32 distances, plus the floor."""
    import torch
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline

    ok, states = True, {}
    variables = DetectionPipeline.init_variables(spec, 0)  # Trainer.init_state(seed=0)'s
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        closs, ref, ref_s = _two_steps(spec, "cuda", dtype, batch, variables=variables)
        states["one", name] = ref
        for label, mesh in meshes.items():
            gloss, got, got_s = _two_steps(spec, "cuda", dtype, batch, mesh, variables)
            states[label, name] = got
            loss_rel = max(abs(g - c) / abs(c) for g, c in zip(gloss, closs))
            if name == "bfloat16":
                loss_rtol, factor, floor = TRAIN_BOUNDS[name]
                across = _distances(got, ref)
                own = {lane: _distances(states[lane, name], states[lane, "float32"])
                       for lane in ("one", label)}
                ratios = {g: across[g] / (factor * max(own["one"][g], own[label][g]) + floor)
                          for g in across}
            else:
                loss_rtol = TRAIN_BOUNDS[name][0]
                ratios = _step_ratios(ref, got, TRAIN_BOUNDS[name])
            print(f"dp train step over {label}, lite0 {TRAIN_SIZE}, B = {TRAIN_BATCH}, {name}, "
                  f"against one device (one device {ref_s:.1f} s, mesh {got_s:.1f} s for 2 "
                  f"steps): losses {closs} / {gloss} (max rel {loss_rel:.3g}, bound "
                  f"{loss_rtol}); largest difference over its bound {TRAIN_BOUNDS[name]}: "
                  + ", ".join(f"{k} {v:.3g}" for k, v in ratios.items()))
            ok = ok and loss_rel <= loss_rtol and max(ratios.values()) <= 1
    if not ok:
        raise AssertionError("dp train step: a mesh disagrees with one device beyond the bounds")


def _time_dp_steps(spec, batch, meshes) -> None:
    """Phase 18 (b): the float32 step over each mesh of more than one share
    beside the one-device step, by CUDA events in turns (``DP_TURNS`` turns
    of each order, so twice as many samples each), with the device's busy
    time (``torch.profiler``), idle share and peak memory."""
    import torch
    from vbt_tpu_torch.train.train_step import Trainer

    runs = {}
    for label, mesh in {"one device": None, **meshes}.items():
        if mesh is not None and len(mesh) == 1:
            continue  # the one-device step
        trainer = Trainer(spec, base_lr=TRAIN_CHECK_LR, total_steps=TRAIN_STEPS,
                          warmup_steps=1, input_size=TRAIN_SIZE, device="cuda", mesh=mesh)
        runs[label] = (trainer, trainer.init_state(seed=0))
    step_ms = {label: [] for label in runs}
    for _ in range(DP_TURNS):
        for label in [*runs, *reversed(runs)]:
            trainer, state = runs[label]
            step_ms[label].append(_cuda_ms(lambda: trainer.train_step(state, batch), reps=3,
                                           warmup=1))
    one_ms = float(np.median(step_ms["one device"]))
    for label, (trainer, state) in runs.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            trainer.train_step(state, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        busy_us, _ = _device_profile(lambda: trainer.train_step(state, batch))
        ms = float(np.median(step_ms[label]))
        idle = f"{1 - busy_us / 1e3 / ms:.3f}" if busy_us else "not measured"
        print(f"dp train step [{label}] ({_nvidia_smi()}), float32, B = {TRAIN_BATCH}: median "
              f"{ms:.3f} ms of " + " / ".join(f"{t:.3f}" for t in step_ms[label])
              + f" in turns ({TRAIN_BATCH / ms * 1e3:.1f} images/s, {ms / one_ms:.3f}x the "
              f"one-device step); device busy {busy_us / 1e3:.3f} ms a step, idle share "
              f"{idle}; peak memory {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB "
              f"above the {base / 2**30:.3f} GiB held before the steps)")


def _dp_train_phase(kernels) -> dict:
    """Phase 18 (see the module docstring). Returns each kernel's launches
    in its train steps: none lies on this path."""
    import torch
    from vbt_tpu_torch import entry
    from vbt_tpu_torch.models import get_model_spec
    from vbt_tpu_torch.parallel import data_parallel

    t_phase = time.perf_counter()
    spec = get_model_spec("efficientdet_lite0_whole")
    batch = _check_batches(TRAIN_BATCH, ("cuda",))["cuda"]
    meshes = _dp_meshes()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    _hold_dp_steps(spec, batch, meshes)
    t1 = time.perf_counter()
    _time_dp_steps(spec, batch, meshes)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"kernel launches in the data-parallel steps of phase 18: {launches}; (a) took "
          f"{t1 - t0:.1f} s, (b) {time.perf_counter() - t1:.1f} s")
    if any(launches.values()):
        raise AssertionError(f"dp train steps launched {launches}")
    # (c) The driver's dry run over two shares of the card, in this process:
    # its train step through the global statistics, as many a share.
    calls = {}
    stats = data_parallel.GlobalBatchStats.stats

    def counted(self, share, x):
        calls[share] = calls.get(share, 0) + 1
        return stats(self, share, x)

    data_parallel.GlobalBatchStats.stats = counted
    try:
        entry.dryrun_multichip(2, [torch.device("cuda", 0)] * 2)
    finally:
        data_parallel.GlobalBatchStats.stats = stats
    print(f"dryrun_multichip over [cuda:0] * 2: ok, BatchNorm reductions a share {calls}")
    if sorted(calls) != [0, 1] or calls[0] != calls[1]:
        raise AssertionError(f"dp dry run: reductions {calls}")
    print(f"phase 18 {time.perf_counter() - t_phase:.1f} s")
    return launches


def _e2e_lane(lane, pipe, video, truth, kernels) -> dict:
    """Phase 19 (b): one lane of ``e2e_acv_check`` on the scene's video,
    with every count at 0 before and read after."""
    import torch
    from vbt_tpu_torch.tools import e2e_acv_check

    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    fid, measured = e2e_acv_check.measured_phases(pipe, video)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"e2e [{lane}] ({pipe.device}, {pipe.dtype}, NMS kernel {pipe.use_kernel}): track "
          f"{fid}, {len(measured)} reps, {wall:.2f} s; launches {launches}")
    ok, errors = e2e_acv_check.compare(truth, measured, E2E_REPS)
    print(f"e2e [{lane}]: {'PASS' if ok else 'FAIL'} against the "
          f"{e2e_acv_check.BUDGET:.0%} budget (printed, not held: the stand-in scene's verdict)")
    return {"fid": fid, "measured": measured, "ok": ok, "errors": errors,
            "launches": launches}


def _e2e_tools_phase(kernels) -> dict:
    """Phase 19 (see the module docstring). Returns each kernel's launches
    in (b)'s card lane and (d)."""
    import tempfile

    import torch
    from vbt_tpu_torch.io.synthetic import write_demo_scene
    from vbt_tpu_torch.ops import _build
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline
    from vbt_tpu_torch.tools import e2e_acv_check, make_demo_video, track_e2e_bench

    t_phase = time.perf_counter()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        # (a) The stand-in scene, laid out as the reference's test set.
        data = os.path.join(root, make_demo_video.DATA)
        os.makedirs(data)
        box = write_demo_scene(data, e2e_acv_check.SCENE_IMAGE)
        os.chdir(root)
        try:
            # (b) run_check's pieces on one video, the card's lane and the CPU's.
            video = os.path.join(root, "demo.mp4")
            traj = e2e_acv_check.synthesize_scene(video, E2E_REPS, E2E_FPS, E2E_SECONDS)
            frames = len(traj["time"])
            truth = e2e_acv_check.analytic_phases(traj)
            print(f"e2e scene: {e2e_acv_check.SCENE_IMAGE} (stand-in, plate box {box.tolist()}), "
                  f"{frames} frames, {len(truth)} analytic reps")
            lanes = {lane: _e2e_lane(lane, DetectionPipeline.from_model_arg(CKPT, device=device),
                                     video, truth, kernels)
                     for lane, device in (("card", "cuda"), ("cpu", "cpu"))}
            card, cpu = lanes["card"], lanes["cpu"]
            want = {name: 0 for name in kernels}
            want.update(nms=-(-frames // 64), track_scan=1)  # track_one's batch of 64
            if card["launches"] != want or any(cpu["launches"].values()):
                raise AssertionError(f"e2e launches: card {card['launches']} (want {want}), "
                                     f"cpu {cpu['launches']}")
            if not len(card["measured"]) == len(cpu["measured"]) == E2E_REPS:
                raise AssertionError(f"e2e reps: card {len(card['measured'])}, cpu "
                                     f"{len(cpu['measured'])}, want {E2E_REPS}")
            if card["fid"] != cpu["fid"]:
                raise AssertionError(f"e2e track: card {card['fid']}, cpu {cpu['fid']}")
            worst = np.zeros(3)  # ROM, duration in frames, ACV
            for i, (c, f) in enumerate(zip(card["measured"], cpu["measured"]), 1):
                diff = np.array([abs(c.rom - f.rom) / f.rom,
                                 abs(c.duration - f.duration) * E2E_FPS,
                                 abs(c.rom / c.duration - f.rom / f.duration)
                                 / (f.rom / f.duration)])
                worst = np.maximum(worst, diff)
                print(f"e2e rep {i}: card against cpu: ROM {c.rom:.6f} vs {f.rom:.6f} m "
                      f"({diff[0]:.3e}), duration {c.duration:.4f} vs {f.duration:.4f} s "
                      f"({diff[1]:.2f} frames), ACV {c.rom / c.duration:.6f} vs "
                      f"{f.rom / f.duration:.6f} m/s ({diff[2]:.3e})")
            print(f"e2e card against cpu, largest: ROM {worst[0]:.3e} (bound {E2E_ROM_RTOL}), "
                  f"duration {worst[1]:.2f} frames (bound {E2E_DURATION_FRAMES}), ACV "
                  f"{worst[2]:.3e}")
            if worst[0] > E2E_ROM_RTOL or worst[1] > E2E_DURATION_FRAMES + 1e-6:
                raise AssertionError(f"e2e: the card's reps from the CPU's {worst}")

            # (c) The CLI as a user runs it, from the scene's directory.
            out = os.path.join(root, "e2e_record.json")
            env = dict(os.environ, PYTHONPATH=REPO, VBT_TORCH_BUILD_DIR=str(_build.BUILD_DIR))
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "vbt_tpu_torch.tools.e2e_acv_check", "--device", "cuda",
                 "--reps", str(E2E_REPS), "--seconds", str(E2E_SECONDS), "--model", CKPT,
                 "--out", out],
                cwd=root, env=env, capture_output=True, text=True, timeout=300)
            print(f"python -m vbt_tpu_torch.tools.e2e_acv_check ({time.perf_counter() - t0:.1f}"
                  f" s, exit {proc.returncode}):\n{proc.stdout.strip()}")
            if proc.returncode != (0 if card["ok"] else 1) or not os.path.isfile(out):
                raise AssertionError(f"e2e_acv_check exited {proc.returncode}, the card's "
                                     f"verdict {card['ok']}: {proc.stderr[-4000:]}")
            with open(out) as f:
                serving = json.load(f)["serving"]
            print(f"e2e_acv_check record: serving {serving}")
            if serving["device"] != torch.cuda.get_device_name(0) or not serving["pallas_nms"]:
                raise AssertionError(f"e2e_acv_check serving record {serving}")

            # (d) The track path's wall time with decode, in this process
            # (phase 14 probed the card).
            t0 = time.perf_counter()
            n = len(e2e_acv_check.synthesize_scene(os.path.join(root, "bench.mp4"), 20,
                                                   E2E_FPS, E2E_BENCH_SECONDS)["time"])
            print(f"make_demo_video: {n} frames written in {time.perf_counter() - t0:.2f} s")
            for k in kernels.values():
                k.launches = 0
            with mock.patch.dict(os.environ, {"VBT_TORCH_HEALTH_PROBE": "0"}):
                record = track_e2e_bench.run(seconds=E2E_BENCH_SECONDS, model=CKPT,
                                             device="cuda")
            torch.cuda.synchronize()
            bench_launches = {name: k.launches for name, k in kernels.items()}
            want_bench = {name: 0 for name in kernels}
            want_bench.update(nms=2 * -(-n // 128), track_scan=2)  # the warm and the recorded pass
            print(f"track_e2e_bench launches {bench_launches} ({_nvidia_smi()})")
            if bench_launches != want_bench:
                raise AssertionError(f"track_e2e_bench launches {bench_launches}, want "
                                     f"{want_bench}")
            if record["video"]["frames"] != n or record["df_rows"] < n:
                raise AssertionError(f"track_e2e_bench record {record}")
        finally:
            os.chdir(cwd)
    print(f"phase 19 {time.perf_counter() - t_phase:.1f} s")
    return {name: card["launches"][name] + bench_launches[name] for name in kernels}


def _host_s(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _where_the_time_goes(pipe, turbo, frames) -> None:
    """Phase 7: where the time of one 64-frame batch goes, each backbone."""
    import torch
    from vbt_tpu_torch.ops.preprocess import preprocess_frames

    with torch.inference_mode():
        images = preprocess_frames(pipe._frames(frames[:BATCH]), pipe.spec.input_size,
                                   pipe.dtype)
        fwd = {lane: _cuda_ms(lambda: lane_pipe.run_model(images), reps=10)
               for lane, lane_pipe in (("xla", pipe), ("turbo", turbo))}
    print(f"forward on the device, bf16, B = {BATCH}, mean of 10: xla "
          f"{fwd['xla']:.3f} ms, turbo {fwd['turbo']:.3f} ms")
    for lane, lane_pipe in (("xla", pipe), ("turbo", turbo)):
        _upload_compare(lane, lane_pipe, frames)
        spans = [_stage_spans(lane_pipe, frames[i * BATCH:(i + 1) * BATCH])
                 for i in range(min(3, BATCHES))]
        print(f"stage spans [{lane}] through the pinned ring, ms, median of {len(spans)} batches: "
              + ", ".join(f"{n} {sorted(s[n] for s in spans)[len(spans) // 2]:.3f}"
                          for n in spans[0]))
        _profile(lane, lane_pipe, frames)


if __name__ == "__main__":
    sys.exit(main())
