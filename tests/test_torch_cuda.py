"""Tests that need a CUDA card: the NMS, fused-MBConv and scan-tracker
kernels against their plain versions, the served bf16 pipelines (XLA and
turbo backbones) launching them, the pinned upload ring and the torch
analysis lane on the card.

They skip without a card. On the machine with one, run them without the
JAX test configuration (this file imports neither jax nor vbt_tpu):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are the kernels' contracts. NMS: counts exact, scores 1e-6,
boxes 1e-5. Fused MBConv: 2e-4
absolute plus relative in float32 (f32 sums in another order); 2e-2
absolute plus relative in bfloat16, where the other order (the tensor
cores' own in the "mma" kernel) can flip the bf16 rounding of an
intermediate (one step is 2^-8 relative). Scan tracker (K3, float32) on
the card against its plain version on CPU copies of the same inputs:
report, track_id and conf exact, box within 1e-6 (reported observations
are copies; state boxes carry the Kalman update's own rounding) and dxdy
within 1e-4 (the kernel's 4x4 inverse and 7x7 products round in their own
order, which the 1e4 initial covariances amplify early in a track); C
ragged clips in one launch equal to single-clip launches bit for bit. K3
with the state carried: chunk by chunk equal to one launch bit for bit,
final state included; the final state against the plain version's within
the same bounds (covariances relative to 1 + |want|), integer fields
exact; the time-shard relay over one card equal to one launch. The analysis
scan K4 (float64, ``--fmad=false``) against its plain version: events and
carries within 1e-12 relative (the same operations in the same order;
measured bit for bit, on the card and in the CPU build). The int8 lane's
products (``torch._int_mm`` after the zero-padding rule) against the plain
version on CPU copies: bit for bit, int32 accumulators; the int8 lane's top
boxes within 0.05 of the frame of the bf16 lane's (the bound the bf16 lane
is held to against float32). Training: train-mode BatchNorm 1e-5, and two
train steps (float32 and float64) against the CPU port under
``chip_smoke.py``'s phase-13 bounds, and two data-parallel steps over the
card twice against two one-device steps under the same bounds. The bench
in each lane in-process at
B = 16 (a valid line, ``0 < mfu <= 1``, K1 launched, K2 through "mma" in
the turbo lane only) and the entry's dry run over the card twice. The
end-to-end check on its stand-in scene: the card's rep count and track id
equal the CPU port's, K1 and K3 launched once each. ``turbo_check`` and
``prefilter_check`` from a directory holding ``reference/data/test/``: every
JPEG read, the exit code the tool's verdict under its own budgets
(``prefilter_check``'s a pass).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models", "efficientdet_lite0_whole.msgpack")
B, K = 64, 512


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _boxes(rng, b=B, k=K):
    yx = rng.uniform(0.0, 0.8, size=(b, k, 2))
    hw = rng.uniform(0.02, 0.3, size=(b, k, 2))
    return np.concatenate([yx, yx + hw], -1).astype(np.float32)


def _case(name):
    rng = np.random.default_rng(0)
    logits = rng.normal(-2.0, 3.0, size=(B, K)).astype(np.float32)
    boxes, kw = _boxes(rng), {}
    if name == "ties":
        logits[:, ::13] = 3.0
    elif name == "all_suppressed":
        boxes = np.broadcast_to(boxes[:, :1], boxes.shape).copy()
    elif name == "threshold_above_all":
        logits = np.minimum(logits, 6.0)
        kw = {"score_threshold": 0.999}
    elif name == "k300_with_pads":
        logits, boxes = logits[:, :300].copy(), boxes[:, :300].copy()
        logits[:, :20] = -np.inf
        logits[:, 20:40] = -100.0
    elif name == "stops_at_zero":
        logits[:] = -np.inf
        logits[:, [5, 17, 40]] = [1.0, 2.0, 3.0]
    elif name.startswith("tie_"):  # equal top scores at two candidate indices
        logits = np.minimum(logits, 4.0)
        logits[:, [int(v) for v in name.split("_")[1:]]] = 5.0
    elif name == "winner_in_last_slot":
        logits = np.minimum(logits, 4.0)
        logits[:, K - 1] = 6.0
    elif name == "k300_ties_in_last_group":
        logits, boxes = np.minimum(logits[:, :300], 4.0), boxes[:, :300].copy()
        logits[:, 288:] = 5.0
    elif name == "all_equal":
        logits[:] = 1.5
    elif name == "iou_on_threshold":  # IoUs with the winner on and a few ulps around 0.5
        logits = np.minimum(logits, 4.0)
        logits[:, 0] = 6.0
        boxes[:, 0] = [0.0, 0.0, 1.0, 1.0]
        steps = (np.arange(K // 2 - 1) - K // 4).astype(np.float32) * np.float32(2.0 ** -24)
        boxes[:, 1:K // 2, :2] = 0.0
        boxes[:, 1:K // 2, 2] = np.float32(0.5) + steps
        boxes[:, 1:K // 2, 3] = 1.0
    elif name.startswith("iou_threshold_"):  # outside the range the comparison decides in
        kw = {"iou_threshold": float(name.split("_")[-1])}
    return logits, boxes, kw


NMS_CASES = ["random", "ties", "all_suppressed", "threshold_above_all", "k300_with_pads",
             "stops_at_zero", "tie_37_38", "tie_37_53", "tie_37_69", "tie_255_256",
             "winner_in_last_slot", "k300_ties_in_last_group", "all_equal", "iou_on_threshold",
             "iou_threshold_0", "iou_threshold_1e-4"]


@pytest.mark.parametrize("name", NMS_CASES)
def test_nms_kernel_matches_plain(dev, name):
    from vbt_tpu_torch.ops.nms_cuda import nms
    from vbt_tpu_torch.ops.postprocess import nms_plain

    logits, boxes, kw = _case(name)
    logits, boxes = torch.from_numpy(logits).to(dev), torch.from_numpy(boxes).to(dev)
    before = nms.launches
    got = nms(logits, boxes, **kw)
    torch.cuda.synchronize()
    assert nms.launches == before + 1
    want = nms_plain(logits, boxes, **kw)
    assert torch.equal(got[0], want[0])
    assert (got[1] - want[1]).abs().max().item() <= 1e-6
    assert (got[2] - want[2]).abs().max().item() <= 1e-5


def test_nms_kernel_rejects_what_it_cannot_take(dev):
    from vbt_tpu_torch.ops.nms_cuda import nms

    logits = torch.zeros(B, K, device=dev)
    boxes = torch.zeros(B, K, 4, device=dev)
    with pytest.raises(ValueError):
        nms(logits.t().contiguous().t(), boxes)  # not contiguous
    with pytest.raises(ValueError):
        nms(torch.zeros(B, K + 1, device=dev), torch.zeros(B, K + 1, 4, device=dev))
    with pytest.raises(ValueError):
        nms(logits, boxes.cpu())


def test_served_pipeline_launches_kernel(dev):
    from vbt_tpu_torch.io.synthetic import plate_frames
    from vbt_tpu_torch.ops.nms_cuda import nms
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline

    pipe = DetectionPipeline.from_model_arg(CKPT, device=dev)
    assert pipe.dtype == torch.bfloat16 and pipe.use_kernel
    before = nms.launches
    det = pipe.detect_batch(plate_frames(8, 240, 320, seed=3))
    rows, valid = pipe.detections_to_tracker_inputs(det, 0.5)
    assert nms.launches == before + 1
    assert valid[:, 0].all() and np.isfinite(rows).all()


# (Cin, Cmid, Cout, H, W, k, stride): lite0's g1_b1 (stride 1, residual),
# g1_b0 (stride 2) and g2_b1 (k5, stride 1) at 320, as the turbo backbone
# runs them, and lite2's g2_b1 at 448 (Cin 48, the most the "mma" kernel takes).
K2_SHAPES = [(24, 144, 24, 80, 80, 3, 1), (16, 96, 24, 160, 160, 3, 2),
             (40, 240, 40, 40, 40, 5, 1), (48, 288, 48, 56, 56, 5, 1)]
K2_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def _k2_case(dev, shape, dtype, b=4):
    from vbt_tpu_torch.ops.fused_mbconv import FusedBlockParams

    cin, cmid, cout, h, w, k, s = shape
    rng = np.random.default_rng(1)

    def r(*sh, scale=1.0, dt=torch.float32):
        return torch.from_numpy((rng.normal(size=sh) * scale).astype(np.float32)).to(dev, dt)

    p = FusedBlockParams(we=r(cmid, cin, scale=0.3, dt=dtype), be=r(cmid, 1),
                         wd=r(cmid, k * k, scale=0.5), bd=r(cmid, 1),
                         wp=r(cout, cmid, scale=0.2, dt=dtype), bp=r(cout, 1), h=h, w=w,
                         kernel=k, stride=s, residual=s == 1 and cin == cout)
    return r(b, cin, h * w, dt=dtype), p


def _assert_k2_close(got, want, dtype):
    assert got.shape == want.shape and got.dtype == dtype
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= K2_TOL[dtype] * (1 + want.float().abs())).all()), diff.max().item()


# float32 goes to the "fma" kernel and bfloat16 to "mma" by the launch plan's
# rule; "fma" can be asked for in bfloat16.
@pytest.mark.parametrize("dtype,variant,served", [
    (torch.float32, None, "fma"), (torch.bfloat16, None, "mma"),
    (torch.bfloat16, "mma", "mma"), (torch.bfloat16, "fma", "fma")],
    ids=["f32", "bf16", "bf16-mma", "bf16-fma"])
@pytest.mark.parametrize("shape", K2_SHAPES)
def test_fused_mbconv_kernel_matches_plain(dev, shape, dtype, variant, served):
    from vbt_tpu_torch.ops.fused_mbconv import fused_mbconv, fused_mbconv_plain

    x, p = _k2_case(dev, shape, dtype)
    before = fused_mbconv.launches
    by_variant = dict(fused_mbconv.launches_by_variant)
    got = fused_mbconv(x, p, variant)
    torch.cuda.synchronize()
    assert fused_mbconv.launches == before + 1
    assert fused_mbconv.launches_by_variant[served] == by_variant[served] + 1
    _assert_k2_close(got, fused_mbconv_plain(x, p), dtype)


@pytest.mark.parametrize("shape", K2_SHAPES)
def test_fused_mbconv_mma_takes_channels_last(dev, shape):
    """Channels-last input gives the contiguous input's values bit for bit,
    in channels-last memory."""
    from vbt_tpu_torch.ops.fused_mbconv import fused_mbconv

    x, p = _k2_case(dev, shape, torch.bfloat16)
    cin, _, cout, h, w, _, s = shape
    x_cl = x.reshape(4, cin, h, w).contiguous(memory_format=torch.channels_last)
    got, want = fused_mbconv(x_cl, p), fused_mbconv(x, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    ho, wo = -(-h // s), -(-w // s)
    assert got.reshape(4, cout, ho, wo).is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):  # the FMA kernel takes contiguous x only
        fused_mbconv(x_cl, p, variant="fma")


# Ragged channel counts, and Cin past the three k-steps the expand is built
# for (48 is the most, as in lite2).
@pytest.mark.parametrize("shape", [(5, 37, 7, 37, 23, 5, 2), (56, 96, 24, 17, 11, 3, 2),
                                   (64, 96, 64, 17, 11, 3, 1)],
                         ids=["ragged", "cin56", "cin64"])
def test_fused_mbconv_mma_refuses_channels_it_is_not_built_for(dev, shape):
    from vbt_tpu_torch.ops.fused_mbconv import fused_mbconv, fused_mbconv_plain

    x, p = _k2_case(dev, shape, torch.bfloat16)
    with pytest.raises(ValueError):
        fused_mbconv(x, p, variant="mma")
    before = fused_mbconv.launches_by_variant["fma"]
    got = fused_mbconv(x, p)  # the rule sends it to "fma"
    torch.cuda.synchronize()
    assert fused_mbconv.launches_by_variant["fma"] == before + 1
    _assert_k2_close(got, fused_mbconv_plain(x, p), torch.bfloat16)


def test_fused_mbconv_kernel_rejects_what_it_cannot_take(dev):
    from vbt_tpu_torch.ops.fused_mbconv import fused_mbconv

    x, p = _k2_case(dev, K2_SHAPES[0], torch.bfloat16)
    with pytest.raises(ValueError):
        fused_mbconv(x.cpu(), p)  # weights on the card, x on the CPU
    xt = x.reshape(4, 24, 80, 80).transpose(2, 3)  # NCHW shape, not contiguous
    with pytest.raises(ValueError):
        fused_mbconv(xt, p)


def test_turbo_pipeline_launches_both_kernels(dev):
    from vbt_tpu_torch.io.synthetic import plate_frames
    from vbt_tpu_torch.ops.fused_mbconv import fused_mbconv
    from vbt_tpu_torch.ops.nms_cuda import nms
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline

    pipe = DetectionPipeline.from_model_arg(CKPT, device=dev, backbone="turbo")
    assert pipe.dtype == torch.bfloat16 and len(pipe.turbo.fused_names) == 5
    k2, k1 = fused_mbconv.launches, nms.launches
    mma = fused_mbconv.launches_by_variant["mma"]
    det = pipe.detect_batch(plate_frames(8, 240, 320, seed=3))
    rows, valid = pipe.detections_to_tracker_inputs(det, 0.5)
    assert fused_mbconv.launches == k2 + 5 and nms.launches == k1 + 1
    assert fused_mbconv.launches_by_variant["mma"] == mma + 5  # the served bf16 lane
    assert valid[:, 0].all() and np.isfinite(rows).all()


def _k3_cfg(kind, kw):
    from vbt_tpu_torch.tracking.scan import ScanTrackerConfig

    return getattr(ScanTrackerConfig, kind)(**kw)


def _assert_k3_matches_plain(got, want):
    rep = want.report
    assert torch.equal(got.report.cpu(), rep)
    assert torch.equal(got.track_id.cpu()[rep], want.track_id[rep])
    assert torch.equal(got.conf.cpu()[rep], want.conf[rep])
    assert (got.box.cpu()[rep] - want.box[rep]).abs().max().item() <= 1e-6
    assert (got.dxdy.cpu()[rep] - want.dxdy[rep]).abs().max().item() <= 1e-4


def _k3_case_names():
    from vbt_tpu_torch.io.synthetic import tracker_cases

    return sorted(tracker_cases())


@pytest.mark.parametrize("name", _k3_case_names())
def test_track_scan_kernel_matches_plain(dev, name):
    from vbt_tpu_torch.io.synthetic import tracker_cases
    from vbt_tpu_torch.ops.track_scan_cuda import track_scan
    from vbt_tpu_torch.tracking.scan import track_video

    kind, kw, (dets, valid), skip = tracker_cases()[name]
    cfg = _k3_cfg(kind, kw)
    dets = torch.from_numpy(dets.astype(np.float32))
    valid = torch.from_numpy(valid)
    want = track_video(cfg, dets, valid, skip)
    before = track_scan.launches
    got = track_video(cfg, dets.to(dev), valid.to(dev), skip)
    torch.cuda.synchronize()
    assert track_scan.launches == before + 1
    _assert_k3_matches_plain(got, want)


def test_track_scan_clips_equal_single_launches(dev):
    from vbt_tpu_torch.io.synthetic import ragged_clips
    from vbt_tpu_torch.runtime.batch_runner import pad_clips, track_clips
    from vbt_tpu_torch.tracking.scan import track_video

    cfg = _k3_cfg("ocsort", dict(max_age=10, asso="diou", iou_threshold=0.1, max_tracks=8))
    clips = ragged_clips()
    arrays = pad_clips([c[0].astype(np.float32) for c in clips], [c[1] for c in clips])
    batched = track_clips(cfg, *(torch.from_numpy(a).to(dev) for a in arrays))
    want = track_clips(cfg, *(torch.from_numpy(a) for a in arrays))
    _assert_k3_matches_plain(batched, want)
    for i, (d, v) in enumerate(clips):
        single = track_video(cfg, torch.from_numpy(d.astype(np.float32)).to(dev),
                             torch.from_numpy(v).to(dev))
        t = d.shape[0]
        for got, one in zip(batched, single):
            assert torch.equal(got[i, :t], one)
        assert not batched.report[i, t:].any()


def test_track_scan_kernel_rejects_what_it_cannot_take(dev):
    from vbt_tpu_torch.ops.track_scan_cuda import track_scan

    cfg = _k3_cfg("ocsort", {})
    dets = torch.zeros(1, 4, 25, 6, device=dev)
    valid = torch.ones(1, 4, 25, dtype=torch.bool, device=dev)
    frames = torch.ones(1, 4, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        track_scan(cfg, dets.double(), valid, frames)
    with pytest.raises(ValueError):
        track_scan(cfg._replace(max_tracks=33), dets, valid, frames)
    with pytest.raises(ValueError):
        track_scan(cfg, torch.zeros(1, 4, 33, 6, device=dev),
                   torch.ones(1, 4, 33, dtype=torch.bool, device=dev), frames)
    with pytest.raises(ValueError):
        track_scan(cfg, dets.transpose(1, 2).contiguous().transpose(1, 2), valid, frames)
    with pytest.raises(ValueError):
        track_scan(cfg, dets, valid.cpu(), frames)


def test_scan_tracker_of_the_cli_launches_kernel(dev):
    from vbt_tpu_torch.cli.track import run_host_tracker, run_scan_tracker
    from vbt_tpu_torch.io.synthetic import plate_detections
    from vbt_tpu_torch.ops.track_scan_cuda import track_scan

    dets, valid = plate_detections(120, 1, miss={30, 31, 32}, seed=9, d_cap=25)
    before = track_scan.launches
    got = run_scan_tracker(dets, valid, dev)
    assert track_scan.launches == before + 1
    host = run_host_tracker(dets, valid)
    assert (got["report"].sum(1) == host["report"].sum(1)).all()
    assert set(got["track_id"][got["report"]]) == set(host["track_id"][host["report"]])


def test_scan_sort_on_the_card_matches_host_sort(dev):
    """K3 with the SORT flags against the host ``SortTracker`` (float64):
    the same rows and ids, boxes within 1e-6 (``chip_smoke.py``'s
    ``ROW_ATOL``), dx/dy within 1e-2 (its ``HOST_DXDY_ATOL``)."""
    from vbt_tpu_torch.cli.track import run_host_tracker, run_scan_tracker
    from vbt_tpu_torch.io.synthetic import plate_detections
    from vbt_tpu_torch.ops.track_scan_cuda import track_scan
    from vbt_tpu_torch.tracking import SortTracker
    from vbt_tpu_torch.tracking.scan import ScanTrackerConfig

    dets, valid = plate_detections(120, 1, miss={30, 31, 32}, seed=9, d_cap=25)
    cfg = ScanTrackerConfig.sort(max_age=30, iou_threshold=0.1, max_tracks=16)
    before = track_scan.launches
    got = run_scan_tracker(dets, valid, dev, cfg=cfg)
    assert track_scan.launches == before + 1
    want = run_host_tracker(dets, valid, SortTracker(max_age=30, iou_threshold=0.1))
    np.testing.assert_array_equal(got["report"], want["report"])
    rep = want["report"]
    np.testing.assert_array_equal(got["track_id"][rep], want["track_id"][rep])
    np.testing.assert_allclose(got["box"][rep], want["box"][rep], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["dxdy"][rep], want["dxdy"][rep], atol=1e-2, rtol=0)


def test_upload_ring_on_the_card_equals_plain_copy(dev):
    from vbt_tpu_torch.runtime.upload import RING_DEPTH, StagingRing

    ring = StagingRing((4, 72, 128, 3), dev)
    assert all(b.is_pinned() for b in ring.buffers)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, size=(4, 72, 128, 3), dtype=np.uint8)
               for _ in range(2 * RING_DEPTH + 1)]
    uploaded = []
    for frames in batches:
        buf = ring.lend()
        buf[...] = frames
        uploaded.append(ring.upload(buf))
    torch.cuda.synchronize()
    for frames, got in zip(batches, uploaded):
        assert torch.equal(got, torch.from_numpy(frames).to(dev))


def test_analysis_on_the_card_equals_cpu(dev):
    from vbt_tpu_torch.analysis.velocity_torch import analyze_series, to_phase_list

    rng = np.random.default_rng(3)
    n = 300
    t = np.arange(n) / 30.0
    y = 0.5 + 0.2 * np.sin(2 * np.pi * 0.4 * t) + rng.normal(0, 0.002, n)
    x = 0.4 + rng.normal(0, 0.005, n)
    arrays = [t, x, y, np.gradient(x), np.gradient(y), np.full(n, 0.16), np.full(n, 0.28)]
    got = to_phase_list(analyze_series(*arrays, device=dev))
    want = to_phase_list(analyze_series(*arrays, device="cpu"))
    assert len(want) > 0 and [p.type for p in got] == [p.type for p in want]
    for a, b in zip(got, want):
        assert (a.time_start, a.time_end) == (b.time_start, b.time_end)
        assert a.rom == pytest.approx(b.rom, rel=1e-12)


def _chunked_scene():
    from vbt_tpu_torch.io.synthetic import plate_detections

    dets, valid = plate_detections(120, 2, miss=set(range(17, 24)) | set(range(58, 64)),
                                   seed=3, d_cap=25)
    return torch.from_numpy(dets.astype(np.float32)), torch.from_numpy(valid)


@pytest.mark.parametrize("sizes", [7, 64, [50, 3, 67]], ids=["7", "64", "uneven"])
def test_track_scan_state_in_chunks_equals_one_launch(dev, sizes):
    from vbt_tpu_torch.ops.track_scan_cuda import track_scan
    from vbt_tpu_torch.runtime.streaming import track_chunk
    from vbt_tpu_torch.tracking.scan import init_state, scan_clips

    cfg = _k3_cfg("ocsort", dict(max_age=30, asso="diou", iou_threshold=0.1, max_tracks=16))
    dets, valid = _chunked_scene()
    frames = torch.ones(1, dets.shape[0], dtype=torch.bool)
    whole_state, whole = scan_clips(cfg, dets[None].to(dev), valid[None].to(dev),
                                    frames.to(dev), return_state=True)
    edges = list(range(0, 120, sizes)) if isinstance(sizes, int) else list(
        np.cumsum([0, *sizes[:-1]]))
    state, parts = init_state(cfg, 1, torch.float32, dev), []
    before = track_scan.launches
    for a, b in zip(edges, edges[1:] + [120]):
        state, out = track_chunk(cfg, state, dets[a:b].to(dev), valid[a:b].to(dev))
        parts.append(out)
    torch.cuda.synchronize()
    assert track_scan.launches == before + len(edges)
    for i, field in enumerate(whole):
        assert torch.equal(torch.cat([p[i] for p in parts]), field[0])
    for got, want in zip(state, whole_state):
        assert torch.equal(got, want)
    plain_state, _ = scan_clips(cfg, dets[None], valid[None], frames, return_state=True)
    for name, got, want in zip(plain_state._fields, whole_state, plain_state):
        got = got.cpu()
        if not want.dtype.is_floating_point:
            assert torch.equal(got, want), name
        else:
            assert ((got - want).abs() <= 1e-4 * (1 + want.abs())).all(), name


def test_track_scan_fresh_state_in_equals_none(dev):
    from vbt_tpu_torch.ops.track_scan_cuda import track_scan
    from vbt_tpu_torch.tracking.scan import init_state

    cfg = _k3_cfg("ocsort", dict(max_age=30, asso="diou", iou_threshold=0.1, max_tracks=16))
    dets, valid = _chunked_scene()
    args = (cfg, dets[None].to(dev), valid[None].to(dev),
            torch.ones(1, dets.shape[0], dtype=torch.bool, device=dev))
    none = track_scan(*args)
    fresh = track_scan(*args, state=init_state(cfg, 1, torch.float32, dev))
    assert all(torch.equal(a, b) for a, b in zip(none, fresh))
    with pytest.raises(ValueError):  # a state of another layout
        track_scan(*args, state=init_state(cfg, 1, torch.float32, dev)._replace(
            x=torch.zeros(1, 16, 7, dtype=torch.float64, device=dev)))


def test_time_shard_on_one_card_equals_one_launch(dev):
    from vbt_tpu_torch.parallel.time_shard import track_video_time_sharded
    from vbt_tpu_torch.tracking.scan import track_video

    cfg = _k3_cfg("ocsort", dict(max_age=30, asso="diou", iou_threshold=0.1, max_tracks=16))
    dets, valid = _chunked_scene()
    whole = track_video(cfg, dets[:117].to(dev), valid[:117].to(dev))
    sharded = track_video_time_sharded(cfg, dets[:117], valid[:117], [dev] * 4)
    for got, want in zip(sharded, whole):
        assert torch.equal(got, want.cpu())


def _analysis_inputs(seed, n):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 30.0
    y = 0.5 + 0.2 * np.sin(2 * np.pi * 0.4 * t) + rng.normal(0, 0.002, n)
    x = 0.4 + rng.normal(0, 0.005, n)
    cols = [t, x, y, np.gradient(y), np.full(n, 0.16) + rng.normal(0, 0.01, n),
            np.full(n, 0.28) + rng.normal(0, 0.01, n)]
    return [torch.from_numpy(c) for c in cols]


def _assert_rel(got, want, rel=1e-12):
    got = got.cpu()
    if not want.dtype.is_floating_point:
        assert torch.equal(got, want), (got, want)
        return
    same = (got == want) | ((got - want).abs() <= rel * want.abs())
    assert bool(same.all()), (got, want)


@pytest.mark.parametrize("chunk", [7, 64])
def test_analysis_scan_kernel_matches_plain(dev, chunk):
    from vbt_tpu_torch.analysis.smoother_scan import initial_smoother
    from vbt_tpu_torch.analysis.velocity_torch import initial_carry
    from vbt_tpu_torch.ops.analysis_scan_cuda import analysis_chunk_plain, analysis_scan

    cols = _analysis_inputs(5, 150)
    pd = torch.tensor(0.45, dtype=torch.float64)
    got = (initial_smoother(device=dev), initial_carry(device=dev))
    want = (initial_smoother(), initial_carry())
    before = analysis_scan.launches
    for i in range(0, 150, chunk):
        part = [c[i:i + chunk].contiguous() for c in cols]
        *got, got_ev = analysis_scan(pd.to(dev), *got, [c.to(dev) for c in part])
        *want, want_ev = analysis_chunk_plain(pd, *want, part)
        for g, w in zip(got_ev, want_ev):
            _assert_rel(g, w)
        for g_carry, w_carry in zip(got, want):
            for g, w in zip(g_carry, w_carry):
                _assert_rel(g, w)
    assert analysis_scan.launches == before + len(range(0, 150, chunk))


def test_analysis_scan_kernel_rejects_what_it_cannot_take(dev):
    from vbt_tpu_torch.analysis.smoother_scan import initial_smoother
    from vbt_tpu_torch.analysis.velocity_torch import initial_carry
    from vbt_tpu_torch.ops.analysis_scan_cuda import analysis_scan

    cols = [c.to(dev) for c in _analysis_inputs(5, 8)]
    pd = torch.tensor(0.45, dtype=torch.float64, device=dev)
    sm, vc = initial_smoother(device=dev), initial_carry(device=dev)
    with pytest.raises(TypeError):
        analysis_scan(pd, sm, vc, [c.float() for c in cols])
    with pytest.raises(TypeError):
        analysis_scan(pd, initial_smoother(torch.float32, dev), vc, cols)
    with pytest.raises(ValueError):
        analysis_scan(pd, initial_smoother(), vc, cols)


def test_streaming_pipeline_on_the_card_equals_cpu(dev):
    """The stream's tracker (K3, float32) and analysis (K4) on the card
    against the plain versions on the CPU (tracker in float32 there too),
    fed the same detections chunk by chunk."""
    from vbt_tpu_torch.io.synthetic import plate_detections
    from vbt_tpu_torch.runtime.streaming import StreamingPipeline

    dets, valid = plate_detections(200, 1, seed=4, jitter=0.002, d_cap=25)

    class Replay:  # hands out the scene's detections, a chunk at a time
        def __init__(self, device):
            self.device, self.t = torch.device(device), 0

        def detect_batch(self, frames):
            return frames.shape[0]

        def detections_to_tracker_inputs(self, n, threshold):
            self.t += n
            return dets[self.t - n:self.t], valid[self.t - n:self.t]

    lanes = {d: StreamingPipeline(Replay(d), fps=30.0, tracker_dtype=torch.float32)
             for d in (dev, "cpu")}
    for pipe in lanes.values():
        for i in range(0, 200, 64):
            pipe.process_frames(np.zeros((min(64, 200 - i), 1, 1, 3), np.uint8))
    got, want = (lanes[d].phases() for d in (dev, "cpu"))
    assert len(want) > 0 and [p.type for p in got] == [p.type for p in want]
    for a, b in zip(got, want):
        assert (a.time_start, a.time_end) == (b.time_start, b.time_end)
        assert a.rom == pytest.approx(b.rom, rel=1e-9)


def _lite0_int8(dev):
    from vbt_tpu_torch.io.synthetic import plate_frames
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline

    pipe = DetectionPipeline.from_model_arg(CKPT, device=dev)
    frames = plate_frames(8, 240, 320, seed=3)
    return pipe, pipe.calibrate(frames), frames


@pytest.mark.parametrize("batch", [1, 8])
def test_int8_products_on_the_card_equal_plain(dev, batch):
    """Every distinct int8 product of lite0 at 320 (the stem's k = 27, the
    heads' n = 9 and 36, P7's m = 9 at batch 1), captured in the forward."""
    from vbt_tpu_torch.models import quant as q
    from vbt_tpu_torch.ops.preprocess import preprocess_frames

    pipe, qpipe, frames = _lite0_int8(dev)
    seen, launch = {}, q.int8_conv

    def capture(x_q, w_q, stride):
        seen.setdefault((tuple(x_q.shape), tuple(w_q.shape), stride), (x_q, w_q, stride))
        return launch(x_q, w_q, stride)

    q.int8_conv = capture
    try:
        with torch.inference_mode():
            x = torch.from_numpy(frames[:batch]).to(dev)
            qpipe.run_model(preprocess_frames(x, 320, qpipe.dtype))
    finally:
        q.int8_conv = launch
    shapes = {q.gemm_shape(xs, ws, s) for xs, ws, s in seen}
    assert any(k == 27 for _, k, _ in shapes) and {9, 36} <= {n for _, _, n in shapes}
    assert (min(m for m, _, _ in shapes) == 9) == (batch == 1)
    for x_q, w_q, stride in seen.values():
        got = q.int8_conv(x_q, w_q, stride)
        assert got.device.type == "cuda" and got.dtype == torch.int32
        assert torch.equal(got.cpu(), q.int8_conv_plain(x_q.cpu(), w_q.cpu(), stride))


def test_int8_lane_on_the_card(dev):
    """Calibrated lite0: every dense conv through ``_int_mm``, NMS through
    the kernel, the top boxes near the bf16 lane's, the scales float32."""
    from vbt_tpu_torch.models import quant as q
    from vbt_tpu_torch.ops.nms_cuda import nms

    pipe, qpipe, frames = _lite0_int8(dev)
    assert qpipe.dtype == torch.bfloat16 and qpipe.model.backbone.stem.act_scale.dtype == torch.float32
    q.int8_matmul.calls, nms.launches = 0, 0
    got, want = qpipe.detect_batch(frames), pipe.detect_batch(frames)
    # One forward of each lane: the int8 products are the int8 lane's alone.
    assert q.int8_matmul.calls >= len(q.dense_convs(qpipe.model)) and nms.launches == 2
    assert torch.equal(got.count, want.count)
    assert (got.boxes[:, 0] - want.boxes[:, 0]).abs().max().item() <= 0.05
    with pytest.raises(ValueError):
        q.int8_conv(torch.zeros(1, 8, 2, 2, device=dev), qpipe.model.backbone.stem.w_int8, 1)


def test_eval_lane_on_the_card(dev):
    """Images of three sizes, batch 1, through the eval CLI's matching and
    the COCO AP; the staging rings stay within their bound."""
    from vbt_tpu_torch.cli.eval import detection_rows, image_detections
    from vbt_tpu_torch.io.synthetic import plate_boxes, plate_frames
    from vbt_tpu_torch.ops.nms_cuda import nms
    from vbt_tpu_torch.runtime.pipeline import MAX_RINGS, DetectionPipeline
    from vbt_tpu_torch.train.coco_eval import coco_metrics
    from vbt_tpu_torch.train.evaluate import detect_images

    pipe = DetectionPipeline.from_model_arg(CKPT, device=dev)
    images, truth = [], []
    for h, w in ((240, 320), (360, 480), (288, 512), (480, 640), (720, 1280)):
        images += list(plate_frames(2, h, w, seed=h, period=5))
        truth += [b[None] for b in plate_boxes(2, h, w, period=5)]
    nms.launches = 0
    dets = {str(i): image_detections(pipe, img) for i, img in enumerate(images)}
    _, _, ious = detection_rows({str(i): t for i, t in enumerate(truth)}, {"lite0": dets})
    metrics = coco_metrics(detect_images(pipe, images), truth)
    assert nms.launches == 2 * len(images)
    assert sum(iou > 0.5 for iou in ious) == len(images) and metrics["AP50"] > 0.9
    assert len(pipe.rings) <= MAX_RINGS


def test_train_mode_batchnorm_on_the_card_equals_cpu(dev):
    """flax's train-mode BatchNorm (batch statistics, fast biased variance,
    r <- 0.99 r + 0.01 batch) on the card against the CPU: 1e-5."""
    from vbt_tpu_torch.models.conv import BatchNorm

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 24, 40, 40, generator=gen) * 2 + 3
    mods = []
    for device in ("cpu", dev):
        bn = BatchNorm(24).to(device)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 24))
            bn.bias.copy_(torch.linspace(-0.2, 0.2, 24))
            bn.running_mean.zero_()
            bn.running_var.fill_(1.0)
        mods.append((bn.train(), bn(x.to(device)).detach().cpu()))
    (cpu, want), (card, got) = mods
    assert (got - want).abs().max().item() <= 1e-5
    for name in ("running_mean", "running_var"):
        assert (getattr(card, name).cpu() - getattr(cpu, name)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_train_step_on_the_card_equals_cpu(dev, dtype):
    """Two train steps of lite0 at 128 px, B = 4, on the card against the
    CPU port from one state and one batch, under ``chip_smoke.py``'s
    phase-13 bounds: (loss and running statistics relative, the momentum
    trace relative to its largest value, absolute floor), params and EMA
    within the floor plus lr times the trace's bound (the second step moves
    them by lr * trace). float32 gradients of train-mode BatchNorm are
    ill-conditioned (the bound is percents); float64 shows the same step."""
    from vbt_tpu_torch.io.synthetic import plate_boxes, plate_frames
    from vbt_tpu_torch.models import get_model_spec
    from vbt_tpu_torch.train.train_step import Trainer

    rtol, trace_rtol, atol = {"float32": (1e-4, 5e-2, 1e-5), "float64": (1e-9, 1e-7, 1e-12)}[dtype]
    b, size, lr = 4, 128, 0.01
    images = (torch.from_numpy(plate_frames(b, size, size, seed=1)).float() - 127) / 128
    boxes = torch.from_numpy(plate_boxes(b, size, size)).float()[:, None]
    runs = []
    for device in ("cpu", dev):
        trainer = Trainer(get_model_spec("efficientdet_lite0"), base_lr=lr, total_steps=10,
                          warmup_steps=1, input_size=size, dtype=getattr(torch, dtype),
                          device=device)
        state = trainer.init_state(seed=0)
        batch = {"images": images.permute(0, 3, 1, 2).contiguous().to(device),
                 "gt_boxes": boxes.to(device), "gt_valid": torch.ones(b, 1, dtype=torch.bool,
                                                                     device=device)}
        losses = []
        for _ in range(2):
            state, metrics = trainer.train_step(state, batch)
            losses.append(float(metrics["loss"]))
        runs.append((losses, state))
    (closs, cpu), (gloss, card) = runs
    assert card.step == cpu.step == 2
    for g, c in zip(gloss, closs):
        assert abs(g - c) <= rtol * abs(c)
    top = max(t.abs().max().item() for t in cpu.opt_state.trace.values())
    diff = lambda a, k, w: (a[k].cpu() - w).abs().max().item()  # noqa: E731
    for k, want in cpu.opt_state.trace.items():
        assert diff(card.opt_state.trace, k, want) <= trace_rtol * top, k
    for name in ("params", "ema_params"):
        for k, want in getattr(cpu, name).items():
            assert diff(getattr(card, name), k, want) <= atol + lr * trace_rtol * top, k
    for k, want in cpu.batch_stats.items():
        assert diff(card.batch_stats, k, want) <= atol + rtol * want.abs().max().item(), k


LANES = {"plain": {}, "int8": {"int8": True}, "turbo": {"turbo": True},
         "approx": {"prefilter": "approx"}}


@pytest.mark.parametrize("lane", list(LANES))
def test_bench_lane_on_the_card(dev, lane, monkeypatch, tmp_path):
    """``vbt_tpu_torch.bench.main`` at B = 16 in each lane: a valid line with
    ``0 < mfu <= 1``, the card's name and power limit; K1 (and K2 through
    "mma" in the turbo lane) launched."""
    from vbt_tpu_torch import bench
    from vbt_tpu_torch.ops.fused_mbconv import fused_mbconv
    from vbt_tpu_torch.ops.nms_cuda import nms

    monkeypatch.setattr(bench, "BATCH", 16)
    monkeypatch.setenv(bench.RAW_ENV, str(tmp_path / "raw.json"))
    monkeypatch.setenv("VBT_TORCH_HEALTH_PROBE", "0")
    nms.launches = 0
    mma, fma = (fused_mbconv.launches_by_variant[v] for v in ("mma", "fma"))
    line = bench.main(device="cuda", **LANES[lane])
    assert line["value"] > 0 and 0 < line["mfu"] <= 1 and line["batch"] == 16
    assert line["device"] == torch.cuda.get_device_name(0) and line["power_limit_w"] > 0
    assert nms.launches > 0
    assert fused_mbconv.launches_by_variant["fma"] == fma
    assert (fused_mbconv.launches_by_variant["mma"] > mma) == (lane == "turbo")


def test_dryrun_over_one_card_twice(dev):
    from vbt_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(2, devices=[dev, dev])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_data_parallel_step_over_one_card_twice_equals_one_device(dev, dtype):
    """Two ``Trainer(mesh=[dev, dev])`` steps of lite0 at 128 px, B = 4 global,
    against two one-device steps on the card from one state and one batch,
    under the phase-13 bounds (the shares' batch statistics are summed in
    another order, and cuDNN picks its kernels for B = 2); a device other
    than the mesh's first is refused."""
    from vbt_tpu_torch.io.synthetic import plate_boxes, plate_frames
    from vbt_tpu_torch.models import get_model_spec
    from vbt_tpu_torch.train.train_step import Trainer

    rtol, trace_rtol, atol = {"float32": (1e-4, 5e-2, 1e-5), "float64": (1e-9, 1e-7, 1e-12)}[dtype]
    b, size, lr = 4, 128, 0.01
    spec = get_model_spec("efficientdet_lite0")
    images = (torch.from_numpy(plate_frames(b, size, size, seed=1)).float() - 127) / 128
    batch = {"images": images.permute(0, 3, 1, 2).contiguous().to(dev),
             "gt_boxes": torch.from_numpy(plate_boxes(b, size, size)).float()[:, None].to(dev),
             "gt_valid": torch.ones(b, 1, dtype=torch.bool, device=dev)}
    runs = []
    for mesh in (None, [dev, dev]):
        trainer = Trainer(spec, base_lr=lr, total_steps=10, warmup_steps=1, input_size=size,
                          dtype=getattr(torch, dtype), device=dev, mesh=mesh)
        state = trainer.init_state(seed=0)
        losses = []
        for _ in range(2):
            state, metrics = trainer.train_step(state, batch)
            losses.append(float(metrics["loss"]))
        runs.append((losses, state))
    (oloss, one), (dloss, dp) = runs
    assert dp.step == one.step == 2
    for g, c in zip(dloss, oloss):
        assert abs(g - c) <= rtol * abs(c)
    top = max(t.abs().max().item() for t in one.opt_state.trace.values())
    diff = lambda a, k, w: (a[k] - w).abs().max().item()  # noqa: E731
    for k, want in one.opt_state.trace.items():
        assert diff(dp.opt_state.trace, k, want) <= trace_rtol * top, k
    for name in ("params", "ema_params"):
        for k, want in getattr(one, name).items():
            assert diff(getattr(dp, name), k, want) <= atol + lr * trace_rtol * top, k
    for k, want in one.batch_stats.items():
        assert diff(dp.batch_stats, k, want) <= atol + rtol * want.abs().max().item(), k
    with pytest.raises(ValueError, match="mesh's first device"):
        Trainer(spec, input_size=size, device="cpu", mesh=[dev, dev])


def test_e2e_check_on_the_card_matches_cpu(dev, tmp_path, monkeypatch):
    """``tools.e2e_acv_check`` on the stand-in scene at 1 rep / 15 fps / 2 s:
    the card's lane (bf16, K1 and K3) finds the CPU port's reps and picks
    its ``max_travel_id`` track."""
    pytest.importorskip("cv2")
    pytest.importorskip("pandas")
    from vbt_tpu_torch.io.synthetic import write_demo_scene
    from vbt_tpu_torch.ops.nms_cuda import nms
    from vbt_tpu_torch.ops.track_scan_cuda import track_scan
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline
    from vbt_tpu_torch.tools import e2e_acv_check, make_demo_video

    monkeypatch.setattr(make_demo_video, "DATA", str(tmp_path))
    write_demo_scene(str(tmp_path), e2e_acv_check.SCENE_IMAGE)
    video = str(tmp_path / "demo.mp4")
    traj = e2e_acv_check.synthesize_scene(video, reps=1, fps=15.0, seconds=2.0)
    got = {}
    for device in ("cpu", "cuda"):
        nms.launches = track_scan.launches = 0
        pipe = DetectionPipeline.from_model_arg(CKPT, device=device)
        fid, phases = e2e_acv_check.measured_phases(pipe, video)
        got[device] = (fid, len(phases), nms.launches, track_scan.launches)
        ok, errors = e2e_acv_check.run_check(video, traj, 1, pipeline=pipe, verbose=False)
        assert len(errors) == 1, errors
    assert got["cuda"][:2] == got["cpu"][:2] and got["cpu"][1] == 1
    assert got["cpu"][2:] == (0, 0) and got["cuda"][2:] == (1, 1)  # 30 frames: one batch


@pytest.mark.parametrize("tool_name", ["turbo_check", "prefilter_check"])
def test_checks_read_a_test_tree_on_the_card(dev, tool_name, tmp_path, monkeypatch, capsys):
    """``tools.turbo_check`` and ``tools.prefilter_check`` from a directory
    holding ``reference/data/test/`` (write_voc JPEGs at two sizes): every
    image read and the source named; ``prefilter_check`` exits 0 (approx is
    the exact top-K), ``turbo_check`` with its printed verdict (one of these
    480x640 frames leaves its bf16 budget through the xla lane's NMS, a
    finding of PERF.md); the speed half at B = 16 with its loops cut."""
    pytest.importorskip("cv2")
    import importlib

    from vbt_tpu_torch.io.synthetic import write_voc
    from vbt_tpu_torch.tools import _reference, turbo_check

    tool = importlib.import_module(f"vbt_tpu_torch.tools.{tool_name}")
    test_dir = tmp_path / _reference.TEST_DIR
    test_dir.mkdir(parents=True)
    write_voc(str(test_dir), ((240, 320), (480, 640)), n=4)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("VBT_TORCH_HEALTH_PROBE", "0")
    for name, value in (("N_SHORT", 1), ("N_LONG", 3), ("TRIALS", 1)):
        monkeypatch.setattr(turbo_check, name, value)
    monkeypatch.setattr(tool, "TRIALS", 1)
    code = tool.main(["--batches", "16"])
    lines = capsys.readouterr().out.splitlines()
    assert f"images: 8 ({_reference.TEST_DIR})" in "\n".join(lines)
    if tool is turbo_check:
        (record,) = [line for line in lines if line.startswith("JSON: ")]
        assert code == (0 if json.loads(record[len("JSON: "):])["numerics_ok"] else 1)
    else:
        assert code == 0 and lines[-1] == "PASS"
