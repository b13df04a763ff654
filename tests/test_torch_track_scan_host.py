"""Kernel K3 (``csrc/track_scan.cu``) runs on the CPU, its 32 lanes as fibers.

A CUDA kernel has no interpret mode, but K3 needs nothing of the card but a
warp: its per-slot arithmetic is ``__host__ __device__`` and the rest uses
shuffles, ballots and ``__syncwarp``. So g++ compiles the source unchanged
against ``tests/torch_cuda_on_host.py``'s header, which runs the lanes of a
warp as user-level contexts on one OS thread, in a fixed-seed random order
between two barriers, and turns every warp primitive into an exchange
between barriers; clips run one after another. The kernel's whole scan
then goes against its plain version (``tracking/scan.py::scan_clips_plain``,
float32, CPU) on the tracker's test scenes and on ragged clips in one
launch, with the bounds ``chip_smoke.py`` holds the card to: report, ids and
conf exact, boxes within 1e-6, dxdy within 1e-4 (the kernel's 4x4 inverse
and 7x7 products round in their own order, which the 1e4 initial velocity
covariance amplifies early in a track).

K3's state in and out is held the same way: the scan run chunk by chunk
with the state carried equals one launch bit for bit, final state included,
and that final state equals the plain version's within the same bounds
(integer fields exact).

Two tests hold the harness itself: a toy kernel in which lane i reads lane
i + 1's ``__shared__`` word gives the expected vector with a ``__syncwarp``
between the write and the read, and another one without it under some lane
order; a barrier that not every lane reaches is reported, not hung on.

This is the check to run on a change to K3 before the card sees it (K4's is
``tests/test_torch_analysis_scan_host.py``). It skips where there is no g++
or no ``<ucontext.h>``.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cuda_on_host import build, k3_on_host, pointers  # noqa: E402,F401
from vbt_tpu_torch.io.synthetic import plate_detections, ragged_clips, tracker_cases  # noqa: E402
from vbt_tpu_torch.ops.track_scan_cuda import (  # noqa: E402
    ASSO, MOMENTUM, RECOVERY, REPORT_OBS, REUPDATE, SKIP_EMPTY)
from vbt_tpu_torch.runtime.batch_runner import pad_clips  # noqa: E402
from vbt_tpu_torch.tracking.scan import (  # noqa: E402
    ScanTrackerConfig, TrackerState, init_state, scan_clips_plain)

BOX_ATOL, DXDY_ATOL = 1e-6, 1e-4

_TOY = r"""
#include "cuda_on_fibers.h"
// Lane i writes its __shared__ word, then reads lane (i + 1)'s; with
// ``sync`` a __syncwarp between the two. ``diverge`` sends lane 0 past the
// final barrier.
__global__ void neighbour(int* out, int base, int sync, int diverge) {
  __shared__ int word[32];
  word[threadIdx.x] = base + threadIdx.x;
  if (sync) __syncwarp();
  out[threadIdx.x] = word[(threadIdx.x + 1) & 31];
  if (diverge && threadIdx.x == 0) return;
  __syncwarp();
}
extern "C" int run_neighbour(int* out, int base, int sync, int diverge) {
  auto body = [&] { neighbour(out, base, sync, diverge); };
  return fibers::launch(body, 0);
}
"""


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    lib = build(tmp_path_factory.mktemp("toy_on_host"), "toy", _TOY)
    lib.run_neighbour.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.run_neighbour.restype = ctypes.c_int
    lib.set_lane_seed.argtypes = [ctypes.c_ulonglong]
    return lib


def _neighbour(toy, seed, base, sync, diverge=False):
    toy.set_lane_seed(seed)
    out = np.full(32, -1, np.int32)
    fault = toy.run_neighbour(out.ctypes.data, base, sync, diverge)
    return out, fault


def _want(base):
    return base + (np.arange(32) + 1) % 32


def test_harness_catches_a_missing_syncwarp(toy):
    """With the barrier every lane order gives lane i the word lane i + 1
    wrote in this launch; without it some order reads a word before it is
    written (a stale value of the launch before)."""
    for seed in range(8):
        out, fault = _neighbour(toy, seed, 1000 * (seed + 1), True)
        assert fault == 0
        np.testing.assert_array_equal(out, _want(1000 * (seed + 1)))
    differs = 0
    for seed in range(8):
        out, fault = _neighbour(toy, seed, 1000 * (seed + 101), False)
        assert fault == 0
        differs += not np.array_equal(out, _want(1000 * (seed + 101)))
    assert differs > 0


def test_harness_reports_a_barrier_some_lanes_miss(toy):
    _, fault = _neighbour(toy, 0x5EED, 7, True, diverge=True)
    assert fault == 1
    out, fault = _neighbour(toy, 0x5EED, 9, True)  # the next launch starts afresh
    assert fault == 0
    np.testing.assert_array_equal(out, _want(9))


def _run(fn, cfg, dets, det_valid, frame_valid, skip, state=None, return_state=False):
    """K3 on the host: the six outputs as numpy arrays, and with
    ``return_state`` the final state (a float32 ``TrackerState`` on the CPU)
    after them."""
    dets = np.ascontiguousarray(dets, np.float32)
    c, t, d, _ = dets.shape
    s = cfg.max_tracks
    out = [np.zeros((c, t, s), np.uint8), np.zeros((c, t, s, 4), np.float32),
           np.zeros((c, t, s), np.int32), np.zeros((c, t, s), np.float32),
           np.zeros((c, t, s), np.float32), np.zeros((c, t, s, 2), np.float32)]
    masks = [np.ascontiguousarray(m, np.uint8) for m in (det_valid, frame_valid)]
    flags = (MOMENTUM * cfg.use_momentum | RECOVERY * cfg.use_recovery
             | REUPDATE * cfg.use_reupdate | REPORT_OBS * cfg.report_observation
             | SKIP_EMPTY * skip)
    final = None
    if return_state:  # the fresh state's layout, overwritten by the kernel
        final = TrackerState(*(torch.full_like(f, 7) for f in init_state(cfg, c)))
    fault = fn(*(a.ctypes.data for a in [dets, *masks, *out]), c, t, d, s, cfg.max_age,
               cfg.min_hits, cfg.iou_threshold, ASSO[cfg.asso], cfg.inertia, cfg.delta_t, flags,
               pointers(state), pointers(final))
    assert fault == 0, "the lanes disagreed on their barriers"
    out[0] = out[0].astype(bool)
    return out + [final] if return_state else out


def _hold(fn, cfg, dets, det_valid, frame_valid, skip=True):
    """K3 on the host against the plain version: returns the reported rows."""
    report, box, track_id, conf, cls, dxdy = _run(fn, cfg, dets, det_valid, frame_valid, skip)
    want = scan_clips_plain(cfg, torch.from_numpy(np.asarray(dets, np.float32)),
                            torch.from_numpy(det_valid), torch.from_numpy(frame_valid), skip)
    rep = want.report.numpy()
    np.testing.assert_array_equal(report, rep)
    np.testing.assert_array_equal(track_id[rep], want.track_id.numpy()[rep])
    np.testing.assert_array_equal(conf[rep], want.conf.numpy()[rep])
    np.testing.assert_array_equal(cls[rep], want.cls.numpy()[rep])
    np.testing.assert_allclose(box[rep], want.box.numpy()[rep], atol=BOX_ATOL, rtol=0)
    np.testing.assert_allclose(dxdy[rep], want.dxdy.numpy()[rep], atol=DXDY_ATOL, rtol=0)
    return int(rep.sum())


@pytest.mark.parametrize("name", sorted(tracker_cases()))
def test_kernel_on_threads_matches_plain(k3_on_host, name):
    kind, kw, (dets, valid), skip = tracker_cases()[name]
    cfg = getattr(ScanTrackerConfig, kind)(**kw)
    rows = _hold(k3_on_host, cfg, dets[None], valid[None],
                 np.ones((1, dets.shape[0]), bool), skip)
    assert rows > 0


def test_kernel_on_threads_ragged_clips(k3_on_host):
    clips = ragged_clips()
    cfg = ScanTrackerConfig.ocsort(max_age=10, asso="diou", iou_threshold=0.1, max_tracks=8)
    dets, det_valid, frame_valid = pad_clips([d for d, _ in clips], [v for _, v in clips])
    _hold(k3_on_host, cfg, dets, det_valid, frame_valid)
    batched = _run(k3_on_host, cfg, dets, det_valid, frame_valid, True)
    for i, (d, v) in enumerate(clips):
        t = d.shape[0]
        single = _run(k3_on_host, cfg, d[None], v[None], np.ones((1, t), bool), True)
        for b, o in zip(batched, single):
            np.testing.assert_array_equal(b[i, :t], o[0])
        assert not batched[0][i, t:].any()  # padding frames report nothing


def test_kernel_on_threads_at_the_cli_shape(k3_on_host):
    """The CLI's tracker: D = 25 rows a frame, S = 16 slots, so the
    assignment is 25 x 25, with dropout and jitter over 64 frames."""
    cfg = ScanTrackerConfig.ocsort(max_age=30, asso="diou", iou_threshold=0.1, max_tracks=16)
    dets, valid = plate_detections(64, 3, seed=21, dropout=0.1, jitter=0.006, d_cap=25)
    assert _hold(k3_on_host, cfg, dets[None], valid[None], np.ones((1, 64), bool)) > 0


# -- the state in and out ---------------------------------------------------------

N_FRAMES = 80
_SCENE_MISSES = set(range(17, 24)) | set(range(38, 43))  # across 20-frame chunk edges


def _chunks(t, sizes):
    """Chunk boundaries: ``sizes`` an int (equal chunks) or a list of lengths."""
    if isinstance(sizes, int):
        sizes = [sizes] * -(-t // sizes)
    edges = np.cumsum([0, *sizes])
    return [(a, min(b, t)) for a, b in zip(edges[:-1], edges[1:]) if a < t]


def _assert_states(got, want, exact):
    """Integer and bool fields exact; float fields bit for bit (``exact``)
    or within the bounds of a kernel against its plain version: positions
    (the boxes, observations, Kalman centers) BOX_ATOL, the Kalman
    velocities and covariances DXDY_ATOL relative to 1 + |want| (the
    covariances reach 1e4)."""
    for name, g, w in zip(TrackerState._fields, got, want):
        g, w = np.asarray(g), np.asarray(w)
        if exact or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif name in ("x", "frozen_x"):
            np.testing.assert_allclose(g[..., :4], w[..., :4], atol=BOX_ATOL, rtol=0, err_msg=name)
            np.testing.assert_allclose(g[..., 4:], w[..., 4:], atol=DXDY_ATOL, rtol=0,
                                       err_msg=name)
        elif name in ("p", "frozen_p"):
            assert (np.abs(g - w) <= DXDY_ATOL * (1 + np.abs(w))).all(), name
        else:
            np.testing.assert_allclose(g, w, atol=BOX_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("kind", ["ocsort", "sort"])
@pytest.mark.parametrize("sizes", [7, 20, [30, 3, 47]], ids=["7", "20", "uneven"])
def test_kernel_on_threads_in_chunks_equals_one_launch(k3_on_host, kind, sizes):
    """K3 run chunk by chunk with the state carried equals one launch bit
    for bit, outputs and final state; the final state equals the plain
    version's within the kernel's bounds."""
    cfg = (ScanTrackerConfig.ocsort(max_age=30, iou_threshold=0.1, asso="diou", max_tracks=8)
           if kind == "ocsort" else ScanTrackerConfig.sort(max_age=30, max_tracks=8))
    dets, valid = plate_detections(N_FRAMES, 2, miss=_SCENE_MISSES, seed=3, d_cap=4)
    dets, valid = dets[None], valid[None]
    frames = np.ones((1, N_FRAMES), bool)
    *whole, whole_state = _run(k3_on_host, cfg, dets, valid, frames, True, return_state=True)
    state, parts = init_state(cfg, 1), []
    for a, b in _chunks(N_FRAMES, sizes):
        *out, state = _run(k3_on_host, cfg, dets[:, a:b], valid[:, a:b], frames[:, a:b],
                           True, state=state, return_state=True)
        parts.append(out)
    for i, field in enumerate(whole):
        np.testing.assert_array_equal(np.concatenate([p[i] for p in parts], axis=1), field)
    _assert_states(state, whole_state, exact=True)
    want_state, _ = scan_clips_plain(cfg, torch.from_numpy(dets.astype(np.float32)),
                                     torch.from_numpy(valid), torch.from_numpy(frames),
                                     return_state=True)
    _assert_states(whole_state, want_state, exact=False)
    assert int(want_state.next_id[0]) >= 3  # both plates were born


def test_kernel_on_threads_fresh_state_in_equals_none(k3_on_host):
    """``init_state`` given as the state equals no state, bit for bit."""
    cfg = ScanTrackerConfig.ocsort(max_age=30, asso="diou", iou_threshold=0.1, max_tracks=16)
    dets, valid = plate_detections(24, 3, seed=21, dropout=0.1, jitter=0.006, d_cap=25)
    args = (cfg, dets[None], valid[None], np.ones((1, 24), bool), True)
    none = _run(k3_on_host, *args)
    fresh = _run(k3_on_host, *args, state=init_state(cfg, 1))
    for a, b in zip(none, fresh):
        np.testing.assert_array_equal(a, b)
