"""Kernel K3 (``vbt_tpu_torch/csrc/track_scan.cu``) run on the CPU.

A CUDA kernel has no interpret mode, but K3 needs nothing of the card but a
warp: its per-slot arithmetic is ``__host__ __device__`` and the rest uses
shuffles, ballots and ``__syncwarp``. So g++ compiles the source unchanged
against ``_CUDA_ON_THREADS`` below, a header that runs each lane as a
``std::thread``, makes ``__shared__`` a static shared by the 32 threads and
turns every warp primitive into an exchange through a ``std::barrier``;
clips run one after another. The kernel's whole scan then goes against its
plain version (``tracking/scan.py::scan_clips_plain``, float32, CPU) on the
tracker's test scenes and on ragged clips in one launch, with the bounds
``chip_smoke.py`` holds the card to: report, ids and conf exact, boxes
within 1e-6, dxdy within 1e-4 (the kernel's 4x4 inverse and 7x7 products
round in their own order, which the 1e4 initial velocity covariance
amplifies early in a track).

This is the check to run on a change to K3 before the card sees it. It
skips where there is no g++ with C++20 (``std::barrier``).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vbt_tpu_torch.io.synthetic import plate_detections, ragged_clips, tracker_cases  # noqa: E402
from vbt_tpu_torch.ops.track_scan_cuda import (  # noqa: E402
    ASSO, MOMENTUM, RECOVERY, REPORT_OBS, REUPDATE, SKIP_EMPTY)
from vbt_tpu_torch.runtime.batch_runner import pad_clips  # noqa: E402
from vbt_tpu_torch.tracking.scan import ScanTrackerConfig, scan_clips_plain  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "vbt_tpu_torch", "csrc", "track_scan.cu")
BOX_ATOL, DXDY_ATOL = 1e-6, 1e-4

_CUDA_ON_THREADS = r"""
#pragma once
#include <barrier>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__ __restrict
#define __launch_bounds__(x)
struct Dim { int x = 0, y = 0, z = 0; };
thread_local Dim threadIdx, blockIdx;
struct Warp { std::barrier<> bar{32}; uint32_t word[32]; };
inline Warp* g_warp;
inline void __syncwarp(unsigned = 0xffffffffu) { g_warp->bar.arrive_and_wait(); }
template <class T> T exchange(T v, int src) {
  static_assert(sizeof(T) == 4);
  uint32_t bits;
  std::memcpy(&bits, &v, 4);
  g_warp->word[threadIdx.x] = bits;
  __syncwarp();
  bits = g_warp->word[src & 31];
  __syncwarp();
  T out;
  std::memcpy(&out, &bits, 4);
  return out;
}
template <class T> T __shfl_sync(unsigned, T v, int src) { return exchange(v, src); }
template <class T> T __shfl_xor_sync(unsigned, T v, int o) { return exchange(v, threadIdx.x ^ o); }
inline unsigned __ballot_sync(unsigned, int pred) {
  g_warp->word[threadIdx.x] = pred != 0;
  __syncwarp();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (g_warp->word[i] ? 1u : 0u) << i;
  __syncwarp();
  return m;
}
inline int __all_sync(unsigned, int pred) { return __ballot_sync(~0u, pred) == ~0u; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
"""

_HARNESS = r"""
#include "cuda_on_threads.h"
#include "track_scan.cu"
extern "C" void run_clips(const float* dets, const uint8_t* dv, const uint8_t* fv, uint8_t* rep,
                          float* box, int32_t* id, float* conf, float* cls, float* dxdy, int C,
                          int T, int D, int S, int max_age, int min_hits, float thr, int asso,
                          float inertia, int delta_t, int flags) {
  Params prm{T, D, S, max_age, min_hits, asso, delta_t, flags, thr, inertia};
  for (int c = 0; c < C; ++c) {
    Warp warp;
    g_warp = &warp;
    std::vector<std::thread> lanes;
    for (int l = 0; l < 32; ++l)
      lanes.emplace_back([&, l] {
        threadIdx.x = l;
        blockIdx.x = c;
        track_scan_kernel(dets, dv, fv, rep, box, id, conf, cls, dxdy, prm);
      });
    for (auto& t : lanes) t.join();
  }
}
"""


@pytest.fixture(scope="module")
def k3_on_threads(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the kernel for the CPU")
    build = tmp_path_factory.mktemp("k3_on_threads")
    (build / "cuda_on_threads.h").write_text(_CUDA_ON_THREADS)
    (build / "harness.cpp").write_text(_HARNESS)
    lib = build / "libk3.so"
    cmd = [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
           "-I", str(build), "-I", os.path.dirname(SOURCE), str(build / "harness.cpp"),
           "-o", str(lib)]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if done.returncode != 0 and "barrier" in done.stderr and "No such file" in done.stderr:
        pytest.skip("g++ without C++20 <barrier>")
    assert done.returncode == 0, done.stderr
    fn = ctypes.CDLL(str(lib)).run_clips
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int])
    fn.restype = None
    return fn


def _run(fn, cfg, dets, det_valid, frame_valid, skip):
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
    fn(*(a.ctypes.data for a in [dets, *masks, *out]), c, t, d, s, cfg.max_age, cfg.min_hits,
       cfg.iou_threshold, ASSO[cfg.asso], cfg.inertia, cfg.delta_t, flags)
    out[0] = out[0].astype(bool)
    return out


def _hold(fn, cfg, dets, det_valid, frame_valid, skip=True):
    """K3 on threads against the plain version: returns the reported rows."""
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
def test_kernel_on_threads_matches_plain(k3_on_threads, name):
    kind, kw, (dets, valid), skip = tracker_cases()[name]
    cfg = getattr(ScanTrackerConfig, kind)(**kw)
    rows = _hold(k3_on_threads, cfg, dets[None], valid[None],
                 np.ones((1, dets.shape[0]), bool), skip)
    assert rows > 0


def test_kernel_on_threads_ragged_clips(k3_on_threads):
    clips = ragged_clips()
    cfg = ScanTrackerConfig.ocsort(max_age=10, asso="diou", iou_threshold=0.1, max_tracks=8)
    dets, det_valid, frame_valid = pad_clips([d for d, _ in clips], [v for _, v in clips])
    _hold(k3_on_threads, cfg, dets, det_valid, frame_valid)
    batched = _run(k3_on_threads, cfg, dets, det_valid, frame_valid, True)
    for i, (d, v) in enumerate(clips):
        t = d.shape[0]
        single = _run(k3_on_threads, cfg, d[None], v[None], np.ones((1, t), bool), True)
        for b, o in zip(batched, single):
            np.testing.assert_array_equal(b[i, :t], o[0])
        assert not batched[0][i, t:].any()  # padding frames report nothing


def test_kernel_on_threads_at_the_cli_shape(k3_on_threads):
    """The CLI's tracker: D = 25 rows a frame, S = 16 slots, so the
    assignment is 25 x 25, with dropout and jitter over 64 frames."""
    cfg = ScanTrackerConfig.ocsort(max_age=30, asso="diou", iou_threshold=0.1, max_tracks=16)
    dets, valid = plate_detections(64, 3, seed=21, dropout=0.1, jitter=0.006, d_cap=25)
    assert _hold(k3_on_threads, cfg, dets[None], valid[None], np.ones((1, 64), bool)) > 0
