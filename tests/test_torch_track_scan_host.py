"""Kernels K3 (``csrc/track_scan.cu``) and K4 (``csrc/analysis_scan.cu``) run on the CPU.

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

K3's state in and out is held the same way: the scan run chunk by chunk
with the state carried equals one launch bit for bit, final state included,
and that final state equals the plain version's within the same bounds
(integer fields exact).

K4 is one thread and uses nothing of the card, so g++ compiles its source
unchanged with the CUDA qualifiers defined away and the kernel runs as a
plain function on host memory, chunk after chunk with both carries
carried, against its plain version (``ops/analysis_scan_cuda.py::analysis_chunk_plain``)
in float64: every event and both carries bit for bit (the source and the
plain version do the same operations in the same order, FMA contraction
off).

This is the check to run on a change to K3 or K4 before the card sees it.
It skips where there is no g++ with C++20 (``std::barrier``).
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
from vbt_tpu_torch.tracking.scan import (  # noqa: E402
    ScanTrackerConfig, TrackerState, init_state, scan_clips_plain)

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
                          float inertia, int delta_t, int flags, void* const* state_in,
                          void* const* state_out) {
  Params prm{T, D, S, max_age, min_hits, asso, delta_t, flags, thr, inertia};
  const State in = state_from(state_in), out = state_from(state_out);
  for (int c = 0; c < C; ++c) {
    Warp warp;
    g_warp = &warp;
    std::vector<std::thread> lanes;
    for (int l = 0; l < 32; ++l)
      lanes.emplace_back([&, l] {
        threadIdx.x = l;
        blockIdx.x = c;
        track_scan_kernel(dets, dv, fv, rep, box, id, conf, cls, dxdy, in, out, prm);
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
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 2)
    fn.restype = None
    return fn


def _pointers(state):
    return None if state is None else (ctypes.c_void_p * len(state))(
        *(t.data_ptr() for t in state))


def _run(fn, cfg, dets, det_valid, frame_valid, skip, state=None, return_state=False):
    """K3 on threads: the six outputs as numpy arrays, and with
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
    fn(*(a.ctypes.data for a in [dets, *masks, *out]), c, t, d, s, cfg.max_age, cfg.min_hits,
       cfg.iou_threshold, ASSO[cfg.asso], cfg.inertia, cfg.delta_t, flags, _pointers(state),
       _pointers(final))
    out[0] = out[0].astype(bool)
    return out + [final] if return_state else out


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
def test_kernel_on_threads_in_chunks_equals_one_launch(k3_on_threads, kind, sizes):
    """K3 run chunk by chunk with the state carried equals one launch bit
    for bit, outputs and final state; the final state equals the plain
    version's within the kernel's bounds."""
    cfg = (ScanTrackerConfig.ocsort(max_age=30, iou_threshold=0.1, asso="diou", max_tracks=8)
           if kind == "ocsort" else ScanTrackerConfig.sort(max_age=30, max_tracks=8))
    dets, valid = plate_detections(N_FRAMES, 2, miss=_SCENE_MISSES, seed=3, d_cap=4)
    dets, valid = dets[None], valid[None]
    frames = np.ones((1, N_FRAMES), bool)
    *whole, whole_state = _run(k3_on_threads, cfg, dets, valid, frames, True, return_state=True)
    state, parts = init_state(cfg, 1), []
    for a, b in _chunks(N_FRAMES, sizes):
        *out, state = _run(k3_on_threads, cfg, dets[:, a:b], valid[:, a:b], frames[:, a:b],
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


def test_kernel_on_threads_fresh_state_in_equals_none(k3_on_threads):
    """``init_state`` given as the state equals no state, bit for bit."""
    cfg = ScanTrackerConfig.ocsort(max_age=30, asso="diou", iou_threshold=0.1, max_tracks=16)
    dets, valid = plate_detections(24, 3, seed=21, dropout=0.1, jitter=0.006, d_cap=25)
    args = (cfg, dets[None], valid[None], np.ones((1, 24), bool), True)
    none = _run(k3_on_threads, *args)
    fresh = _run(k3_on_threads, *args, state=init_state(cfg, 1))
    for a, b in zip(none, fresh):
        np.testing.assert_array_equal(a, b)


# -- K4: the analysis scan ----------------------------------------------------------

K4_SOURCE = os.path.join(REPO, "vbt_tpu_torch", "csrc", "analysis_scan.cu")
_K4_HARNESS = r"""
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(x)
#include "analysis_scan.cu"
extern "C" void run_chunk(void* const* inputs, const double* pd, int n, void* const* s_in,
                          void* const* v_in, void* const* s_out, void* const* v_out,
                          void* const* events) {
  analysis_scan_kernel(ref_from<InputRef>(inputs), pd, n, ref_from<SmootherRef>(s_in),
                       ref_from<VelocityRef>(v_in), ref_from<SmootherRef>(s_out),
                       ref_from<VelocityRef>(v_out), ref_from<EventRef>(events));
}
"""


@pytest.fixture(scope="module")
def k4_on_host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the kernel for the CPU")
    build = tmp_path_factory.mktemp("k4_on_host")
    (build / "harness.cpp").write_text(_K4_HARNESS)
    lib = build / "libk4.so"
    cmd = [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared", "-I",
           os.path.dirname(K4_SOURCE), str(build / "harness.cpp"), "-o", str(lib)]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    fn = ctypes.CDLL(str(lib)).run_chunk
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
    fn.restype = None
    return fn


def _k4_chunk(fn, pd, smoother, carry, cols):
    """One chunk through the kernel on host memory -> (smoother, carry, events)."""
    from vbt_tpu_torch.analysis.smoother_scan import SmootherCarry
    from vbt_tpu_torch.analysis.velocity_torch import EventRecord, VelocityCarry

    n = cols[0].shape[0]
    s_out = SmootherCarry(*(torch.empty_like(t) for t in smoother))
    v_out = VelocityCarry(*(torch.empty_like(t) for t in carry))
    dtypes = (torch.bool, torch.int32) + (torch.float64,) * 7
    events = EventRecord(*(torch.empty(n, dtype=d) for d in dtypes))
    fn(_pointers(cols), pd.data_ptr(), n, _pointers(smoother), _pointers(carry),
       _pointers(s_out), _pointers(v_out), _pointers(events))
    return s_out, v_out, events


def _fuzz_series(seed, n):
    """A noisy sinusoidal bar path (the fuzz of tests/test_velocity_jax.py)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 30.0
    y = 0.5 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.1, 0.6) * t) + rng.normal(0, 0.002, n)
    x = 0.4 + rng.normal(0, 0.005, n)
    nph = np.full(n, 0.16) + rng.normal(0, 0.01, n)
    npw = np.full(n, 0.28) + rng.normal(0, 0.01, n)
    return [t, x, y, np.gradient(y), nph, npw]


@pytest.mark.parametrize("chunk", [7, 64])
def test_analysis_kernel_on_host_matches_plain(k4_on_host, chunk):
    from vbt_tpu_torch.analysis.smoother_scan import initial_smoother
    from vbt_tpu_torch.analysis.velocity_torch import initial_carry
    from vbt_tpu_torch.ops.analysis_scan_cuda import analysis_chunk_plain

    series = [torch.from_numpy(np.ascontiguousarray(c)) for c in _fuzz_series(11, 200)]
    pd = torch.tensor(0.45, dtype=torch.float64)
    got = want = (initial_smoother(), initial_carry())
    fired = 0
    for i in range(0, 200, chunk):
        cols = [c[i:i + chunk].contiguous() for c in series]
        *got, got_ev = _k4_chunk(k4_on_host, pd, *got, cols)
        *want, want_ev = analysis_chunk_plain(pd, *want, cols)
        for g, w in zip(got_ev, want_ev):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
        fired += int(want_ev.fired.sum())
        for g_carry, w_carry in zip(got, want):
            for g, w in zip(g_carry, w_carry):
                torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert fired >= 4  # phases ended inside the series
