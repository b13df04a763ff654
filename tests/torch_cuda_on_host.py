"""Build the port's warp kernels with g++ and run them on the CPU.

A CUDA kernel has no interpret mode, but K3 (``csrc/track_scan.cu``) needs
nothing of the card but one warp, and K4 (``csrc/analysis_scan.cu``) is one
thread. g++ compiles both sources unchanged against :data:`CUDA_ON_FIBERS`:
the CUDA qualifiers are defined away, ``__shared__`` is a static, and the
32 lanes of a warp run as user-level contexts (``<ucontext.h>``) on one OS
thread. ``threadIdx``/``blockIdx`` are plain globals that the scheduler
sets on every switch. ``__syncwarp`` marks the running lane arrived and
switches to the next lane of the round that has not arrived; when the last
one arrives a new round begins. Within each round the lanes run in a
permutation drawn from a fixed-seed generator, so a missing ``__syncwarp``
shows as a wrong result while every run stays deterministic. Shuffles and
ballots are exchanges through one word a lane between two barriers.

A lane whose body returns passes to the next lane of the round, or back to
the launcher after the last. A launch in which some lanes returned while
others wait at a barrier (on the card: a ``__syncwarp`` that not every
lane of its mask reaches) returns 1 instead of hanging.

The test modules import the fixtures :func:`k3_on_host` and
:func:`k4_on_host`; both skip where there is no g++ or no ``<ucontext.h>``.
"""

import ctypes
import os
import shutil
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "vbt_tpu_torch", "csrc")

CUDA_ON_FIBERS = r"""
#pragma once
#include <cstdint>
#include <cstring>
#include <ucontext.h>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__ __restrict
#define __launch_bounds__(x)
struct Dim { int x = 0, y = 0, z = 0; };
inline Dim threadIdx, blockIdx;

namespace fibers {
constexpr int kLanes = 32;
constexpr size_t kStack = 256 * 1024;
struct Warp {
  ucontext_t launcher, ctx[kLanes];
  char* stack[kLanes] = {};  // allocated once per process
  uint32_t word[kLanes];
  int order[kLanes];         // this round's permutation of the lanes
  int pos = 0;               // the running lane's place in it
  bool arrived[kLanes], done[kLanes];
  uint64_t rng = 0;
  int fault = 0;
  void (*body)(void*) = nullptr;
  void* arg = nullptr;
};
inline Warp warp;
inline uint64_t seed = 0x5eedull;

inline uint64_t next_random() {  // splitmix64
  uint64_t z = (warp.rng += 0x9e3779b97f4a7c15ull);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

inline void new_round() {
  for (int i = 0; i < kLanes; ++i) { warp.order[i] = i; warp.arrived[i] = false; }
  for (int i = kLanes - 1; i > 0; --i) {  // Fisher-Yates
    int j = static_cast<int>(next_random() % static_cast<uint64_t>(i + 1));
    int t = warp.order[i]; warp.order[i] = warp.order[j]; warp.order[j] = t;
  }
  warp.pos = 0;
}

// Leave the running lane (arrived at a barrier, or done) for the next lane
// of the round that has not arrived; after the round's last lane, start a
// new round, or return to the launcher when every lane is done.
inline void schedule() {
  const int self = threadIdx.x;
  int next = -1;
  for (int p = warp.pos + 1; p < kLanes && next < 0; ++p) {
    const int l = warp.order[p];
    if (!warp.arrived[l] && !warp.done[l]) { warp.pos = p; next = l; }
  }
  if (next < 0) {
    int n_done = 0;
    for (int l = 0; l < kLanes; ++l) n_done += warp.done[l];
    if (n_done > 0) {  // all returned, or a barrier that some lanes miss
      warp.fault = n_done != kLanes;
      swapcontext(&warp.ctx[self], &warp.launcher);
      return;
    }
    new_round();
    next = warp.order[0];
  }
  threadIdx.x = next;
  if (next != self) swapcontext(&warp.ctx[self], &warp.ctx[next]);
  threadIdx.x = self;
}

inline void lane_main() {
  warp.body(warp.arg);
  warp.done[threadIdx.x] = true;
  schedule();  // never comes back
}

// Run body() as the 32 lanes of one warp; returns 0, or 1 when the lanes
// disagreed on their barriers.
template <class F> int launch(F& body, uint64_t launch_seed) {
  warp.body = [](void* p) { (*static_cast<F*>(p))(); };
  warp.arg = &body;
  warp.rng = seed ^ (launch_seed * 0x2545f4914f6cdd1dull);
  warp.fault = 0;
  for (int l = 0; l < kLanes; ++l) {
    if (warp.stack[l] == nullptr) warp.stack[l] = new char[kStack];
    getcontext(&warp.ctx[l]);
    warp.ctx[l].uc_stack.ss_sp = warp.stack[l];
    warp.ctx[l].uc_stack.ss_size = kStack;
    warp.ctx[l].uc_link = nullptr;
    makecontext(&warp.ctx[l], lane_main, 0);
    warp.done[l] = false;
  }
  new_round();
  threadIdx.x = warp.order[0];
  swapcontext(&warp.launcher, &warp.ctx[warp.order[0]]);
  return warp.fault;
}
}  // namespace fibers

extern "C" void set_lane_seed(unsigned long long s) { fibers::seed = s; }

inline void __syncwarp(unsigned = 0xffffffffu) {
  fibers::warp.arrived[threadIdx.x] = true;
  fibers::schedule();
}
template <class T> T exchange(T v, int src) {
  static_assert(sizeof(T) == 4);
  uint32_t bits;
  std::memcpy(&bits, &v, 4);
  fibers::warp.word[threadIdx.x] = bits;
  __syncwarp();
  bits = fibers::warp.word[src & 31];
  __syncwarp();
  T out;
  std::memcpy(&out, &bits, 4);
  return out;
}
template <class T> T __shfl_sync(unsigned, T v, int src) { return exchange(v, src); }
template <class T> T __shfl_xor_sync(unsigned, T v, int o) { return exchange(v, threadIdx.x ^ o); }
inline unsigned __ballot_sync(unsigned, int pred) {
  fibers::warp.word[threadIdx.x] = pred != 0;
  __syncwarp();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (fibers::warp.word[i] ? 1u : 0u) << i;
  __syncwarp();
  return m;
}
inline int __all_sync(unsigned, int pred) { return __ballot_sync(~0u, pred) == ~0u; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
"""

K3_HARNESS = r"""
#include "cuda_on_fibers.h"
#include "track_scan.cu"
extern "C" int run_clips(const float* dets, const uint8_t* dv, const uint8_t* fv, uint8_t* rep,
                         float* box, int32_t* id, float* conf, float* cls, float* dxdy, int C,
                         int T, int D, int S, int max_age, int min_hits, float thr, int asso,
                         float inertia, int delta_t, int flags, void* const* state_in,
                         void* const* state_out) {
  Params prm{T, D, S, max_age, min_hits, asso, delta_t, flags, thr, inertia};
  const State in = state_from(state_in), out = state_from(state_out);
  for (int c = 0; c < C; ++c) {
    blockIdx.x = c;
    auto body = [&] {
      track_scan_kernel(dets, dv, fv, rep, box, id, conf, cls, dxdy, in, out, prm);
    };
    if (fibers::launch(body, c)) return 1;
  }
  return 0;
}
"""

K4_HARNESS = r"""
#include "cuda_on_fibers.h"
#include "analysis_scan.cu"
extern "C" void run_chunk(void* const* inputs, const double* pd, int n, void* const* s_in,
                          void* const* v_in, void* const* s_out, void* const* v_out,
                          void* const* events) {
  analysis_scan_kernel(ref_from<InputRef>(inputs), pd, n, ref_from<SmootherRef>(s_in),
                       ref_from<VelocityRef>(v_in), ref_from<SmootherRef>(s_out),
                       ref_from<VelocityRef>(v_out), ref_from<EventRef>(events));
}
"""


def build(tmp_dir, name: str, harness: str):
    """g++ the ``harness`` source (which includes ``cuda_on_fibers.h`` and a
    source of ``csrc/``) into ``lib<name>.so`` in ``tmp_dir`` and load it;
    skips the calling test where there is no g++ or no ``<ucontext.h>``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the kernel for the CPU")
    (tmp_dir / "cuda_on_fibers.h").write_text(CUDA_ON_FIBERS)
    (tmp_dir / f"{name}.cpp").write_text(harness)
    lib = tmp_dir / f"lib{name}.so"
    cmd = [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared", "-I",
           str(tmp_dir), "-I", CSRC, str(tmp_dir / f"{name}.cpp"), "-o", str(lib)]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if done.returncode != 0 and "ucontext.h" in done.stderr and "No such file" in done.stderr:
        pytest.skip("no <ucontext.h> to run a warp's lanes as contexts")
    assert done.returncode == 0, done.stderr
    return ctypes.CDLL(str(lib))


def pointers(tensors):
    """A ``void*`` array of the tensors' data pointers, or None."""
    return None if tensors is None else (ctypes.c_void_p * len(tensors))(
        *(t.data_ptr() for t in tensors))


@pytest.fixture(scope="module")
def k3_on_host(tmp_path_factory):
    """K3's ``run_clips``: every clip one warp on fibers; returns 0, or 1
    when the lanes disagreed on their barriers."""
    fn = build(tmp_path_factory.mktemp("k3_on_host"), "k3", K3_HARNESS).run_clips
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def k4_on_host(tmp_path_factory):
    """K4's ``run_chunk``: the one-thread kernel as a plain function."""
    fn = build(tmp_path_factory.mktemp("k4_on_host"), "k4", K4_HARNESS).run_chunk
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
    fn.restype = None
    return fn
