// K3: the whole scan tracker (SORT / OC-SORT) over every frame of every
// clip, one warp a clip, in one launch.
//
// Replaces what XLA compiled from vbt_tpu/tracking/scan.py::track_video and
// vbt_tpu/runtime/batch_runner.py::track_clips (the vmapped lax.scan of
// tracker_step); it has no Pallas counterpart. The plain version is
// vbt_tpu_torch/tracking/scan.py::scan_clips_plain, and every decision here
// follows it: rows inserted in order and the first-index argmin in the
// Hungarian, the first True of the thresholded affinity in the SORT
// shortcut, births in detection order from the running id counter.
//
// A clip's tracker state can come in from global memory and go back out
// (State, the layout of TrackerState): a video then runs in chunks, one
// launch each, with the state of one chunk's end as the next one's start.
// Without a state in, a clip starts from the fresh state, as before; the
// state goes out only where the caller asks for it. A chunked run equals
// one launch bit for bit: the state is copied, never recomputed.
//
// What bounds it: not bytes (a frame reads 25 x 6 floats and writes 16 x 11
// values) nor operations (a few thousand a frame), but the serial chain of
// T frame steps, each a chain of dependent steps inside: predict, cost,
// assignment (a Dijkstra per row), OCR, ORU replay, update, births. A
// frame's step cannot start before the previous one ends. The design keeps
// that chain short and on one SM: the frame loop runs inside the kernel, so
// a video costs one launch and no host round trip; a clip's state lives in
// shared memory (about 30 KB); a lane takes a slot (predict, update,
// replay, report) or a detection row (cost) or a column (Hungarian), so
// each phase is one pass of 32 lanes; reductions are shuffles and ballots,
// never block barriers; clips run in parallel, a block each.
//
// The per-slot arithmetic is __host__ __device__ so that a C++ compiler can
// check a step on the CPU; tests/test_torch_track_scan_host.py compiles this
// file with g++ against a header that runs each lane as a thread and holds
// the whole scan against the plain version. The file is built with
// --fmad=false: separate
// multiplies and adds round as torch's CPU kernels do, so the affinities,
// costs and reported observations equal the plain version's bit for bit.
// The Kalman update (a 4x4 inverse by LU, the 7x7 products) sums in its own
// order, so dxdy and the state boxes differ from the plain version by a few
// float32 rounding steps, amplified early in a track by the 1e4 initial
// covariances.

#include <cstdint>
#include <cmath>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif

namespace {

constexpr int kMaxSlots = 32;   // S <= 32: a lane a slot
constexpr int kMaxDets = 32;    // D <= 32: a lane a detection row
constexpr int kMaxDeltaT = 8;
constexpr int kDimX = 7;
constexpr int kP = kDimX * kDimX;
constexpr int kRingStride = kMaxDeltaT * 5 + 1;  // odd strides: no bank conflicts
constexpr int kAgeStride = kMaxDeltaT + 1;
constexpr int kRow = kMaxSlots + 1;
constexpr float kInvalidCost = 1e4f;
constexpr float kInf = INFINITY;
constexpr unsigned kFull = 0xffffffffu;

enum Asso { kIou = 0, kDiou = 1 };
enum Flags { kMomentum = 1, kRecovery = 2, kReupdate = 4, kReportObs = 8, kSkipEmpty = 16 };

// ---- per-slot arithmetic (host and device) ----------------------------------

HD float fmax_(float a, float b) { return a > b ? a : b; }
HD float fmin_(float a, float b) { return a < b ? a : b; }

HD void bbox_to_z(const float* b, float* z) {
  float w = b[2] - b[0];
  float h = b[3] - b[1];
  z[0] = b[0] + w / 2.0f;
  z[1] = b[1] + h / 2.0f;
  z[2] = w * h;
  z[3] = w / h;
}

HD void state_bbox(const float* x, float* b) {
  float w = sqrtf(fmax_(x[2] * x[3], 0.0f));
  float h = w > 0.0f ? x[2] / w : 0.0f;
  b[0] = x[0] - w / 2.0f;
  b[1] = x[1] - h / 2.0f;
  b[2] = x[0] + w / 2.0f;
  b[3] = x[1] + h / 2.0f;
}

HD float iou(const float* d, const float* t) {
  float xx1 = fmax_(d[0], t[0]), yy1 = fmax_(d[1], t[1]);
  float xx2 = fmin_(d[2], t[2]), yy2 = fmin_(d[3], t[3]);
  float inter = fmax_(xx2 - xx1, 0.0f) * fmax_(yy2 - yy1, 0.0f);
  float area_d = (d[2] - d[0]) * (d[3] - d[1]);
  float area_t = (t[2] - t[0]) * (t[3] - t[1]);
  return inter / (area_d + area_t - inter + 1e-10f);
}

// IoU, or DIoU (IoU minus the squared center distance over the enclosing
// box's squared diagonal, mapped to [0, 1]).
HD float affinity(int asso, const float* d, const float* t) {
  float v = iou(d, t);
  if (asso == kIou) return v;
  float ex1 = fmin_(d[0], t[0]), ey1 = fmin_(d[1], t[1]);
  float ex2 = fmax_(d[2], t[2]), ey2 = fmax_(d[3], t[3]);
  float dcx = (d[0] + d[2]) / 2.0f, dcy = (d[1] + d[3]) / 2.0f;
  float tcx = (t[0] + t[2]) / 2.0f, tcy = (t[1] + t[3]) / 2.0f;
  float center = (dcx - tcx) * (dcx - tcx) + (dcy - tcy) * (dcy - tcy);
  float diag = (ex2 - ex1) * (ex2 - ex1) + (ey2 - ey1) * (ey2 - ey1);
  float diou = v - center / (diag + 1e-10f);
  return (diou + 1.0f) / 2.0f;
}

// OC-SORT momentum: (pi/2 - |angle between the track's direction and the
// direction from its reference observation to the detection|) / pi.
HD float direction_consistency(const float* d, const float* prev, const float* vel) {
  if (!(prev[4] >= 0.0f)) return 0.0f;
  float dcx = (d[0] + d[2]) / 2.0f, dcy = (d[1] + d[3]) / 2.0f;
  float pcx = (prev[0] + prev[2]) / 2.0f, pcy = (prev[1] + prev[3]) / 2.0f;
  float dy = dcy - pcy, dx = dcx - pcx;
  float norm = sqrtf(dx * dx + dy * dy) + 1e-6f;
  dy = dy / norm;
  dx = dx / norm;
  float c = vel[0] * dy + vel[1] * dx;
  c = fmin_(fmax_(c, -1.0f), 1.0f);
  return (1.5707963267948966f - fabsf(acosf(c))) / 3.141592653589793f;
}

HD void speed_direction(const float* b1, const float* b2, float* out) {
  float cx1 = (b1[0] + b1[2]) / 2.0f, cy1 = (b1[1] + b1[3]) / 2.0f;
  float cx2 = (b2[0] + b2[2]) / 2.0f, cy2 = (b2[1] + b2[3]) / 2.0f;
  float dy = cy2 - cy1, dx = cx2 - cx1;
  float norm = sqrtf(dx * dx + dy * dy) + 1e-6f;
  out[0] = dy / norm;
  out[1] = dx / norm;
}

HD void initial_state(const float* z, float* x, float* p) {
  for (int i = 0; i < kDimX; ++i) x[i] = i < 4 ? z[i] : 0.0f;
  for (int i = 0; i < kP; ++i) p[i] = 0.0f;
  for (int i = 0; i < kDimX; ++i) p[i * kDimX + i] = i < 4 ? 10.0f : 1e4f;
}

// x' = F x, P' = F P F^T + Q with F the constant-velocity transition (cx,
// cy, s advance by their velocities). The sums are associated as torch's
// einsum does them: (P_il + P_(i+4)l) + (P_i(l+4) + P_(i+4)(l+4)).
HD void kf_predict(float* x, float* p) {
  if (x[6] + x[2] <= 0.0f) x[6] = 0.0f;
  x[0] = x[0] + x[4];
  x[1] = x[1] + x[5];
  x[2] = x[2] + x[6];
  const float q[kDimX] = {1.0f, 1.0f, 1.0f, 1.0f, 0.01f, 0.01f, 1e-4f};
  float fp[kP];  // F P
  for (int i = 0; i < kDimX; ++i)
    for (int l = 0; l < kDimX; ++l)
      fp[i * kDimX + l] = i < 3 ? p[i * kDimX + l] + p[(i + 4) * kDimX + l] : p[i * kDimX + l];
  for (int i = 0; i < kDimX; ++i)
    for (int l = 0; l < kDimX; ++l) {
      float v = l < 3 ? fp[i * kDimX + l] + fp[i * kDimX + l + 4] : fp[i * kDimX + l];
      p[i * kDimX + l] = i == l ? v + q[i] : v;
    }
}

// 4x4 inverse: LU with partial pivoting (the reciprocal of the pivot scales
// the column below it), then forward and back substitution on the identity.
HD void inv4(const float* s, float* out) {
  float a[16];
  int piv[4];
  for (int i = 0; i < 16; ++i) a[i] = s[i];
  for (int j = 0; j < 4; ++j) {
    int pr = j;
    float best = fabsf(a[j * 4 + j]);
    for (int i = j + 1; i < 4; ++i)
      if (fabsf(a[i * 4 + j]) > best) { best = fabsf(a[i * 4 + j]); pr = i; }
    piv[j] = pr;
    if (pr != j)
      for (int k = 0; k < 4; ++k) { float t = a[j * 4 + k]; a[j * 4 + k] = a[pr * 4 + k]; a[pr * 4 + k] = t; }
    float r = 1.0f / a[j * 4 + j];
    for (int i = j + 1; i < 4; ++i) a[i * 4 + j] = a[i * 4 + j] * r;
    for (int i = j + 1; i < 4; ++i)
      for (int k = j + 1; k < 4; ++k) a[i * 4 + k] = a[i * 4 + k] - a[i * 4 + j] * a[j * 4 + k];
  }
  for (int i = 0; i < 16; ++i) out[i] = (i / 4 == i % 4) ? 1.0f : 0.0f;
  for (int j = 0; j < 4; ++j)
    if (piv[j] != j)
      for (int k = 0; k < 4; ++k) {
        float t = out[j * 4 + k]; out[j * 4 + k] = out[piv[j] * 4 + k]; out[piv[j] * 4 + k] = t;
      }
  for (int k = 0; k < 4; ++k)
    for (int i = k + 1; i < 4; ++i)
      for (int c = 0; c < 4; ++c) out[i * 4 + c] = out[i * 4 + c] - out[k * 4 + c] * a[i * 4 + k];
  for (int k = 3; k >= 0; --k) {
    for (int c = 0; c < 4; ++c) out[k * 4 + c] = out[k * 4 + c] / a[k * 4 + k];
    for (int i = 0; i < k; ++i)
      for (int c = 0; c < 4; ++c) out[i * 4 + c] = out[i * 4 + c] - out[k * 4 + c] * a[i * 4 + k];
  }
}

// The standard Kalman update with z = [cx, cy, s, r], H = [I4 | 0],
// R = diag(1, 1, 10, 10): K = P H^T S^-1, x += K y, P = (I - K H) P.
HD void kf_update(float* x, float* p, const float* z) {
  const float r[4] = {1.0f, 1.0f, 10.0f, 10.0f};
  float y[4], s[16], si[16], k[kDimX * 4];
  for (int i = 0; i < 4; ++i) y[i] = z[i] - x[i];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) s[i * 4 + j] = i == j ? p[i * kDimX + j] + r[i] : p[i * kDimX + j];
  inv4(s, si);
  for (int i = 0; i < kDimX; ++i)
    for (int l = 0; l < 4; ++l) {
      float acc = p[i * kDimX] * si[l];
      for (int j = 1; j < 4; ++j) acc = acc + p[i * kDimX + j] * si[j * 4 + l];
      k[i * 4 + l] = acc;
    }
  for (int i = 0; i < kDimX; ++i) {
    float acc = k[i * 4] * y[0];
    for (int l = 1; l < 4; ++l) acc = acc + k[i * 4 + l] * y[l];
    x[i] = x[i] + acc;
  }
  float pn[kP];
  for (int i = 0; i < kDimX; ++i)
    for (int c = 0; c < kDimX; ++c) {
      float acc = 0.0f;
      for (int j = 0; j < kDimX; ++j) {
        float a = (i == j ? 1.0f : 0.0f) - (j < 4 ? k[i * 4 + j] : 0.0f);
        acc = acc + a * p[j * kDimX + c];
      }
      pn[i * kDimX + c] = acc;
    }
  for (int i = 0; i < kP; ++i) p[i] = pn[i];
}

// ---- the warp's state -----------------------------------------------------------

struct Clip {
  float x[kMaxSlots][kDimX];
  float p[kMaxSlots][kP];
  float frozen_x[kMaxSlots][kDimX];
  float frozen_p[kMaxSlots][kP];
  float last_obs[kMaxSlots][5];
  float vel[kMaxSlots][2];
  float ring[kMaxSlots][kRingStride];  // [delta_t][5] observations by age
  int ring_age[kMaxSlots][kAgeStride];
  float trk_box[kMaxSlots][4];
  float k_obs[kMaxSlots][5];
  float det[kMaxDets][7];
  float aff[kMaxDets][kRow];  // round-1 affinity, then the OCR round's
  float cost[kMaxSlots][kRow];  // the n x n assignment problem
  float u[kMaxSlots];  // row potentials
  int col_of_row[kMaxSlots];
  int slot_det[kMaxSlots];
  int det_of_rank[kMaxDets];
  int taken[kMaxSlots];
};

// Slot's reference observation delta_t..1 frames back (the largest found
// wins), else its last observation.
__device__ __forceinline__ void k_previous_obs(const Clip& sh, int s, int age, int delta_t,
                                               float* out) {
  for (int i = 0; i < 5; ++i) out[i] = sh.last_obs[s][i];
  for (int dt = 1; dt <= delta_t; ++dt) {
    int want = age - dt;
    int slot = ((want % delta_t) + delta_t) % delta_t;
    if (want >= 0 && sh.ring_age[s][slot] == want)
      for (int i = 0; i < 5; ++i) out[i] = sh.ring[s][slot * 5 + i];
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmax_(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// hungarian_jax on sh.cost (n x n): lane j holds column j's potential v,
// its owner row, minv and predecessor; the argmin is a shuffle reduction
// that keeps the first index on ties. Loops end as soon as the algorithm
// does (no fixed trip count). Result in sh.col_of_row.
__device__ void hungarian(Clip& sh, int n, int lane) {
  float v = 0.0f;
  int roc = -1;  // row_of_col[lane]
  if (lane < n) sh.u[lane] = 0.0f;
  __syncwarp();
  for (int i = 0; i < n; ++i) {
    int roc_n = i;  // the virtual column n holds row i
    float minv = kInf;
    int way = n;
    bool used = false;
    int j0 = n;
    while (true) {
      int i0 = j0 == n ? roc_n : __shfl_sync(kFull, roc, j0);
      if (i0 == -1) break;
      if (lane == j0) used = true;
      float ui0 = sh.u[i0];
      float masked = kInf;
      if (lane < n) {
        float cur = sh.cost[i0][lane] - ui0 - v;
        if (!used && cur < minv) { minv = cur; way = j0; }
        if (!used) masked = minv;
      }
      float best = masked;
      int j1 = lane;
      for (int o = 16; o > 0; o >>= 1) {
        float ob = __shfl_xor_sync(kFull, best, o);
        int oj = __shfl_xor_sync(kFull, j1, o);
        if (ob < best || (ob == best && oj < j1)) { best = ob; j1 = oj; }
      }
      const float delta = best;
      __syncwarp();  // every lane has read u[i0]
      // Used columns' owner rows and row i gain delta; used columns lose it;
      // unreached columns shrink their minv.
      if (lane < n && used) sh.u[roc] = sh.u[roc] + delta;
      if (lane == 0) sh.u[i] = sh.u[i] + delta;
      if (lane < n) {
        if (used) v = v - delta;
        else minv = minv - delta;
      }
      __syncwarp();
      j0 = j1;
    }
    while (j0 != n) {  // augment along the predecessor chain
      int j1 = __shfl_sync(kFull, way, j0);
      int r = __shfl_sync(kFull, roc, j1 & 31);
      if (j1 == n) r = roc_n;
      if (lane == j0) roc = r;
      j0 = j1;
    }
  }
  if (lane < n) sh.col_of_row[roc] = lane;
  __syncwarp();
}

struct Params {
  int T, D, S, max_age, min_hits, asso, delta_t, flags;
  float iou_threshold, inertia;
};

// TrackerState's fields in its order (vbt_tpu_torch/tracking/scan.py), each
// a contiguous tensor: (C, S, ...) per slot, (C,) for next_id and frame;
// float32, int32, and bool as one byte. x == nullptr: no state.
struct State {
  float* x;            // (C, S, 7)
  float* p;            // (C, S, 7, 7)
  uint8_t* alive;      // (C, S)
  int32_t* tsu;
  int32_t* hits;
  int32_t* hit_streak;
  int32_t* age;
  int32_t* track_id;
  float* conf;
  float* cls;
  float* last_obs;     // (C, S, 5)
  float* velocity;     // (C, S, 2)
  float* obs_ring;     // (C, S, delta_t, 5), the slot of an age is age % delta_t
  int32_t* ring_age;   // (C, S, delta_t)
  float* frozen_x;     // (C, S, 7)
  float* frozen_p;     // (C, S, 7, 7)
  uint8_t* has_frozen; // (C, S)
  int32_t* miss_gap;
  int32_t* next_id;    // (C,)
  int32_t* frame;      // (C,)
};
constexpr int kStateFields = 20;
static_assert(sizeof(State) == kStateFields * sizeof(void*), "State is a list of pointers");

// The per-slot part of the state lives in shared memory (Clip) and in the
// lane's registers (Slot); next_id and frame in every lane's registers.
struct Slot {
  bool alive, has_frozen;
  int tsu, hits, hit_streak, age, track_id, miss_gap;
  float conf, cls;
};

template <class T>
HD void copy_n(T* dst, const T* src, int n) {
  for (int i = 0; i < n; ++i) dst[i] = src[i];
}

// Slot `lane` of clip c from global memory into the clip's shared state.
__device__ __forceinline__ void load_slot(const State& in, Clip& sh, Slot& r, int c, int S,
                                          int lane, int DT) {
  const size_t cs = (size_t)c * S + lane;
  copy_n(sh.x[lane], in.x + cs * kDimX, kDimX);
  copy_n(sh.p[lane], in.p + cs * kP, kP);
  copy_n(sh.frozen_x[lane], in.frozen_x + cs * kDimX, kDimX);
  copy_n(sh.frozen_p[lane], in.frozen_p + cs * kP, kP);
  copy_n(sh.last_obs[lane], in.last_obs + cs * 5, 5);
  copy_n(sh.vel[lane], in.velocity + cs * 2, 2);
  copy_n(sh.ring[lane], in.obs_ring + cs * DT * 5, DT * 5);
  copy_n(sh.ring_age[lane], in.ring_age + cs * DT, DT);
  r.alive = in.alive[cs] != 0;
  r.has_frozen = in.has_frozen[cs] != 0;
  r.tsu = in.tsu[cs];
  r.hits = in.hits[cs];
  r.hit_streak = in.hit_streak[cs];
  r.age = in.age[cs];
  r.track_id = in.track_id[cs];
  r.miss_gap = in.miss_gap[cs];
  r.conf = in.conf[cs];
  r.cls = in.cls[cs];
}

__device__ __forceinline__ void store_slot(const State& out, const Clip& sh, const Slot& r,
                                           int c, int S, int lane, int DT) {
  const size_t cs = (size_t)c * S + lane;
  copy_n(out.x + cs * kDimX, sh.x[lane], kDimX);
  copy_n(out.p + cs * kP, sh.p[lane], kP);
  copy_n(out.frozen_x + cs * kDimX, sh.frozen_x[lane], kDimX);
  copy_n(out.frozen_p + cs * kP, sh.frozen_p[lane], kP);
  copy_n(out.last_obs + cs * 5, sh.last_obs[lane], 5);
  copy_n(out.velocity + cs * 2, sh.vel[lane], 2);
  copy_n(out.obs_ring + cs * DT * 5, sh.ring[lane], DT * 5);
  copy_n(out.ring_age + cs * DT, sh.ring_age[lane], DT);
  out.alive[cs] = r.alive ? 1 : 0;
  out.has_frozen[cs] = r.has_frozen ? 1 : 0;
  out.tsu[cs] = r.tsu;
  out.hits[cs] = r.hits;
  out.hit_streak[cs] = r.hit_streak;
  out.age[cs] = r.age;
  out.track_id[cs] = r.track_id;
  out.miss_gap[cs] = r.miss_gap;
  out.conf[cs] = r.conf;
  out.cls[cs] = r.cls;
}

__global__ void __launch_bounds__(32) track_scan_kernel(
    const float* __restrict__ dets, const uint8_t* __restrict__ det_valid,
    const uint8_t* __restrict__ frame_valid, uint8_t* __restrict__ report_out,
    float* __restrict__ box_out, int32_t* __restrict__ id_out, float* __restrict__ conf_out,
    float* __restrict__ cls_out, float* __restrict__ dxdy_out, State state_in, State state_out,
    Params prm) {
  __shared__ Clip sh;
  const int lane = threadIdx.x;
  const int c = blockIdx.x;
  const int T = prm.T, D = prm.D, S = prm.S, DT = prm.delta_t;
  const int n = D > S ? D : S;
  const float thr = prm.iou_threshold;
  const bool momentum = prm.flags & kMomentum, recovery = prm.flags & kRecovery;
  const bool reupdate = prm.flags & kReupdate, report_obs = prm.flags & kReportObs;
  const bool skip_empty = prm.flags & kSkipEmpty;
  const unsigned lt_mask = (1u << lane) - 1u;
  const bool is_slot = lane < S, is_det = lane < D;

  // Lane s's slot scalars live in its registers.
  bool alive = false, has_frozen = false;
  int tsu = 0, hits = 0, hit_streak = 0, age = 0, track_id = 0, miss_gap = 0;
  float conf = 0.0f, cls = 0.0f;
  int next_id = 1, frame = 0;
  if (state_in.x != nullptr) {
    if (is_slot) {
      Slot r;
      load_slot(state_in, sh, r, c, S, lane, DT);
      alive = r.alive;
      has_frozen = r.has_frozen;
      tsu = r.tsu;
      hits = r.hits;
      hit_streak = r.hit_streak;
      age = r.age;
      track_id = r.track_id;
      miss_gap = r.miss_gap;
      conf = r.conf;
      cls = r.cls;
    }
    next_id = state_in.next_id[c];
    frame = state_in.frame[c];
  } else if (is_slot) {
    const float z0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    initial_state(z0, sh.x[lane], sh.p[lane]);
    for (int i = 0; i < kDimX; ++i) sh.frozen_x[lane][i] = 0.0f;
    for (int i = 0; i < kP; ++i) sh.frozen_p[lane][i] = 0.0f;
    for (int i = 0; i < 5; ++i) sh.last_obs[lane][i] = -1.0f;
    sh.vel[lane][0] = sh.vel[lane][1] = 0.0f;
    for (int i = 0; i < DT * 5; ++i) sh.ring[lane][i] = -1.0f;
    for (int i = 0; i < DT; ++i) sh.ring_age[lane][i] = -1;
  }

  for (int t = 0; t < T; ++t) {
    const size_t frame_idx = (size_t)c * T + t;
    const size_t out_idx = frame_idx * S + lane;
    bool dv = false;
    if (is_det) {
      const float* src = dets + (frame_idx * D + lane) * 6;
      for (int k = 0; k < 6; ++k) sh.det[lane][k] = src[k];
      dv = det_valid[frame_idx * D + lane] != 0;
    }
    const unsigned dmask = __ballot_sync(kFull, dv);
    const bool active = frame_valid[frame_idx] != 0 && (dmask != 0u || !skip_empty);
    if (!active) {  // the state stays as it is and the frame reports nothing
      if (is_slot) {
        report_out[out_idx] = 0;
        for (int k = 0; k < 4; ++k) box_out[out_idx * 4 + k] = 0.0f;
        id_out[out_idx] = 0;
        conf_out[out_idx] = cls_out[out_idx] = 0.0f;
        dxdy_out[out_idx * 2] = dxdy_out[out_idx * 2 + 1] = 0.0f;
      }
      __syncwarp();
      continue;
    }

    // ---- predict ---------------------------------------------------------------
    if (is_slot && alive) {
      kf_predict(sh.x[lane], sh.p[lane]);
      age += 1;
      if (tsu > 0) hit_streak = 0;
      tsu += 1;
    }
    frame += 1;
    float k_obs[5];
    if (is_slot) {
      state_bbox(sh.x[lane], sh.trk_box[lane]);
      k_previous_obs(sh, lane, age, DT, k_obs);
      for (int i = 0; i < 5; ++i) sh.k_obs[lane][i] = k_obs[i];
    }
    const unsigned amask = __ballot_sync(kFull, is_slot && alive);
    __syncwarp();

    // ---- association cost: lane d takes detection row d --------------------------
    unsigned over = 0u;  // slots whose affinity passes the threshold
    if (lane < n) {
      for (int s = 0; s < n; ++s) {
        float a = -1.0f, cost = kInvalidCost;
        if (s < S && is_det) {
          const bool pv = dv && ((amask >> s) & 1u);
          if (pv) {
            a = affinity(prm.asso, sh.det[lane], sh.trk_box[s]);
            cost = -a;
            if (momentum)
              cost = cost - prm.inertia * direction_consistency(sh.det[lane], sh.k_obs[s],
                                                                sh.vel[s]);
            if (a > thr) over |= 1u << s;
          }
          sh.aff[lane][s] = a;
        }
        sh.cost[lane][s] = cost;
      }
    }
    // SORT shortcut: at most one passing slot per row and per column.
    unsigned seen = over, dup = 0u;
    for (int o = 16; o > 0; o >>= 1) {
      unsigned os = __shfl_xor_sync(kFull, seen, o), od = __shfl_xor_sync(kFull, dup, o);
      dup = dup | od | (seen & os);
      seen = seen | os;
    }
    const bool is_perm = __all_sync(kFull, __popc(over) <= 1) && dup == 0u;
    __syncwarp();
    int cand = over ? __ffs(over) - 1 : -1;
    if (!is_perm) {
      hungarian(sh, n, lane);
      cand = -1;
      if (is_det && sh.col_of_row[lane] < S) cand = sh.col_of_row[lane];
    }
    bool matched = is_det && dv && cand >= 0 && sh.aff[lane][cand] >= thr;
    int match_slot = matched ? cand : -1;

    // ---- OCR: leftover detections against leftover tracks' last observations ------
    if (recovery) {
      if (is_slot) sh.taken[lane] = 0;
      __syncwarp();
      if (matched) sh.taken[match_slot] = 1;
      __syncwarp();
      const unsigned left_trk = __ballot_sync(
          kFull, is_slot && alive && !sh.taken[lane] && sh.last_obs[lane][4] >= 0.0f);
      const bool left_det = dv && !matched;
      float best = -kInf;
      if (is_det) {
        for (int s = 0; s < S; ++s) {
          const bool pv = left_det && ((left_trk >> s) & 1u);
          const float a = pv ? affinity(prm.asso, sh.det[lane], sh.last_obs[s]) : -1.0f;
          sh.aff[lane][s] = a;
          sh.cost[lane][s] = pv ? -a : kInvalidCost;
          best = fmax_(best, a);
        }
      }
      const bool do_ocr = warp_max(best) > thr;
      __syncwarp();
      if (do_ocr) {
        hungarian(sh, n, lane);
        const int col = is_det ? sh.col_of_row[lane] : n;
        const int slot2 = col < S ? col : -1;
        if (left_det && slot2 >= 0 && sh.aff[lane][slot2] >= thr) {
          matched = true;
          match_slot = slot2;
        }
      }
    }

    // ---- per-slot match ------------------------------------------------------------
    if (is_slot) sh.slot_det[lane] = -1;
    __syncwarp();
    if (matched) sh.slot_det[match_slot] = lane;
    __syncwarp();
    const int sd = is_slot ? sh.slot_det[lane] : -1;
    const bool smatched = sd >= 0;
    float dfs[6];
    for (int k = 0; k < 6; ++k) dfs[k] = sh.det[sd >= 0 ? sd : 0][k];

    if (is_slot) {
      float* x = sh.x[lane];
      float* p = sh.p[lane];
      float* last = sh.last_obs[lane];
      // ---- ORU: roll back to the freeze and replay a virtual trajectory ---------
      const bool oru = reupdate && smatched && has_frozen && tsu > 1 && last[4] >= 0.0f;
      if (oru) {
        for (int i = 0; i < kDimX; ++i) x[i] = sh.frozen_x[lane][i];
        for (int i = 0; i < kP; ++i) p[i] = sh.frozen_p[lane][i];
        float z1[4], z2[4];
        bbox_to_z(last, z1);
        bbox_to_z(dfs, z2);
        const float w1 = sqrtf(z1[2] * z1[3]), h1 = sqrtf(z1[2] / z1[3]);
        const float w2 = sqrtf(z2[2] * z2[3]), h2 = sqrtf(z2[2] / z2[3]);
        const float gap = (float)(miss_gap + 1);
        const int steps = miss_gap + 1 < prm.max_age + 1 ? miss_gap + 1 : prm.max_age + 1;
        for (int k = 1; k <= steps; ++k) {
          const float frac = (float)k / gap;
          const float w = w1 + frac * (w2 - w1), h = h1 + frac * (h2 - h1);
          const float vz[4] = {z1[0] + frac * (z2[0] - z1[0]), z1[1] + frac * (z2[1] - z1[1]),
                               w * h, w / h};
          kf_update(x, p, vz);
          if (k < miss_gap + 1) kf_predict(x, p);
        }
      }
      // ---- OCM velocity and the observation ring ---------------------------------
      if (momentum && smatched && last[4] >= 0.0f) speed_direction(k_obs, dfs, sh.vel[lane]);
      if (smatched) {
        const int rs = age % DT;
        for (int i = 0; i < 5; ++i) sh.ring[lane][rs * 5 + i] = dfs[i];
        sh.ring_age[lane][rs] = age;
      }
      // ---- measurement update -----------------------------------------------------
      if (smatched) {
        if (!oru) {
          float z[4];
          bbox_to_z(dfs, z);
          kf_update(x, p, z);
        }
        tsu = 0;
        hits += 1;
        hit_streak += 1;
        conf = dfs[4];
        cls = dfs[5];
        for (int i = 0; i < 5; ++i) last[i] = dfs[i];
        has_frozen = false;
        miss_gap = 0;
      } else if (alive && reupdate) {  // a miss: freeze for ORU
        if (!has_frozen) {
          for (int i = 0; i < kDimX; ++i) sh.frozen_x[lane][i] = x[i];
          for (int i = 0; i < kP; ++i) sh.frozen_p[lane][i] = p[i];
          has_frozen = true;
        }
        miss_gap += 1;
      }
    }

    // ---- births: the r-th new detection takes the r-th free slot ---------------------
    const bool new_det = dv && !matched;
    const unsigned nd_mask = __ballot_sync(kFull, new_det);
    const unsigned free_mask = __ballot_sync(kFull, is_slot && !alive);
    if (new_det) sh.det_of_rank[__popc(nd_mask & lt_mask)] = lane;
    __syncwarp();
    const int free_rank = __popc(free_mask & lt_mask);
    if (is_slot && !alive && free_rank < __popc(nd_mask)) {
      const float* b = sh.det[sh.det_of_rank[free_rank]];
      float z[4];
      bbox_to_z(b, z);
      initial_state(z, sh.x[lane], sh.p[lane]);
      alive = true;
      tsu = hits = hit_streak = age = 0;
      track_id = next_id + free_rank;
      conf = b[4];
      cls = b[5];
      for (int i = 0; i < 5; ++i) sh.last_obs[lane][i] = -1.0f;
      sh.vel[lane][0] = sh.vel[lane][1] = 0.0f;
      for (int i = 0; i < DT * 5; ++i) sh.ring[lane][i] = -1.0f;
      for (int i = 0; i < DT; ++i) sh.ring_age[lane][i] = -1;
      has_frozen = false;
      miss_gap = 0;
    }
    next_id += __popc(nd_mask);  // advances past births that found no slot

    // ---- report, then deaths ----------------------------------------------------------
    if (is_slot) {
      const bool rep = alive && tsu < 1 && (hit_streak >= prm.min_hits || frame <= prm.min_hits);
      float b[4];
      if (report_obs && sh.last_obs[lane][4] >= 0.0f) {
        for (int k = 0; k < 4; ++k) b[k] = sh.last_obs[lane][k];
      } else {
        state_bbox(sh.x[lane], b);
      }
      report_out[out_idx] = rep;
      for (int k = 0; k < 4; ++k) box_out[out_idx * 4 + k] = b[k];
      id_out[out_idx] = track_id;
      conf_out[out_idx] = conf;
      cls_out[out_idx] = cls;
      dxdy_out[out_idx * 2] = sh.x[lane][4];
      dxdy_out[out_idx * 2 + 1] = sh.x[lane][5];
      alive = alive && tsu <= prm.max_age;
    }
    __syncwarp();
  }

  if (state_out.x != nullptr) {
    if (is_slot) {
      const Slot r{alive, has_frozen, tsu, hits, hit_streak, age, track_id, miss_gap, conf, cls};
      store_slot(state_out, sh, r, c, S, lane, DT);
    }
    if (lane == 0) {
      state_out.next_id[c] = next_id;
      state_out.frame[c] = frame;
    }
  }
}

State state_from(void* const* fields) {
  State s{};
  if (fields != nullptr) std::memcpy(&s, fields, sizeof(State));
  return s;
}

}  // namespace

// ---- host side ----

#ifdef __CUDACC__
extern "C" int vbt_track_scan_launch(const void* dets, const void* det_valid,
                                     const void* frame_valid, void* report, void* box,
                                     void* track_id, void* conf, void* cls, void* dxdy, int C,
                                     int T, int D, int S, int max_age, int min_hits,
                                     float iou_threshold, int asso, float inertia, int delta_t,
                                     int flags, void* const* state_in, void* const* state_out,
                                     void* stream) {
  if (C <= 0 || T <= 0) return 0;
  if (D < 1 || D > kMaxDets || S < 1 || S > kMaxSlots || delta_t < 1 || delta_t > kMaxDeltaT)
    return (int)cudaErrorInvalidValue;
  Params prm{T, D, S, max_age, min_hits, asso, delta_t, flags, iou_threshold, inertia};
  track_scan_kernel<<<C, 32, 0, (cudaStream_t)stream>>>(
      (const float*)dets, (const uint8_t*)det_valid, (const uint8_t*)frame_valid,
      (uint8_t*)report, (float*)box, (int32_t*)track_id, (float*)conf, (float*)cls,
      (float*)dxdy, state_from(state_in), state_from(state_out), prm);
  return (int)cudaGetLastError();
}
#endif
