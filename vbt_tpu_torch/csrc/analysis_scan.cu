// K4: the streaming analysis of one chunk of samples, in one launch: for each
// sample the causal smoother (rolling-5 mean of x and y, expanding mean of
// the plate's size, the shared 30-sample running average) and then the phase
// state machine, both in float64, with both carries read from and written
// back to global memory and one event record written a sample.
//
// Replaces what XLA compiled from vbt_tpu/runtime/streaming.py::analysis_chunk
// (one lax.scan of smoother_step and velocity_step per chunk); it has no
// Pallas counterpart. The plain version is
// vbt_tpu_torch/ops/analysis_scan_cuda.py::analysis_chunk_plain, a Python loop of
// analysis/smoother_scan.py::smoother_step and
// analysis/velocity_torch.py::velocity_step; every operation here is one of
// theirs, in their order (the 5-ring summed left to right, the path-length
// increment |dx| / ((w + w') / 2) * d), and the file is built with
// --fmad=false, so the two agree bit for bit.
//
// What bounds it: not bytes (a sample reads 6 doubles and writes 9 values)
// nor operations (about 100 a sample), but the serial chain of samples: each
// step needs the previous one's carry, and inside a step every decision
// depends on the one before. So one thread does the work, with the carries
// in registers and its two rings in local memory; the launch replaces a
// loop of some 150 small torch launches a sample.
//
// The per-sample step is __host__ __device__ so that a C++ compiler can check
// it on the CPU (tests/test_torch_track_scan_host.py builds this file with
// g++ and runs the kernel as a plain function).

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

constexpr int kRing5 = 5;
constexpr int kRingRa = 30;
constexpr int kConcentric = 0, kEccentric = 1, kHold = 2;  // analysis/phase.py
constexpr int kStartCount = 3;  // samples of one sign needed to leave HOLD
constexpr int kEndCount = 1;    // samples of the opposite sign needed to end a phase

// analysis/smoother_scan.py::SmootherCarry
struct Smoother {
  double ring5_x[kRing5], ring5_y[kRing5];
  int n5, pos5;
  double exp_h_sum, exp_w_sum;
  int exp_n;
  double ra_buf[kRingRa];
  double ra_total;
  int ra_len, ra_head;
  double y_prev;
  bool has_prev;
};

// analysis/velocity_torch.py::VelocityCarry
struct Velocity {
  int phase, pos, neg;
  double max_y_diff, pmax_y, pmax_t, pmax_prefix, pmin_y, pmin_t, pmin_prefix, prefix;
  double pa_x, pa_y, pa_w, pa_h;
  bool pa_valid;
};

// analysis/velocity_torch.py::EventRecord
struct Event {
  bool fired;
  int type;
  double time_start, time_end, y_start, y_end, rom, y_diff, max_after;
};

// ---- the per-sample step (host and device) ---------------------------------

// One push into the shared running average; returns its output.
HD double ra_update(Smoother& c, double value) {
  const int tail = (c.ra_head + c.ra_len) % kRingRa;
  c.ra_buf[tail] = value;
  double total = c.ra_total + value;
  const int length = c.ra_len + 1;
  const bool full = length >= kRingRa;
  const double out = full ? total / 30.0 : total / (double)length;
  const double evicted = c.ra_buf[c.ra_head];
  c.ra_total = full ? total - evicted : total;
  c.ra_head = full ? (c.ra_head + 1) % kRingRa : c.ra_head;
  c.ra_len = full ? length - 1 : length;
  return out;
}

// One raw sample -> x_s, y_s, dy_eff, w_ra, h_ra (smoother_step).
HD void smoother_step(Smoother& c, double x, double y, double dy_raw, double nph, double npw,
                      double* out) {
  c.ring5_x[c.pos5] = x;
  c.ring5_y[c.pos5] = y;
  c.n5 = c.n5 + 1 < kRing5 ? c.n5 + 1 : kRing5;
  c.pos5 = (c.pos5 + 1) % kRing5;
  const double denom = (double)c.n5;
  double sx = c.ring5_x[0], sy = c.ring5_y[0];
  for (int k = 1; k < kRing5; ++k) {
    sx = sx + c.ring5_x[k];
    sy = sy + c.ring5_y[k];
  }
  const double x_s = sx / denom, y_s = sy / denom;
  c.exp_h_sum = c.exp_h_sum + nph;
  c.exp_w_sum = c.exp_w_sum + npw;
  c.exp_n = c.exp_n + 1;
  const double h_e = c.exp_h_sum / (double)c.exp_n;
  const double w_e = c.exp_w_sum / (double)c.exp_n;
  const double w_ra = ra_update(c, w_e);  // width first: the shared-instance quirk
  const double h_ra = ra_update(c, h_e);
  out[0] = x_s;
  out[1] = y_s;
  out[2] = c.has_prev ? y_s - c.y_prev : dy_raw;
  out[3] = w_ra;
  out[4] = h_ra;
  c.y_prev = y_s;
  c.has_prev = true;
}

// Record a sample on the bar path where `mask` is set.
HD void masked_append(Velocity& c, bool mask, double pd, double tv, double xv, double yv,
                      double wv, double hv) {
  double contrib = 0.0;
  if (c.pa_valid) {
    const double dx_m = fabs(xv - c.pa_x) / ((wv + c.pa_w) / 2.0) * pd;
    const double dy_m = fabs(yv - c.pa_y) / ((hv + c.pa_h) / 2.0) * pd;
    contrib = dx_m + dy_m;
  }
  c.prefix = c.prefix + (mask ? contrib : 0.0);
  if (mask && yv > c.pmax_y) {
    c.pmax_y = yv;
    c.pmax_t = tv;
    c.pmax_prefix = c.prefix;
  }
  if (mask && yv < c.pmin_y) {
    c.pmin_y = yv;
    c.pmin_t = tv;
    c.pmin_prefix = c.prefix;
  }
  if (mask) {
    c.pa_x = xv;
    c.pa_y = yv;
    c.pa_w = wv;
    c.pa_h = hv;
    c.pa_valid = true;
  }
}

// The phase state machine on one smoothed sample (velocity_step).
HD Event velocity_step(Velocity& c, double pd, double tv, double dy, double xv, double yv,
                       double wv, double hv) {
  masked_append(c, c.phase != kHold, pd, tv, xv, yv, wv, hv);

  const bool is_conc = c.phase == kConcentric;
  const int pos1 = is_conc ? (dy > 0.0 ? c.pos + 1 : 0) : c.pos;
  const int neg1 = (is_conc && dy > 0.0) ? 0 : c.neg;
  const bool conc_end = is_conc && dy > 0.0 && pos1 >= kEndCount;
  const bool is_ecc = c.phase == kEccentric;
  const int neg2 = is_ecc ? (dy < 0.0 ? neg1 + 1 : 0) : neg1;
  const int pos2 = is_ecc ? (dy < 0.0 ? 0 : pos1 + 1) : pos1;
  const bool ecc_end = is_ecc && dy < 0.0 && neg2 >= kEndCount;
  const bool ended = conc_end || ecc_end;

  Event ev;
  ev.fired = ended;
  ev.type = c.phase;
  ev.time_start = is_conc ? c.pmax_t : c.pmin_t;
  ev.time_end = is_conc ? c.pmin_t : c.pmax_t;
  ev.y_start = is_conc ? c.pmax_y : c.pmin_y;
  ev.y_end = is_conc ? c.pmin_y : c.pmax_y;
  const double s_p = is_conc ? c.pmax_prefix : c.pmin_prefix;
  const double e_p = is_conc ? c.pmin_prefix : c.pmax_prefix;
  ev.rom = e_p - s_p;
  ev.y_diff = c.pmax_y - c.pmin_y;
  ev.max_after = (ended && ev.y_diff > c.max_y_diff) ? ev.y_diff : c.max_y_diff;

  const int phase1 = ended ? kHold : c.phase;
  const int pos3 = ended ? 0 : pos2;
  const int neg3 = ended ? 0 : neg2;
  // HOLD, negative dy: count toward a concentric start.
  const bool hn = dy < 0.0 && phase1 == kHold;
  const int neg4 = hn ? neg3 + 1 : neg3;
  const int pos4 = hn ? 0 : pos3;
  const bool reset_n = hn && neg4 == 1;
  const bool app_n = hn && neg4 != 1;
  const bool start_c = hn && neg4 >= kStartCount;
  const int phase2 = start_c ? kConcentric : phase1;
  const int pos5 = start_c ? 0 : pos4;
  const int neg5 = start_c ? 0 : neg4;
  // HOLD, positive dy: count toward an eccentric start.
  const bool hp = dy > 0.0 && phase2 == kHold;
  const int pos6 = hp ? pos5 + 1 : pos5;
  const int neg6 = hp ? 0 : neg5;
  const bool reset_p = hp && pos6 == 1;
  const bool app_p = hp && pos6 != 1;
  const bool start_e = hp && pos6 >= kStartCount;
  const int phase3 = start_e ? kEccentric : phase2;
  const int pos7 = start_e ? 0 : pos6;
  const int neg7 = start_e ? 0 : neg6;

  if (reset_n || reset_p) {  // a bar-path reset drops the triggering sample
    c.pmax_y = -INFINITY;
    c.pmin_y = INFINITY;
    c.pa_valid = false;
  }
  masked_append(c, app_n || app_p, pd, tv, xv, yv, wv, hv);  // pre-start appends
  c.phase = phase3;
  c.pos = pos7;
  c.neg = neg7;
  c.max_y_diff = ev.max_after;
  return ev;
}

// One raw sample (time, x, y, dy_raw, norm_plate_height, norm_plate_width).
HD Event analysis_step(Smoother& s, Velocity& v, double pd, const double* in) {
  double sm[5];
  smoother_step(s, in[1], in[2], in[3], in[4], in[5], sm);
  return velocity_step(v, pd, in[0], sm[2], sm[0], sm[1], sm[3], sm[4]);
}

// ---- global memory ---------------------------------------------------------------

// SmootherCarry's fields in its order, each a contiguous tensor.
struct SmootherRef {
  double* ring5_x;
  double* ring5_y;
  int32_t* n5;
  int32_t* pos5;
  double* exp_h_sum;
  double* exp_w_sum;
  int32_t* exp_n;
  double* ra_buf;
  double* ra_total;
  int32_t* ra_len;
  int32_t* ra_head;
  double* y_prev;
  uint8_t* has_prev;
};

// VelocityCarry's fields in its order.
struct VelocityRef {
  int32_t* phase;
  int32_t* pos;
  int32_t* neg;
  double* max_y_diff;
  double* pmax_y;
  double* pmax_t;
  double* pmax_prefix;
  double* pmin_y;
  double* pmin_t;
  double* pmin_prefix;
  double* prefix;
  double* pa_x;
  double* pa_y;
  double* pa_w;
  double* pa_h;
  uint8_t* pa_valid;
};

// EventRecord's fields in its order, each (N,).
struct EventRef {
  uint8_t* fired;
  int32_t* type;
  double* time_start;
  double* time_end;
  double* y_start;
  double* y_end;
  double* rom;
  double* y_diff;
  double* max_after;
};

// The chunk's samples: time, x, y, dy_raw, nph, npw, each (N,).
struct InputRef {
  const double* col[6];
};

HD void load(const SmootherRef& r, Smoother& c) {
  for (int k = 0; k < kRing5; ++k) {
    c.ring5_x[k] = r.ring5_x[k];
    c.ring5_y[k] = r.ring5_y[k];
  }
  c.n5 = *r.n5;
  c.pos5 = *r.pos5;
  c.exp_h_sum = *r.exp_h_sum;
  c.exp_w_sum = *r.exp_w_sum;
  c.exp_n = *r.exp_n;
  for (int k = 0; k < kRingRa; ++k) c.ra_buf[k] = r.ra_buf[k];
  c.ra_total = *r.ra_total;
  c.ra_len = *r.ra_len;
  c.ra_head = *r.ra_head;
  c.y_prev = *r.y_prev;
  c.has_prev = *r.has_prev != 0;
}

HD void store(const Smoother& c, const SmootherRef& r) {
  for (int k = 0; k < kRing5; ++k) {
    r.ring5_x[k] = c.ring5_x[k];
    r.ring5_y[k] = c.ring5_y[k];
  }
  *r.n5 = c.n5;
  *r.pos5 = c.pos5;
  *r.exp_h_sum = c.exp_h_sum;
  *r.exp_w_sum = c.exp_w_sum;
  *r.exp_n = c.exp_n;
  for (int k = 0; k < kRingRa; ++k) r.ra_buf[k] = c.ra_buf[k];
  *r.ra_total = c.ra_total;
  *r.ra_len = c.ra_len;
  *r.ra_head = c.ra_head;
  *r.y_prev = c.y_prev;
  *r.has_prev = c.has_prev ? 1 : 0;
}

HD void load(const VelocityRef& r, Velocity& c) {
  c.phase = *r.phase;
  c.pos = *r.pos;
  c.neg = *r.neg;
  c.max_y_diff = *r.max_y_diff;
  c.pmax_y = *r.pmax_y;
  c.pmax_t = *r.pmax_t;
  c.pmax_prefix = *r.pmax_prefix;
  c.pmin_y = *r.pmin_y;
  c.pmin_t = *r.pmin_t;
  c.pmin_prefix = *r.pmin_prefix;
  c.prefix = *r.prefix;
  c.pa_x = *r.pa_x;
  c.pa_y = *r.pa_y;
  c.pa_w = *r.pa_w;
  c.pa_h = *r.pa_h;
  c.pa_valid = *r.pa_valid != 0;
}

HD void store(const Velocity& c, const VelocityRef& r) {
  *r.phase = c.phase;
  *r.pos = c.pos;
  *r.neg = c.neg;
  *r.max_y_diff = c.max_y_diff;
  *r.pmax_y = c.pmax_y;
  *r.pmax_t = c.pmax_t;
  *r.pmax_prefix = c.pmax_prefix;
  *r.pmin_y = c.pmin_y;
  *r.pmin_t = c.pmin_t;
  *r.pmin_prefix = c.pmin_prefix;
  *r.prefix = c.prefix;
  *r.pa_x = c.pa_x;
  *r.pa_y = c.pa_y;
  *r.pa_w = c.pa_w;
  *r.pa_h = c.pa_h;
  *r.pa_valid = c.pa_valid ? 1 : 0;
}

HD void store(const Event& e, const EventRef& r, int i) {
  r.fired[i] = e.fired ? 1 : 0;
  r.type[i] = e.type;
  r.time_start[i] = e.time_start;
  r.time_end[i] = e.time_end;
  r.y_start[i] = e.y_start;
  r.y_end[i] = e.y_end;
  r.rom[i] = e.rom;
  r.y_diff[i] = e.y_diff;
  r.max_after[i] = e.max_after;
}

// One thread runs the chunk: carries in, N steps, carries out.
__global__ void __launch_bounds__(1) analysis_scan_kernel(
    InputRef in, const double* __restrict__ plate_diameter, int n, SmootherRef s_in,
    VelocityRef v_in, SmootherRef s_out, VelocityRef v_out, EventRef events) {
  Smoother s;
  Velocity v;
  load(s_in, s);
  load(v_in, v);
  const double pd = *plate_diameter;
  for (int i = 0; i < n; ++i) {
    const double sample[6] = {in.col[0][i], in.col[1][i], in.col[2][i],
                              in.col[3][i], in.col[4][i], in.col[5][i]};
    store(analysis_step(s, v, pd, sample), events, i);
  }
  store(s, s_out);
  store(v, v_out);
}

template <class Ref>
Ref ref_from(void* const* fields) {
  static_assert(sizeof(Ref) % sizeof(void*) == 0, "a Ref is a list of pointers");
  Ref r;
  std::memcpy(&r, fields, sizeof(Ref));
  return r;
}

}  // namespace

// ---- host side ----

#ifdef __CUDACC__
// Each `void* const*` is the list of a carry's (or the events', or the
// inputs') field pointers in the order of its Ref struct above.
extern "C" int vbt_analysis_scan_launch(void* const* inputs, const void* plate_diameter, int n,
                                        void* const* smoother_in, void* const* velocity_in,
                                        void* const* smoother_out, void* const* velocity_out,
                                        void* const* events, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  analysis_scan_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      ref_from<InputRef>(inputs), (const double*)plate_diameter, n,
      ref_from<SmootherRef>(smoother_in), ref_from<VelocityRef>(velocity_in),
      ref_from<SmootherRef>(smoother_out), ref_from<VelocityRef>(velocity_out),
      ref_from<EventRef>(events));
  return (int)cudaGetLastError();
}
#endif
