// Train-mode BatchNorm and the activation after it, forward and backward, on
// NCHW float32: flax's BatchNorm (batch statistics over N, H and W, the fast
// biased variance clamped at 0, eps 1e-3, running statistics
// r <- 0.99 r + 0.01 batch) followed by none, ReLU6 or swish, as
// vbt_tpu_torch/ops/batchnorm_act.py:batchnorm_act_plain computes it.
//
// Replaces no Pallas kernel: the JAX package leaves train-mode BatchNorm to
// XLA, which fuses it into the convolutions around it. It was added for the
// port's train step, where the same BatchNorm in plain torch ops is about 21
// kernels over the activation (7 in the forward, 14 in the backward), some
// 45 passes over its bytes.
//
// What bounds it on an H100: bytes. Three launches, a few operations an
// element against 3.35 TB/s:
//   apply_kernel          y = act(((x - mean) * mul) + b), mul = rsqrt(var + eps) * w,
//                         from the batch's mean and mean of squares; block 0 of
//                         a channel writes mean, var, 1/std, the clamp's gate
//                         and the running statistics (reads x, writes y: 8 B an element)
//   grad_partials_kernel  z again, dz = dy * act'(z), per-block partial
//                         sum(dz), sum(dz * xhat) (reads x and dy: 8 B)
//   grad_apply_kernel     folds them: dw = sum(dz * xhat), db = sum(dz),
//                         dx = mul * (dz - sum(dz)/M - gate * xhat * sum(dz * xhat)/M)
//                         (reads x and dy, writes dx: 12 B)
// The batch's mean and mean of squares are the wrapper's: the plain
// version's own float32 reductions (xf.mean, (xf * xf).mean), 16 B an
// element more. The fast variance loses digits where |mean| is large against
// the standard deviation, and the train step's gradient carries that
// rounding forward. Measured on lite0's train step (H100, B = 64): float64
// partial sums in the kernel, tried first, put the first gradient 2-4e-4 of
// a leaf from the plain float32 step's; the whole step in float64 lies
// 2.4e-4 from it; with the reductions' own bits the kernels' step lies
// 2e-6 from it. So y repeats the plain version's roundings one by one (no
// contraction into an FMA, torch.rsqrt's rsqrtf) and equals its y bit for
// bit.
//
// Design: a channel's N planes of H*W floats are one index space of M = N*H*W
// elements (of M/4 float4 vectors where H*W and every pointer allow 16-byte
// loads), cut into `split` contiguous ranges, a block each; the wrapper
// chooses split from (N, C, H*W) so that large planes fill the card over N
// and H*W (ops/batchnorm_act.py:launch_plan). A thread keeps four loads in
// flight; an index maps to its address by a multiply-high division. The
// backward's partial sums are float64 (products of floats, exact), folded in
// a fixed order: each warp folds a channel's partials lane-strided and by
// shuffles, so every block of the channel gets the same bits, and there are
// no atomics: a CUDA-graph replay gives the bits of an eager launch. The
// pre-activation z is one device function in the forward and the backward,
// so the activation's mask in the backward is the forward's bit for bit.
// Nothing allocates or synchronizes: the wrapper allocates the outputs and
// the workspace of partials with torch.empty.
//
// Built by vbt_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (vbt_tpu_torch/ops/batchnorm_act.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // loads a thread keeps in flight
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kEps = 1e-3f;

enum Act { kNone = 0, kRelu6 = 1, kSwish = 2 };

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (the magic number
// of PyTorch's IntDivider).
struct Divider {
  uint32_t magic, shift;
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (__umulhi(n, magic) + n) >> shift;
  }
};

struct Layout {
  int c;           // channels
  uint32_t plane;  // vectors a plane (H*W / V)
  Divider planes;  // division by plane
  uint32_t units;  // vectors a channel (N * plane)
  int split;       // blocks a channel
  double m;        // elements a channel (N*H*W)
};

// Where vector j of channel c lies, in vectors from the start of the tensor.
__device__ __forceinline__ int64_t offset(const Layout& L, int c, uint32_t j) {
  const uint32_t n = L.planes.div(j);
  return ((int64_t)n * L.c + c) * L.plane + (j - n * L.plane);
}

// Block k's range [begin, end) of a channel's vectors.
__device__ __forceinline__ void block_range(const Layout& L, int k, uint32_t& begin,
                                            uint32_t& end) {
  begin = (uint32_t)((uint64_t)L.units * k / L.split);
  end = (uint32_t)((uint64_t)L.units * (k + 1) / L.split);
}

template <int V>
struct Pack {
  float v[V];
};

template <int V>
__device__ __forceinline__ Pack<V> load(const float* __restrict__ base, int64_t i) {
  Pack<V> p;
  if constexpr (V == 4) {
    const float4 f = reinterpret_cast<const float4*>(base)[i];
    p.v[0] = f.x;
    p.v[1] = f.y;
    p.v[2] = f.z;
    p.v[3] = f.w;
  } else {
    p.v[0] = base[i];
  }
  return p;
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ base, int64_t i, const Pack<V>& p) {
  if constexpr (V == 4) {
    reinterpret_cast<float4*>(base)[i] = make_float4(p.v[0], p.v[1], p.v[2], p.v[3]);
  } else {
    base[i] = p.v[0];
  }
}

// The pre-activation, in the forward and the backward alike: the plain
// version's ((x - mean) * mul) + b, each step rounded.
__device__ __forceinline__ float pre(float x, float mean, float mul, float b) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), b);
}

template <int A>
__device__ __forceinline__ float act(float z) {
  if constexpr (A == kRelu6) {
    return z <= 0.f ? 0.f : (z >= 6.f ? 6.f : z);  // hardtanh(z, 0, 6)
  } else if constexpr (A == kSwish) {
    return z / (1.f + expf(-z));  // silu
  } else {
    return z;
  }
}

// dy * act'(z): hardtanh_backward's mask 0 < z < 6, silu_backward's
// s * (1 + z * (1 - s)).
template <int A>
__device__ __forceinline__ float act_grad(float z, float dy) {
  if constexpr (A == kRelu6) {
    return (z > 0.f && z < 6.f) ? dy : 0.f;
  } else if constexpr (A == kSwish) {
    const float s = 1.f / (1.f + expf(-z));
    return dy * s * (1.f + z * (1.f - s));
  } else {
    return dy;
  }
}

// The block's sums of a and b, in thread 0, in a fixed order.
__device__ __forceinline__ void block_sum2(double& a, double& b) {
  __shared__ double sh[kWarps][2];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(kFullMask, a, o);
    b += __shfl_down_sync(kFullMask, b, o);
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) {
    sh[w][0] = a;
    sh[w][1] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = 0.0;
    b = 0.0;
    for (int i = 0; i < kWarps; ++i) {
      a += sh[i][0];
      b += sh[i][1];
    }
  }
}

// Channel c's partials folded, the same bits in every thread of every block:
// lane-strided sums, then a butterfly whose order is fixed.
__device__ __forceinline__ double2 fold(const double2* __restrict__ partial, int c, int split) {
  const int lane = threadIdx.x & 31;
  double a = 0.0, b = 0.0;
  for (int k = lane; k < split; k += 32) {
    const double2 p = partial[(int64_t)c * split + k];
    a += p.x;
    b += p.y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFullMask, a, o);
    b += __shfl_xor_sync(kFullMask, b, o);
  }
  // The butterfly leaves lanes with sums added in other orders: take lane 0's.
  return make_double2(__shfl_sync(kFullMask, a, 0), __shfl_sync(kFullMask, b, 0));
}

struct ChannelStats {
  float mean, var, invstd, gate;
};

// var = max(mean(x^2) - mean * mean, 0), flax's fast variance in float32 as
// the plain version rounds it; gate 1 where the clamp passes the gradient
// (raw >= 0, torch.clamp's rule); invstd = rsqrt(var + eps) (torch.rsqrt's
// rsqrtf).
__device__ __forceinline__ ChannelStats channel_stats(float mean, float meansq) {
  ChannelStats s;
  s.mean = mean;
  const float raw = __fsub_rn(meansq, __fmul_rn(mean, mean));
  s.gate = raw >= 0.f ? 1.f : 0.f;
  s.var = raw < 0.f ? 0.f : raw;
  s.invstd = rsqrtf(__fadd_rn(s.var, kEps));
  return s;
}

template <int V, int A>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ x, const float* __restrict__ mean,
             const float* __restrict__ meansq, const float* __restrict__ w,
             const float* __restrict__ b, float* __restrict__ running_mean,
             float* __restrict__ running_var, float* __restrict__ y,
             float* __restrict__ stats,  // (4, C): mean, var, invstd, gate
             Layout L, float keep, float take) {
  const int c = blockIdx.x / L.split, k = blockIdx.x - c * L.split;
  const ChannelStats st = channel_stats(mean[c], meansq[c]);
  const float scale = __fmul_rn(st.invstd, w[c]), shift = b[c];
  if (k == 0 && threadIdx.x == 0) {
    stats[c] = st.mean;
    stats[L.c + c] = st.var;
    stats[2 * L.c + c] = st.invstd;
    stats[3 * L.c + c] = st.gate;
    running_mean[c] = __fadd_rn(__fmul_rn(keep, running_mean[c]), __fmul_rn(take, st.mean));
    running_var[c] = __fadd_rn(__fmul_rn(keep, running_var[c]), __fmul_rn(take, st.var));
  }
  uint32_t begin, end;
  block_range(L, k, begin, end);
  for (uint32_t j = begin + threadIdx.x; j < end; j += kUnroll * kThreads) {
    Pack<V> p[kUnroll];
    int64_t at[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t ju = j + u * kThreads;
      if (ju < end) {
        at[u] = offset(L, c, ju);
        p[u] = load<V>(x, at[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * kThreads < end) {
#pragma unroll
        for (int i = 0; i < V; ++i) p[u].v[i] = act<A>(pre(p[u].v[i], st.mean, scale, shift));
        store<V>(y, at[u], p[u]);
      }
    }
  }
}

template <int V, int A>
__global__ void __launch_bounds__(kThreads)
grad_partials_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                     const float* __restrict__ w, const float* __restrict__ b,
                     const float* __restrict__ stats, Layout L,
                     double2* __restrict__ partial) {
  const int c = blockIdx.x / L.split, k = blockIdx.x - c * L.split;
  const float mean = stats[c], invstd = stats[2 * L.c + c];
  const float scale = __fmul_rn(invstd, w[c]), shift = b[c];
  uint32_t begin, end;
  block_range(L, k, begin, end);
  double sdz = 0.0, sdzx = 0.0;
  for (uint32_t j = begin + threadIdx.x; j < end; j += kUnroll * kThreads) {
    Pack<V> px[kUnroll], pd[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t ju = j + u * kThreads;
      if (ju < end) {
        const int64_t at = offset(L, c, ju);
        px[u] = load<V>(x, at);
        pd[u] = load<V>(dy, at);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * kThreads < end) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xv = px[u].v[i];
          const float dz = act_grad<A>(pre(xv, mean, scale, shift), pd[u].v[i]);
          const float xhat = __fmul_rn(__fsub_rn(xv, mean), invstd);
          sdz += (double)dz;
          sdzx += (double)dz * (double)xhat;
        }
      }
    }
  }
  block_sum2(sdz, sdzx);
  if (threadIdx.x == 0) partial[blockIdx.x] = make_double2(sdz, sdzx);
}

template <int V, int A>
__global__ void __launch_bounds__(kThreads)
grad_apply_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  const float* __restrict__ w, const float* __restrict__ b,
                  const float* __restrict__ stats, const double2* __restrict__ partial,
                  Layout L, float* __restrict__ dx, float* __restrict__ dw,
                  float* __restrict__ db) {
  const int c = blockIdx.x / L.split, k = blockIdx.x - c * L.split;
  const float mean = stats[c], invstd = stats[2 * L.c + c], gate = stats[3 * L.c + c];
  const float scale = __fmul_rn(invstd, w[c]), shift = b[c];
  const double2 sums = fold(partial, c, L.split);  // sum(dz), sum(dz * xhat)
  const float k1 = (float)(sums.x / L.m);
  const float k2 = gate != 0.f ? (float)(sums.y / L.m) : 0.f;
  if (k == 0 && threadIdx.x == 0) {
    dw[c] = (float)sums.y;
    db[c] = (float)sums.x;
  }
  uint32_t begin, end;
  block_range(L, k, begin, end);
  for (uint32_t j = begin + threadIdx.x; j < end; j += kUnroll * kThreads) {
    Pack<V> px[kUnroll], pd[kUnroll];
    int64_t at[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t ju = j + u * kThreads;
      if (ju < end) {
        at[u] = offset(L, c, ju);
        px[u] = load<V>(x, at[u]);
        pd[u] = load<V>(dy, at[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * kThreads < end) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xv = px[u].v[i];
          const float dz = act_grad<A>(pre(xv, mean, scale, shift), pd[u].v[i]);
          const float xhat = __fmul_rn(__fsub_rn(xv, mean), invstd);
          px[u].v[i] = scale * (dz - k1 - xhat * k2);
        }
        store<V>(dx, at[u], px[u]);
      }
    }
  }
}

// ---- host side ----

Divider make_divider(uint32_t d) {
  uint32_t shift = 0;
  while (shift < 32 && (1ull << shift) < d) ++shift;
  const uint64_t one = 1;
  const uint64_t magic = ((one << 32) * ((one << shift) - d)) / d + 1;
  return Divider{(uint32_t)magic, shift};
}

Layout make_layout(int n, int c, int hw, int vec, int split) {
  Layout L;
  L.c = c;
  L.plane = (uint32_t)(hw / vec);
  L.planes = make_divider(L.plane);
  L.units = (uint32_t)n * L.plane;
  L.split = split;
  L.m = (double)n * hw;
  return L;
}

// f(std::integral_constant<int, A>) for the activation code `act`.
template <typename F>
cudaError_t with_act(int act, F f) {
  switch (act) {
    case kNone: f(std::integral_constant<int, kNone>{}); break;
    case kRelu6: f(std::integral_constant<int, kRelu6>{}); break;
    case kSwish: f(std::integral_constant<int, kSwish>{}); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// The forward: apply_kernel. x, y (N, C, H, W); mean, meansq, w, b,
// running_mean, running_var (C,); stats (4, C). vec is 4 where H*W % 4 == 0
// and x and y are 16-byte aligned, else 1. Returns the launch's cudaError_t.
extern "C" int vbt_bn_act_forward(const float* x, const float* mean, const float* meansq,
                                  const float* w, const float* b, float* running_mean,
                                  float* running_var, float* y, float* stats, int n, int c,
                                  int hw, int vec, int split, int act, float keep, float take,
                                  void* stream) {
  if (n <= 0 || c <= 0 || hw <= 0 || split <= 0 || (vec != 1 && vec != 4) || hw % vec != 0 ||
      act < kNone || act > kSwish)
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(n, c, hw, vec, split);
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)(c * split));
  return (int)with_act(act, [&](auto a) {
    constexpr int A = decltype(a)::value;
    if (vec == 4)
      apply_kernel<4, A><<<grid, kThreads, 0, s>>>(x, mean, meansq, w, b, running_mean,
                                                   running_var, y, stats, L, keep, take);
    else
      apply_kernel<1, A><<<grid, kThreads, 0, s>>>(x, mean, meansq, w, b, running_mean,
                                                   running_var, y, stats, L, keep, take);
  });
}

// The backward: grad_partials_kernel, then grad_apply_kernel. dy, dx as x;
// dw, db (C,); stats the forward's; partial as the forward's.
extern "C" int vbt_bn_act_backward(const float* x, const float* dy, const float* w,
                                   const float* b, const float* stats, double* partial,
                                   float* dx, float* dw, float* db, int n, int c, int hw, int vec,
                                   int split, int act, void* stream) {
  if (n <= 0 || c <= 0 || hw <= 0 || split <= 0 || (vec != 1 && vec != 4) || hw % vec != 0 ||
      act < kNone || act > kSwish)
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(n, c, hw, vec, split);
  const cudaStream_t s = (cudaStream_t)stream;
  double2* part = reinterpret_cast<double2*>(partial);
  const dim3 grid((unsigned)(c * split));
  cudaError_t err = with_act(act, [&](auto a) {
    constexpr int A = decltype(a)::value;
    if (vec == 4)
      grad_partials_kernel<4, A><<<grid, kThreads, 0, s>>>(x, dy, w, b, stats, L, part);
    else
      grad_partials_kernel<1, A><<<grid, kThreads, 0, s>>>(x, dy, w, b, stats, L, part);
  });
  if (err != cudaSuccess) return (int)err;
  err = with_act(act, [&](auto a) {
    constexpr int A = decltype(a)::value;
    if (vec == 4)
      grad_apply_kernel<4, A><<<grid, kThreads, 0, s>>>(x, dy, w, b, stats, part, L, dx, dw, db);
    else
      grad_apply_kernel<1, A><<<grid, kThreads, 0, s>>>(x, dy, w, b, stats, part, L, dx, dw, db);
  });
  return (int)err;
}
