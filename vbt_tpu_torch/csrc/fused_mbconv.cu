// One whole inference MBConv block (1x1 expand + ReLU6, k x k depthwise +
// ReLU6, 1x1 project, optional residual), BatchNorms folded into the weights:
// the form with the 1x1 products as f32 FMA loops. It serves float32, where
// it agrees with the plain version to the order of an f32 sum (tensor cores
// would mean TF32, three digits), and the bfloat16 blocks that
// csrc/fused_mbconv_mma.cu does not take (ragged channel counts, no expand
// conv); vbt_tpu_torch/ops/fused_mbconv.py:launch_plan decides.
//
// Replaces the TPU kernel vbt_tpu/ops/fused_mbconv.py:_mbconv_kernel (driven
// by fused_mbconv there). Same arithmetic as the plain torch version
// vbt_tpu_torch/ops/fused_mbconv.py:fused_mbconv_plain, with its rounding
// points: the expanded value and the depthwise output are rounded to the
// compute type T (float or bf16) and back; every sum is f32; the output is
// rounded to T once, after bias and residual.
//
// What bounds it on an H100. Fused, only x and the output cross device
// memory (39 MB for EfficientDet-Lite0's g1_b1 at 64 images in bf16, 12 us
// at 3.35 TB/s), and its FMAs would take 0.1-0.2 ms a block on the f32
// pipes. It takes 0.83-0.93 ms on every Lite0 block (NVIDIA H100 80GB
// HBM3 at 700 W, python3 chip_smoke.py), flat across shapes whose FMA
// counts differ 1.7x, so neither is the limit: the instructions around the
// FMAs are. The projection makes one shared-memory load for
// every FMA and runs all its accumulators under a predicate, the expand one
// scalar and one 16-byte load per four FMAs plus a division per item, and
// f32 tiles of 37-108 KB leave 2-3 CTAs of 8 warps an SM with four barriers
// per 32-channel chunk. With the products on the tensor cores and bf16
// tiles the same blocks take 0.07-0.22 ms on the same card in the same run
// (csrc/fused_mbconv_mma.cu; PERF.md names the runs). This form is kept
// simple: it is the exact one.
//
// Design. The TPU kept one image's whole expanded tensor in VMEM; lite0's
// first fused block expands to 96 x 160 x 160 bf16 = 4.9 MB, far more than
// the 227 KB of shared memory a block can have. So each CTA takes one image
// and one kTile x kTile output tile, loads the input halo
// ((kTile - 1) * S + K)^2 x Cin into shared memory once, and loops over Cmid
// in chunks of kChunk channels. Per chunk it expands the halo into shared
// memory, runs the depthwise for the tile, and adds the chunk's partial
// projection into Cout x tile f32 accumulators held in registers (the TPU
// carried that sum across grid steps in a VMEM scratch; here it never leaves
// the block). Halo positions are recomputed by neighbouring tiles: the
// expand costs (halo / (kTile * S)^2) times the unfused work, 1.13x for
// k3 s2 and 2.25x for k5 s1 at kTile = 8. That is the price of keeping the
// intermediate out of device memory.
//
// SAME padding belongs to the expanded tensor: expanding an out-of-image
// position gives relu6(be), not 0, so the expanded value is set to 0 at halo
// positions outside the image (the Pallas kernel masked the tap term). The
// pads follow XLA's asymmetric rule, pad_lo = total / 2. Stride 2 reads the
// halo with a stride; the TPU's even/odd phase planes were a Mosaic
// constraint and have no counterpart. Ragged channel counts (Cin 16..48,
// Cmid 96..288, Cout 24..88) and tiles past the image edge are masked.
//
// The depthwise sum is __fadd_rn(acc, __fmul_rn(w, e)) from bd, taps in
// row-major order: the plain version's order and rounding, so with equal
// expanded values the two agree bit for bit there.
//
// Built by vbt_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (vbt_tpu_torch/ops/fused_mbconv.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;                       // output tile kTile x kTile per CTA
constexpr int kTilePos = kTile * kTile;        // 64 output positions
constexpr int kThreads = 256;
constexpr int kChunk = 32;                     // Cmid channels per pass
constexpr int kGroups = kThreads / kTilePos;   // 4 output-channel groups in the project
constexpr int kMaxAcc = 32;                    // accumulators per thread at most
constexpr int kMaxCout = kGroups * kMaxAcc;    // 128
constexpr size_t kMaxSmem = 232448;            // 227 KB, Hopper's per-block limit

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// A cast point: round to T and back.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

__device__ __forceinline__ float relu6(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

template <int K, int S>
struct Geometry {
  static constexpr int kHalo1 = (kTile - 1) * S + K;  // halo rows (= columns)
  static constexpr int kHalo = kHalo1 * kHalo1;
};

struct Args {
  const void* x;   // (B, Cin, H*W) T
  const void* we;  // (Cmid, Cin) T, or null without expand
  const float* be; // (Cmid,), or null without expand
  const float* wd; // (Cmid, K*K)
  const float* bd; // (Cmid,)
  const void* wp;  // (Cout, Cmid) T
  const float* bp; // (Cout,)
  void* out;       // (B, Cout, Ho*Wo) T
  int batch, cin, cmid, cout, h, w, kernel, stride;
  bool residual, has_expand;
  cudaStream_t stream;
};

// Shared memory, in floats, in this order: we chunk [Cin][kChunk] (first, so
// its float4 rows are 16-byte aligned), x halo [Cin][halo], expanded chunk
// [kChunk][halo], depthwise output [kChunk][kTilePos], wp chunk
// [Cout][kChunk], wd chunk [kChunk][K*K], be and bd chunks [kChunk].
__host__ __device__ inline size_t smem_floats(int cin, int cout, int halo, int kk) {
  return (size_t)cin * kChunk + (size_t)cin * halo + (size_t)kChunk * halo +
         (size_t)kChunk * kTilePos + (size_t)cout * kChunk + (size_t)kChunk * kk + 2 * kChunk;
}

template <typename T, int K, int S, int NACC>
__global__ void __launch_bounds__(kThreads)
fused_mbconv_kernel(const T* __restrict__ x, const T* __restrict__ we,
                    const float* __restrict__ be, const float* __restrict__ wd,
                    const float* __restrict__ bd, const T* __restrict__ wp,
                    const float* __restrict__ bp, T* __restrict__ out,
                    int cin, int cmid, int cout, int h, int w, int ho, int wo,
                    int pad_top, int pad_left, int tiles_x, bool residual, bool has_expand) {
  constexpr int H1 = Geometry<K, S>::kHalo1;
  constexpr int HALO = Geometry<K, S>::kHalo;
  constexpr int KK = K * K;

  extern __shared__ float4 smem4[];
  float* s_we = reinterpret_cast<float*>(smem4);
  float* s_x = s_we + cin * kChunk;
  float* s_e = s_x + cin * HALO;
  float* s_h2 = s_e + kChunk * HALO;
  float* s_wp = s_h2 + kChunk * kTilePos;
  float* s_wd = s_wp + cout * kChunk;
  float* s_be = s_wd + kChunk * KK;
  float* s_bd = s_be + kChunk;

  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_x) * kTile;  // first output row and column of the tile
  const int ox0 = (blockIdx.x % tiles_x) * kTile;
  const int iy0 = oy0 * S - pad_top;               // image row and column of halo (0, 0)
  const int ix0 = ox0 * S - pad_left;
  const int tid = threadIdx.x;
  const int64_t hw_in = (int64_t)h * w;
  const T* xb = x + (int64_t)b * cin * hw_in;

  // The input halo; positions outside the image are never used (their
  // expanded values are masked), 0 keeps them finite.
  for (int idx = tid; idx < cin * HALO; idx += kThreads) {
    const int i = idx / HALO, p = idx - i * HALO;
    const int iy = iy0 + p / H1, ix = ix0 + p % H1;
    float v = 0.f;
    if (iy >= 0 && iy < h && ix >= 0 && ix < w) v = to_f32(xb[i * hw_in + (int64_t)iy * w + ix]);
    s_x[idx] = v;
  }

  // Project accumulators: this thread owns output position q of the tile and
  // output channels g, g + kGroups, ...
  const int q = tid % kTilePos;
  const int g = tid / kTilePos;
  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < cmid; c0 += kChunk) {
    __syncthreads();  // s_x is written; the previous chunk's readers are done
    // This chunk's weights; channels past Cmid get 0 everywhere, so they
    // expand to 0, depthwise to 0 and project nothing.
    if (has_expand) {
      for (int idx = tid; idx < cin * kChunk; idx += kThreads) {
        const int i = idx / kChunk, c = idx - i * kChunk;
        s_we[idx] = c0 + c < cmid ? to_f32(we[(int64_t)(c0 + c) * cin + i]) : 0.f;
      }
    }
    for (int idx = tid; idx < cout * kChunk; idx += kThreads) {
      const int o = idx / kChunk, c = idx - o * kChunk;
      s_wp[idx] = c0 + c < cmid ? to_f32(wp[(int64_t)o * cmid + c0 + c]) : 0.f;
    }
    for (int idx = tid; idx < kChunk * KK; idx += kThreads) {
      s_wd[idx] = c0 + idx / KK < cmid ? wd[(int64_t)c0 * KK + idx] : 0.f;
    }
    if (tid < kChunk) {
      const bool in = c0 + tid < cmid;
      s_be[tid] = in && has_expand ? be[c0 + tid] : 0.f;
      s_bd[tid] = in ? bd[c0 + tid] : 0.f;
    }
    __syncthreads();

    // Expand the halo, 4 channels x 1 position per item: f32 sum of
    // products, + be, ReLU6, cast; 0 outside the image (SAME padding).
    for (int idx = tid; idx < (kChunk / 4) * HALO; idx += kThreads) {
      const int cg = idx / HALO, p = idx - cg * HALO;
      const int iy = iy0 + p / H1, ix = ix0 + p % H1;
      const bool inside = iy >= 0 && iy < h && ix >= 0 && ix < w;
      float v[4];
      if (has_expand) {
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        const float4* wrow = reinterpret_cast<const float4*>(s_we) + cg;
        for (int i = 0; i < cin; ++i) {
          const float xv = s_x[i * HALO + p];
          const float4 wv = wrow[i * (kChunk / 4)];
          a[0] = fmaf(wv.x, xv, a[0]);
          a[1] = fmaf(wv.y, xv, a[1]);
          a[2] = fmaf(wv.z, xv, a[2]);
          a[3] = fmaf(wv.w, xv, a[3]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = relu6(a[j] + s_be[cg * 4 + j]);
      } else {
        // No expand: the depthwise reads x itself (Cmid == Cin).
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + cg * 4 + j;
          v[j] = c < cmid ? s_x[c * HALO + p] : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) s_e[(cg * 4 + j) * HALO + p] = inside ? round_to<T>(v[j]) : 0.f;
    }
    __syncthreads();

    // Depthwise on the tile: from bd, + w * e over the taps, ReLU6, cast.
    for (int idx = tid; idx < kChunk * kTilePos; idx += kThreads) {
      const int c = idx / kTilePos, qq = idx - c * kTilePos;
      const float* e = s_e + c * HALO + (qq / kTile) * S * H1 + (qq % kTile) * S;
      const float* wdc = s_wd + c * KK;
      float a = s_bd[c];
#pragma unroll
      for (int ty = 0; ty < K; ++ty) {
#pragma unroll
        for (int tx = 0; tx < K; ++tx) {
          a = __fadd_rn(a, __fmul_rn(wdc[ty * K + tx], e[ty * H1 + tx]));
        }
      }
      s_h2[idx] = round_to<T>(relu6(a));
    }
    __syncthreads();

    // This chunk's share of the projection.
    for (int c = 0; c < kChunk; ++c) {
      const float hv = s_h2[c * kTilePos + q];
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        const int o = g + j * kGroups;
        if (o < cout) acc[j] = fmaf(s_wp[o * kChunk + c], hv, acc[j]);
      }
    }
  }

  // + bp, + the residual in f32, one cast; positions past the image edge are dropped.
  const int oy = oy0 + q / kTile, ox = ox0 + q % kTile;
  if (oy < ho && ox < wo) {
    const int64_t opos = (int64_t)oy * wo + ox;
    const int64_t plane = (int64_t)ho * wo;
    T* ob = out + (int64_t)b * cout * plane;
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      const int o = g + j * kGroups;
      if (o < cout) {
        float v = acc[j] + bp[o];
        if (residual) v += to_f32(xb[(int64_t)o * hw_in + opos]);  // stride 1: Wo == W
        ob[(int64_t)o * plane + opos] = from_f32<T>(v);
      }
    }
  }
}

template <typename T, int K, int S, int NACC>
int launch(const Args& a) {
  constexpr int HALO = Geometry<K, S>::kHalo;
  const int ho = (a.h + S - 1) / S, wo = (a.w + S - 1) / S;
  // XLA SAME: pad_lo = total / 2, so an odd total puts the extra pixel on the high side.
  const int pad_y = (ho - 1) * S + K - a.h, pad_x = (wo - 1) * S + K - a.w;
  const int pad_top = pad_y > 0 ? pad_y / 2 : 0;
  const int pad_left = pad_x > 0 ? pad_x / 2 : 0;
  const int tiles_y = (ho + kTile - 1) / kTile, tiles_x = (wo + kTile - 1) / kTile;
  const size_t smem = sizeof(float) * smem_floats(a.cin, a.cout, HALO, K * K);
  if (smem > kMaxSmem || (int64_t)tiles_x * tiles_y > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto kernel = fused_mbconv_kernel<T, K, S, NACC>;
  static bool configured = false;  // per instantiation; setting it twice is harmless
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(tiles_x * tiles_y, a.batch);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.we), a.be, a.wd, a.bd,
      static_cast<const T*>(a.wp), a.bp, static_cast<T*>(a.out), a.cin, a.cmid, a.cout, a.h,
      a.w, ho, wo, pad_top, pad_left, tiles_x, a.residual, a.has_expand);
  return (int)cudaGetLastError();
}

template <typename T, int K, int S>
int dispatch_acc(const Args& a) {
  const int nacc = (a.cout + kGroups - 1) / kGroups;
  if (nacc <= 8) return launch<T, K, S, 8>(a);
  if (nacc <= 16) return launch<T, K, S, 16>(a);
  return launch<T, K, S, kMaxAcc>(a);
}

template <typename T>
int dispatch(const Args& a) {
  if (a.kernel == 3) return a.stride == 1 ? dispatch_acc<T, 3, 1>(a) : dispatch_acc<T, 3, 2>(a);
  return a.stride == 1 ? dispatch_acc<T, 5, 1>(a) : dispatch_acc<T, 5, 2>(a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, we, wp and the output); be, wd, bd
// and bp are float32. Returns a cudaError_t: cudaErrorInvalidValue for
// arguments the kernel does not take, else the launch's own error.
extern "C" int vbt_fused_mbconv_launch(const void* x, const void* we, const float* be,
                                       const float* wd, const float* bd, const void* wp,
                                       const float* bp, void* out, int batch, int cin, int cmid,
                                       int cout, int h, int w, int kernel, int stride,
                                       int residual, int has_expand, int dtype, void* stream) {
  const bool bad_shape = batch < 1 || batch > 65535 || cin < 1 || cmid < 1 || cout < 1 ||
                         cout > kMaxCout || h < 1 || w < 1;
  const bool bad_op = (kernel != 3 && kernel != 5) || (stride != 1 && stride != 2) ||
                      (dtype != 0 && dtype != 1) || (!has_expand && cin != cmid) ||
                      (residual && (stride != 1 || cin != cout));
  const bool bad_ptr = !x || !wd || !bd || !wp || !bp || !out || (has_expand && (!we || !be));
  if (bad_shape || bad_op || bad_ptr) return (int)cudaErrorInvalidValue;
  const Args a{x, we, be, wd, bd, wp, bp, out, batch, cin, cmid, cout, h, w, kernel, stride,
               residual != 0, has_expand != 0, static_cast<cudaStream_t>(stream)};
  return dtype == 0 ? dispatch<float>(a) : dispatch<__nv_bfloat16>(a);
}
