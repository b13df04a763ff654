// One whole inference MBConv block in bfloat16 with both 1x1 products on the
// tensor cores (1x1 expand + ReLU6, k x k depthwise + ReLU6, 1x1 project,
// optional residual), BatchNorms folded into the weights.
//
// Replaces the TPU kernel vbt_tpu/ops/fused_mbconv.py:_mbconv_kernel (driven
// by fused_mbconv there) for bf16 blocks; csrc/fused_mbconv.cu holds the FMA
// form that serves float32. Same arithmetic and rounding points as the plain
// torch version vbt_tpu_torch/ops/fused_mbconv.py:fused_mbconv_plain: the
// expanded value and the depthwise output are rounded to bf16, every sum is
// f32, the output is rounded once after bias and residual. The two 1x1
// products are summed by mma.sync in the tensor cores' order, so a sum can
// land on the other side of a bf16 rounding step from the plain version's;
// the depthwise keeps the plain version's order exactly.
//
// What bounds it on an H100. Only x and the output cross device memory
// (12-72 MB for the five EfficientDet-Lite0 blocks at 64 images, 4-22 us at
// 3.35 TB/s) and the products are a few hundred tensor-core instructions a
// CTA, so neither bytes nor the tensor cores are the limit. It is bound by
// instruction throughput and latency on the ordinary pipes: the depthwise taps
// (an unfused multiply and add each, to keep the plain version's rounding:
// at the f32 pipes' full rate they alone are 0.04 ms of the 0.19 ms that
// Lite0's g1_b1 takes at 64 images on an NVIDIA H100 80GB HBM3 at 700 W,
// python3 chip_smoke.py), the expand's
// epilogue (bias, ReLU6, mask, cast and store of every expanded value, halo
// included), and the two barriers a chunk with 12-24 warps an SM to hide
// them. It runs at about 10x its bound (PERF.md names the runs).
//
// Design. One CTA of 6 warps takes one image and one TH x TW tile of output
// positions (8x8; 8x16 at stride 1 where three CTAs of it fit an SM, since
// neighbouring tiles recompute each other's halo). It loads the input halo
// ((TH-1)*S+K) x ((TW-1)*S+K) x Cin once into shared memory as bf16,
// position-major with the channels contiguous and padded with zeros to a
// multiple of 16 (the K of one mma), and walks Cmid in chunks of 48
// channels, which divide every Cmid of EfficientDet-Lite0-2. Per chunk:
//   expand   [halo positions x Cin] @ [Cin x 48] as m16n8k16 products, A
//            and B by ldmatrix (we as stored, (Cmid, Cin), is the "col"
//            operand). A warp keeps one half of the chunk's channels: its we
//            fragments and biases stay in registers over its m-tiles. + be,
//            ReLU6 (min, then the conversion's own max with 0), 0 where the
//            halo position's inside-the-image flag is 0, bf16 pairs into
//            the expanded tile [position][channel];
//   depthwise each thread takes one channel pair and a run of 8 outputs of
//            one tile row, so a loaded bf16x2 value serves up to K taps of
//            both channels; from bd, __fadd_rn(acc, __fmul_rn(w, e)), taps
//            in row-major order; ReLU6, bf16 pairs into [position][48];
//   project  [TH*TW x 48] @ [48 x Cout] as m16n8k16 products into f32
//            accumulators that stay in registers across the chunks.
// The chunk's weights come by cp.async into one of two buffers, the next
// chunk's while this one's depthwise runs, so a chunk costs two barriers
// (after the expand and after the depthwise; a chunk's projection and the
// next chunk's expand share an interval) and no wait for device memory. Rows of every tile are padded to an odd number of
// 16-byte units, which keeps ldmatrix and the epilogue stores free of bank
// conflicts. The residual is read back from the halo in shared memory.
//
// Layouts. x is contiguous (B, Cin, H*W), gathered into the position-major
// halo with 2-byte loads, or channels-last (B, H*W, Cin), where a position's
// channels are one run and the halo comes by cp.async in 16-byte pieces; the
// output goes out the same way (bf16 pairs a store when channels-last). The
// turbo backbone serves channels-last, which is also what cuDNN wants of the
// unfused blocks around.
//
// Registers. Each (K, S, tile) is built three times, with its registers held
// to 2, 3 or 4 CTAs an SM, and the launcher takes the build the block's
// shared memory lets fit: a block whose tiles let only 2 CTAs fit runs
// faster with 136-140 registers than with 96.
//
// SAME padding belongs to the expanded tensor: a halo position outside the
// image holds 0 after the expand, not relu6(be). XLA's asymmetric rule,
// pad_lo = total / 2. Tiles past the image edge compute and drop.
//
// It takes Cin (at most 48) and Cout that are multiples of 8, Cmid a multiple
// of 48 and a block with an expand conv; the wrapper's launch plan sends
// other blocks to the FMA kernel. Built by vbt_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (vbt_tpu_torch/ops/fused_mbconv.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 192;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 48;               // Cmid channels per pass
constexpr int kPairs = kChunk / 2;       // channel pairs of a chunk
constexpr int kChunkPitch = kChunk + 8;  // bf16 elements a row of the expanded and depthwise tiles
constexpr int kPitchWords = kChunkPitch / 2;
constexpr int kKPad = 8;                 // bf16 elements added to a row of the x and we tiles
constexpr int kMaxKSteps = 3;            // k-steps of 16 input channels the expand is built for
constexpr int kMaxCin = 16 * kMaxKSteps;
constexpr int kMaxSmem = 232448;         // 227 KB, Hopper's per-block limit
constexpr int kSmemPerSm = 233472;       // 228 KB of shared memory an SM

// ---- PTX wrappers ----
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the address of one 16-byte row.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// Two 8x8 b16 matrices; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a (16x16, row) @ b (16x8, col), bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from device memory to shared memory, both 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Two floats rounded to nearest even into a bf16 pair, lo in the low half.
__device__ __forceinline__ uint32_t cvt_bf16x2(float hi, float lo) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The same of max(v, 0).
__device__ __forceinline__ uint32_t cvt_relu_bf16x2(float hi, float lo) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
// ---- end of PTX wrappers ----

// ReLU6 of two floats, rounded to nearest even into a bf16 pair, the first
// in the low half: min with 6 first, then the conversion's own max with 0
// (6 and 0 are bf16 values and rounding is monotonic, so this is clamp, then cast).
__device__ __forceinline__ uint32_t relu6_bf16x2(float lo, float hi) {
  return cvt_relu_bf16x2(fminf(hi, 6.f), fminf(lo, 6.f));
}

__device__ __forceinline__ float bf16_lo(uint32_t pair) { return __uint_as_float(pair << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t pair) {
  return __uint_as_float(pair & 0xffff0000u);
}

struct Params {
  const uint16_t* x;   // (B, Cin, H*W) bf16, or (B, H*W, Cin) when channels_last
  const uint16_t* we;  // (Cmid, Cin) bf16
  const float* be;     // (Cmid,)
  const float* wd;     // (Cmid, K*K)
  const float* bd;     // (Cmid,)
  const uint16_t* wp;  // (Cout, Cmid) bf16
  const float* bp;     // (Cout,)
  uint16_t* out;       // (B, Cout, Ho*Wo) bf16, or (B, Ho*Wo, Cout) when channels_last
  int cin, kpad, cmid, cout, h, w, ho, wo, pad_top, pad_left, tiles_x, residual, channels_last;
};

template <int K, int S, int TH, int TW>
struct Geometry {
  static constexpr int kH1 = (TH - 1) * S + K;       // halo rows
  static constexpr int kW1 = (TW - 1) * S + K;       // halo columns
  static constexpr int kHalo = kH1 * kW1;            // halo positions
  static constexpr int kHaloRows = (kHalo + 15) / 16 * 16;  // rounded up to whole m-tiles
  static constexpr int kTilePos = TH * TW;
};

// Bytes of one weight buffer: we chunk [48][kpad + 8] bf16, wp chunk
// [Cout][56] bf16, wd chunk [48][K*K] f32, be and bd chunks [48] f32.
__host__ __device__ inline int weight_buffer_bytes(int kpad, int cout, int kk) {
  return kChunk * (kpad + kKPad) * 2 + cout * kChunkPitch * 2 + kChunk * kk * 4 + 2 * kChunk * 4;
}

// Dynamic shared memory: x halo [halo rows][kpad + 8] bf16, expanded chunk
// [halo rows][56] bf16, depthwise output [TH*TW][56] bf16, two weight
// buffers, one inside-the-image flag a halo row.
__host__ __device__ inline int smem_bytes(int halo_rows, int tile_pos, int kpad, int cout,
                                           int kk) {
  return 2 * (halo_rows * (kpad + kKPad) + halo_rows * kChunkPitch + tile_pos * kChunkPitch) +
         2 * weight_buffer_bytes(kpad, cout, kk) + halo_rows;
}

// NU: project accumulators (m16n8 units) a warp holds; TH*TW/16 * Cout/8 <= 6 * NU.
// MINB: CTAs an SM the registers are held to (the launcher takes what the
// shared memory lets fit).
template <int K, int S, int TH, int TW, int RUN, int NU, int MINB>
__global__ void __launch_bounds__(kThreads, MINB) mbconv_mma_kernel(const Params p) {
  using G = Geometry<K, S, TH, TW>;
  constexpr int W1 = G::kW1;
  constexpr int P = G::kHalo;
  constexpr int MT = G::kHaloRows / 16;  // m-tiles of the expand
  constexpr int TP = G::kTilePos;
  constexpr int MTP = TP / 16;           // m-tiles of the projection
  constexpr int KK = K * K;
  constexpr int RUNS = TW / RUN;         // runs of outputs in a tile row
  constexpr int NCOL = (RUN - 1) * S + K;  // halo columns one run reads
  static_assert(TP % 16 == 0 && TW % RUN == 0, "tile shape");
  static_assert(kWarps % 2 == 0, "the expand splits the warps over two n-halves");

  extern __shared__ uint4 smem_raw[];
  const int kp = p.kpad + kKPad;  // row pitch of the x and we tiles, bf16 elements
  uint16_t* s_x = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* s_e = s_x + G::kHaloRows * kp;
  uint16_t* s_h = s_e + G::kHaloRows * kChunkPitch;
  unsigned char* s_w = reinterpret_cast<unsigned char*>(s_h + TP * kChunkPitch);
  const int we_bytes = kChunk * kp * 2;
  const int wp_bytes = p.cout * kChunkPitch * 2;
  const int wbuf_bytes = weight_buffer_bytes(p.kpad, p.cout, KK);
  unsigned char* s_in = s_w + 2 * wbuf_bytes;  // 1 where the halo position lies in the image

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / p.tiles_x) * TH;  // first output row and column of the tile
  const int ox0 = (blockIdx.x % p.tiles_x) * TW;
  const int iy0 = oy0 * S - p.pad_top;            // image row and column of halo (0, 0)
  const int ix0 = ox0 * S - p.pad_left;
  const int64_t hw_in = (int64_t)p.h * p.w;
  const uint16_t* xb = p.x + (int64_t)b * p.cin * hw_in;

  // Start the copy of chunk c0's weights into buffer buf.
  auto start_weights = [&](int c0, unsigned char* buf) {
    uint16_t* d_we = reinterpret_cast<uint16_t*>(buf);
    uint16_t* d_wp = reinterpret_cast<uint16_t*>(buf + we_bytes);
    float* d_wd = reinterpret_cast<float*>(buf + we_bytes + wp_bytes);
    float* d_be = d_wd + kChunk * KK;
    float* d_bd = d_be + kChunk;
    // Eight threads a row, one 16-byte piece each: a we row has Cin / 8 <= 6
    // pieces, a wp row's chunk 6.
    const int q = tid & 7;
    if (q < p.cin / 8) {
      for (int r = tid >> 3; r < kChunk; r += kThreads / 8) {
        cp_async16(d_we + r * kp + q * 8, p.we + (int64_t)(c0 + r) * p.cin + q * 8);
      }
    }
    if (q < kChunk / 8) {
      for (int o = tid >> 3; o < p.cout; o += kThreads / 8) {
        cp_async16(d_wp + o * kChunkPitch + q * 8, p.wp + (int64_t)o * p.cmid + c0 + q * 8);
      }
    }
    for (int i = tid; i < kChunk * KK / 4; i += kThreads) {
      cp_async16(d_wd + i * 4, p.wd + (int64_t)c0 * KK + i * 4);
    }
    if (tid < kChunk / 4) {
      cp_async16(d_be + tid * 4, p.be + c0 + tid * 4);
    } else if (tid < kChunk / 2) {
      cp_async16(d_bd + (tid - kChunk / 4) * 4, p.bd + c0 + (tid - kChunk / 4) * 4);
    }
    cp_async_commit();
  };

  // The we tiles' K padding (columns Cin .. kpad) stays 0 in both buffers.
  const int kfill = p.kpad - p.cin;
  for (int i = tid; i < 2 * kChunk * kfill; i += kThreads) {
    const int buf = i / (kChunk * kfill), rem = i - buf * (kChunk * kfill);
    const int r = rem / kfill, c = p.cin + rem - r * kfill;
    reinterpret_cast<uint16_t*>(s_w + buf * wbuf_bytes)[r * kp + c] = 0;
  }
  start_weights(0, s_w);

  // The input halo: a position's channels go to one row of s_x, 0 outside
  // the image, in the K padding and in the rows that fill the last m-tile.
  // SAME padding belongs to the expanded tensor: the expand writes 0 where
  // the position's flag is 0.
  if (p.channels_last) {
    // A position's channels are contiguous: eight threads a position, one
    // 16-byte piece each, copied asynchronously like the weights.
    const int q = tid & 7;
    if (q < p.kpad / 8) {
      for (int pos = tid >> 3; pos < G::kHaloRows; pos += kThreads / 8) {
        const int hy = pos / W1, hx = pos - hy * W1;
        const int iy = iy0 + hy, ix = ix0 + hx;
        const bool inside = pos < P && iy >= 0 && iy < p.h && ix >= 0 && ix < p.w;
        if (q == 0) s_in[pos] = inside;
        uint16_t* dst = s_x + pos * kp + q * 8;
        if (inside && q < p.cin / 8) {
          cp_async16(dst, xb + ((int64_t)iy * p.w + ix) * p.cin + q * 8);
        } else {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
  } else
  // Contiguous NCHW: a position a thread, which gathers its channels.
  for (int pos = tid; pos < G::kHaloRows; pos += kThreads) {
    const int hy = pos / W1, hx = pos - hy * W1;
    const int iy = iy0 + hy, ix = ix0 + hx;
    const bool inside = pos < P && iy >= 0 && iy < p.h && ix >= 0 && ix < p.w;
    s_in[pos] = inside;
    uint32_t* dst = reinterpret_cast<uint32_t*>(s_x + pos * kp);
    const uint16_t* src = xb + (inside ? (int64_t)iy * p.w + ix : 0);
#pragma unroll 4
    for (int c = 0; c < p.cin; c += 2) {
      uint32_t v = 0;
      if (inside) {
        v = static_cast<uint32_t>(src[c * hw_in]) |
            (static_cast<uint32_t>(src[(c + 1) * hw_in]) << 16);
      }
      dst[c >> 1] = v;
    }
    for (int c = p.cin; c < p.kpad; c += 2) dst[c >> 1] = 0u;
  }

  // Projection accumulators: unit u = warp + 6 j is m-tile u % MTP of the
  // output tile and output channels 8 (u / MTP) .. + 7.
  const int nunits = MTP * (p.cout / 8);
  float acc[NU][4];
#pragma unroll
  for (int j = 0; j < NU; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }

  const int ksteps = p.kpad / 16;
  const int g = lane >> 2, t = lane & 3;  // row and column pair of an mma's C fragment
  const int nchunks = p.cmid / kChunk;
  cp_async_wait_all();
  __syncthreads();  // the first chunk's weights, s_x and s_in are in
  for (int ci = 0; ci < nchunks; ++ci) {
    unsigned char* buf = s_w + (ci & 1) * wbuf_bytes;
    const uint16_t* c_we = reinterpret_cast<const uint16_t*>(buf);
    const uint16_t* c_wp = reinterpret_cast<const uint16_t*>(buf + we_bytes);
    const float* c_wd = reinterpret_cast<const float*>(buf + we_bytes + wp_bytes);
    const float* c_be = c_wd + kChunk * KK;
    const float* c_bd = c_be + kChunk;

    // Expand. A warp keeps one half of the chunk's 6 n-tiles: its we
    // fragments and biases stay in registers while it walks its share of the
    // m-tiles of 16 halo positions (3 warps a half).
    {
      const int nh = warp & 1;
      uint32_t bw[kMaxKSteps][3][2];  // [k-step][n-tile][fragment]
      float2 bias[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        bias[j] = *reinterpret_cast<const float2*>(c_be + (nh * 3 + j) * 8 + 2 * t);
#pragma unroll
        for (int ks = 0; ks < kMaxKSteps; ++ks) {
          if (ks < ksteps) {
            ldmatrix_x2(bw[ks][j], c_we + ((nh * 3 + j) * 8 + (lane & 7)) * kp + ks * 16 +
                                       ((lane >> 3) & 1) * 8);
          }
        }
      }
      uint32_t* e_words = reinterpret_cast<uint32_t*>(s_e) + (nh * 3) * 4 + t;
      for (int mt = warp >> 1; mt < MT; mt += kWarps / 2) {
        float c[3][4];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
        }
#pragma unroll
        for (int ks = 0; ks < kMaxKSteps; ++ks) {
          if (ks < ksteps) {
            uint32_t a[4];
            ldmatrix_x4(a, s_x + (mt * 16 + (lane & 15)) * kp + ks * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int j = 0; j < 3; ++j) mma_bf16(c[j], a, bw[ks][j]);
          }
        }
        // + be, ReLU6, 0 outside the image, bf16 pairs.
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int pos = mt * 16 + g + half * 8;
          const bool inside = s_in[pos] != 0;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const uint32_t v =
                relu6_bf16x2(c[j][half * 2] + bias[j].x, c[j][half * 2 + 1] + bias[j].y);
            e_words[pos * kPitchWords + j * 4] = inside ? v : 0u;
          }
        }
      }
    }
    __syncthreads();  // the expanded tile is whole; the last chunk's projection is done
    // The next chunk's weights go to the buffer that projection read, while
    // this chunk's depthwise runs.
    if (ci + 1 < nchunks) start_weights((ci + 1) * kChunk, s_w + ((ci + 1) & 1) * wbuf_bytes);

    // Depthwise: item = (channel pair, tile row, run of RUN outputs).
    for (int item = tid; item < kPairs * TH * RUNS; item += kThreads) {
      const int cp = item % kPairs, r = item / kPairs;
      const int oyl = r / RUNS, oxl0 = (r - oyl * RUNS) * RUN;
      const float2 bias = *reinterpret_cast<const float2*>(c_bd + 2 * cp);
      float a0[RUN], a1[RUN];
#pragma unroll
      for (int o = 0; o < RUN; ++o) {
        a0[o] = bias.x;
        a1[o] = bias.y;
      }
      const uint32_t* e = reinterpret_cast<const uint32_t*>(s_e) +
                          (oyl * S * W1 + oxl0 * S) * kPitchWords + cp;
      const float* w0 = c_wd + (2 * cp) * KK;
      const float* w1 = w0 + KK;
#pragma unroll
      for (int ty = 0; ty < K; ++ty) {
        float wa[K], wb[K];
#pragma unroll
        for (int tx = 0; tx < K; ++tx) {
          wa[tx] = w0[ty * K + tx];
          wb[tx] = w1[ty * K + tx];
        }
        // Columns in ascending order: output o meets its taps tx = 0 .. K-1
        // at columns o * S + tx, so each output's sum keeps the row-major tap order.
#pragma unroll
        for (int col = 0; col < NCOL; ++col) {
          const uint32_t pair = e[(ty * W1 + col) * kPitchWords];
          const float e0 = bf16_lo(pair), e1 = bf16_hi(pair);
#pragma unroll
          for (int tx = 0; tx < K; ++tx) {
            if (col - tx >= 0 && (col - tx) % S == 0 && (col - tx) / S < RUN) {
              const int o = (col - tx) / S;
              a0[o] = __fadd_rn(a0[o], __fmul_rn(wa[tx], e0));
              a1[o] = __fadd_rn(a1[o], __fmul_rn(wb[tx], e1));
            }
          }
        }
      }
      uint32_t* dst = reinterpret_cast<uint32_t*>(s_h) + (oyl * TW + oxl0) * kPitchWords + cp;
#pragma unroll
      for (int o = 0; o < RUN; ++o) dst[o * kPitchWords] = relu6_bf16x2(a0[o], a1[o]);
    }
    cp_async_wait_all();
    __syncthreads();  // the depthwise tile is whole and the next chunk's weights are in

    // This chunk's share of the projection.
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      const int u = warp + j * kWarps;
      if (u < nunits) {  // the same for the whole warp
        const int m = u % MTP, n = u / MTP;
#pragma unroll
        for (int ks = 0; ks < kChunk / 16; ++ks) {
          uint32_t a[4], bw[2];
          ldmatrix_x4(a, s_h + (m * 16 + (lane & 15)) * kChunkPitch + ks * 16 + (lane >> 4) * 8);
          ldmatrix_x2(bw, c_wp + (n * 8 + (lane & 7)) * kChunkPitch + ks * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(acc[j], a, bw);
        }
      }
    }
  }

  // + bp, + the residual in f32 (x at the output position, from the halo),
  // one cast; positions past the image edge are dropped.
  const int64_t plane = (int64_t)p.ho * p.wo;
  uint16_t* ob = p.out + (int64_t)b * p.cout * plane;
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    const int u = warp + j * kWarps;
    if (u < nunits) {
      const int m = u % MTP, n = u / MTP;
      const int o = n * 8 + 2 * t;
      const float2 bias = *reinterpret_cast<const float2*>(p.bp + o);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = m * 16 + g + half * 8;
        const int oyl = q / TW, oxl = q - oyl * TW;
        const int oy = oy0 + oyl, ox = ox0 + oxl;
        if (oy < p.ho && ox < p.wo) {
          float v0 = acc[j][half * 2] + bias.x;
          float v1 = acc[j][half * 2 + 1] + bias.y;
          if (p.residual) {  // stride 1: the output position's own halo position
            const uint32_t pair = *reinterpret_cast<const uint32_t*>(
                s_x + ((oyl + p.pad_top) * W1 + oxl + p.pad_left) * kp + o);
            v0 += bf16_lo(pair);
            v1 += bf16_hi(pair);
          }
          const uint32_t pair = cvt_bf16x2(v1, v0);
          const int64_t opos = (int64_t)oy * p.wo + ox;
          if (p.channels_last) {
            *reinterpret_cast<uint32_t*>(ob + opos * p.cout + o) = pair;
          } else {
            ob[(int64_t)o * plane + opos] = static_cast<uint16_t>(pair & 0xffffu);
            ob[(int64_t)(o + 1) * plane + opos] = static_cast<uint16_t>(pair >> 16);
          }
        }
      }
    }
  }
}

// ---- host side ----
struct Args {
  Params p;
  int batch, kernel, stride, tile_h, tile_w, smem;
  cudaStream_t stream;
};

template <int K, int S, int TH, int TW, int RUN, int NU, int MINB>
int launch_with(const Args& a, const Params& p, int smem, int tiles_y) {
  auto kernel = mbconv_mma_kernel<K, S, TH, TW, RUN, NU, MINB>;
  static bool configured = false;  // per instantiation; setting it twice is harmless
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(p.tiles_x * tiles_y, a.batch);
  kernel<<<grid, kThreads, smem, a.stream>>>(p);
  return (int)cudaGetLastError();
}

template <int K, int S, int TH, int TW, int RUN, int NU>
int launch(const Args& a) {
  using G = Geometry<K, S, TH, TW>;
  Params p = a.p;
  p.ho = (p.h + S - 1) / S;
  p.wo = (p.w + S - 1) / S;
  // XLA SAME: pad_lo = total / 2, so an odd total puts the extra pixel on the high side.
  const int pad_y = (p.ho - 1) * S + K - p.h, pad_x = (p.wo - 1) * S + K - p.w;
  p.pad_top = pad_y > 0 ? pad_y / 2 : 0;
  p.pad_left = pad_x > 0 ? pad_x / 2 : 0;
  const int tiles_y = (p.ho + TH - 1) / TH;
  p.tiles_x = (p.wo + TW - 1) / TW;
  const int smem = smem_bytes(G::kHaloRows, G::kTilePos, p.kpad, p.cout, K * K);
  // The caller's launch plan and this file must agree on the shared memory.
  if (smem != a.smem || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if ((G::kTilePos / 16) * (p.cout / 8) > kWarps * NU) return (int)cudaErrorInvalidValue;
  if ((int64_t)p.tiles_x * tiles_y > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // CTAs that fit an SM's 228 KB, each with 1 KB the system reserves: the
  // build whose registers are held to as many, between 2 and 4.
  const int fit = kSmemPerSm / (smem + 1024);
  if (fit >= 4) return launch_with<K, S, TH, TW, RUN, NU, 4>(a, p, smem, tiles_y);
  if (fit == 3) return launch_with<K, S, TH, TW, RUN, NU, 3>(a, p, smem, tiles_y);
  return launch_with<K, S, TH, TW, RUN, NU, 2>(a, p, smem, tiles_y);
}

}  // namespace

// One bf16 block on the tensor cores. x, we, wp and the output are bfloat16;
// be, wd, bd and bp are float32; every pointer is 16-byte aligned. x is
// (B, Cin, H*W) and the output (B, Cout, Ho*Wo), or with channels_last
// (B, H*W, Cin) and (B, Ho*Wo, Cout). tile_h,
// tile_w and smem are the caller's launch plan: a tile this file has no
// kernel for, or a shared-memory size that differs from this file's own,
// is refused. Returns a cudaError_t: cudaErrorInvalidValue for arguments the
// kernel does not take, else the launch's own error.
extern "C" int vbt_fused_mbconv_mma_launch(const void* x, const void* we, const float* be,
                                           const float* wd, const float* bd, const void* wp,
                                           const float* bp, void* out, int batch, int cin,
                                           int cmid, int cout, int h, int w, int kernel,
                                           int stride, int residual, int channels_last,
                                           int tile_h, int tile_w, int smem, void* stream) {
  const bool bad_shape = batch < 1 || batch > 65535 || cin < 8 || cin > kMaxCin || cin % 8 != 0 ||
                         cmid < kChunk ||
                         cmid % kChunk != 0 || cout < 8 || cout % 8 != 0 || h < 1 || w < 1;
  const bool bad_op = (kernel != 3 && kernel != 5) || (stride != 1 && stride != 2) ||
                      (residual && (stride != 1 || cin != cout));
  const void* ptrs[] = {x, we, be, wd, bd, wp, bp, out};
  bool bad_ptr = false;
  for (const void* ptr : ptrs) {
    bad_ptr = bad_ptr || !ptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0;
  }
  if (bad_shape || bad_op || bad_ptr) return (int)cudaErrorInvalidValue;
  Args a{};
  a.p.x = static_cast<const uint16_t*>(x);
  a.p.we = static_cast<const uint16_t*>(we);
  a.p.be = be;
  a.p.wd = wd;
  a.p.bd = bd;
  a.p.wp = static_cast<const uint16_t*>(wp);
  a.p.bp = bp;
  a.p.out = static_cast<uint16_t*>(out);
  a.p.cin = cin;
  a.p.kpad = (cin + 15) / 16 * 16;
  a.p.cmid = cmid;
  a.p.cout = cout;
  a.p.h = h;
  a.p.w = w;
  a.p.residual = residual != 0;
  a.p.channels_last = channels_last != 0;
  a.batch = batch;
  a.kernel = kernel;
  a.stride = stride;
  a.tile_h = tile_h;
  a.tile_w = tile_w;
  a.smem = smem;
  a.stream = static_cast<cudaStream_t>(stream);
  if (tile_h == 8 && tile_w == 8) {
    if (kernel == 3) return stride == 1 ? launch<3, 1, 8, 8, 8, 8>(a) : launch<3, 2, 8, 8, 8, 8>(a);
    return stride == 1 ? launch<5, 1, 8, 8, 8, 8>(a) : launch<5, 2, 8, 8, 8, 8>(a);
  }
  if (tile_h == 8 && tile_w == 16 && stride == 1) {
    return kernel == 3 ? launch<3, 1, 8, 16, 8, 8>(a) : launch<5, 1, 8, 16, 8, 8>(a);
  }
  return (int)cudaErrorInvalidValue;
}
