// Greedy single-class NMS over the top-K decoded candidates of each image.
//
// Replaces the TPU kernel vbt_tpu/ops/nms_pallas.py:_nms_kernel (driven by
// detection_postprocess_pallas). Same arithmetic, step for step, as the plain
// torch version vbt_tpu_torch/ops/postprocess.py:nms_plain:
//   score = sigmoid(logit) (expf, not __expf; -inf pads give exactly 0);
//   live  = score >= score_threshold;
//   for each of max_detections rounds: take the max live score, ties to the
//   lowest candidate index; stop selecting once that max is 0; IoU of the
//   winner against every candidate (0 unless union > 0); suppress
//   iou > iou_threshold and the winner itself; write score, box and count.
//
// What bounds it on an H100: it reads B*K*5*4 bytes (655 KB at B = 64,
// K = 512), a fraction of a microsecond of HBM time, so it is bound by
// latency: 25 serial rounds, each a block-wide argmax (two barriers) and an
// IoU pass. The design keeps everything a round touches on chip: one CTA of
// 512 threads per image, one candidate per thread, the candidate's score,
// box, area and live flag in registers, the box planes and area in ~10 KB of
// shared memory for the winner's gather, and the argmax as warp shuffles plus
// one pass over the 16 warp results. Images run in parallel across the SMs.
// Making the rounds cheaper (fewer barriers, several images per CTA) is
// later work.
//
// Products and sums in the IoU use __fmul_rn/__fadd_rn/__fsub_rn so nvcc
// cannot contract them into FMAs, which would round differently from the
// plain version and could flip an iou > threshold decision.
//
// Built by vbt_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (vbt_tpu_torch/ops/nms_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCandidates = 512;  // threads per CTA, one candidate each
constexpr int kWarps = kMaxCandidates / 32;

__device__ __forceinline__ void argmax_step(float& v, int& i, float ov, int oi) {
  // Larger value wins; among equal values the lower index wins.
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kMaxCandidates)
nms_kernel(const float* __restrict__ logits,  // (B, K)
           const float* __restrict__ boxes,   // (B, K, 4) ymin, xmin, ymax, xmax
           int32_t* __restrict__ out_count,   // (B,)
           float* __restrict__ out_scores,    // (B, D)
           float* __restrict__ out_boxes,     // (B, D, 4)
           int k, int max_det, float iou_threshold, float score_threshold) {
  __shared__ float s_ymin[kMaxCandidates], s_xmin[kMaxCandidates];
  __shared__ float s_ymax[kMaxCandidates], s_xmax[kMaxCandidates];
  __shared__ float s_area[kMaxCandidates];
  __shared__ float s_warp_v[kWarps];
  __shared__ int s_warp_i[kWarps];
  __shared__ float s_max;
  __shared__ int s_win;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  // Candidates past K are pads: score 0, never live.
  float score = 0.f;
  float ymin = 0.f, xmin = 0.f, ymax = 0.f, xmax = 0.f;
  bool live = false;
  if (t < k) {
    const float logit = logits[(int64_t)b * k + t];
    score = 1.f / (1.f + expf(-logit));
    const float4 bx = reinterpret_cast<const float4*>(boxes)[(int64_t)b * k + t];
    ymin = bx.x;
    xmin = bx.y;
    ymax = bx.z;
    xmax = bx.w;
    live = score >= score_threshold;
  }
  const float area = __fmul_rn(__fsub_rn(ymax, ymin), __fsub_rn(xmax, xmin));
  s_ymin[t] = ymin;
  s_xmin[t] = xmin;
  s_ymax[t] = ymax;
  s_xmax[t] = xmax;
  s_area[t] = area;

  // Unfilled slots are 0, as in the Pallas kernel's zero-initialised outputs.
  float* scores_b = out_scores + (int64_t)b * max_det;
  float* boxes_b = out_boxes + (int64_t)b * max_det * 4;
  for (int j = t; j < max_det; j += blockDim.x) {
    scores_b[j] = 0.f;
    reinterpret_cast<float4*>(boxes_b)[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  int count = 0;
  for (int round = 0; round < max_det; ++round) {
    float v = live ? score : 0.f;
    int idx = t;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      argmax_step(v, idx, __shfl_down_sync(0xffffffffu, v, off),
                  __shfl_down_sync(0xffffffffu, idx, off));
    }
    if (lane == 0) {
      s_warp_v[warp] = v;
      s_warp_i[warp] = idx;
    }
    __syncthreads();  // also publishes the shared box planes on round 0
    if (warp == 0) {
      v = lane < kWarps ? s_warp_v[lane] : -1.f;
      idx = lane < kWarps ? s_warp_i[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        argmax_step(v, idx, __shfl_down_sync(0xffffffffu, v, off),
                    __shfl_down_sync(0xffffffffu, idx, off));
      }
      if (lane == 0) {
        s_max = v;
        s_win = idx;
      }
    }
    __syncthreads();
    const float m = s_max;
    const int win = s_win;
    if (!(m > 0.f)) break;  // uniform across the block: every later round finds nothing too

    const float w_ymin = s_ymin[win], w_xmin = s_xmin[win];
    const float w_ymax = s_ymax[win], w_xmax = s_xmax[win];
    const float w_area = s_area[win];
    const float inter_h = fmaxf(0.f, __fsub_rn(fminf(ymax, w_ymax), fmaxf(ymin, w_ymin)));
    const float inter_w = fmaxf(0.f, __fsub_rn(fminf(xmax, w_xmax), fmaxf(xmin, w_xmin)));
    const float inter = __fmul_rn(inter_h, inter_w);
    const float uni = __fsub_rn(__fadd_rn(area, w_area), inter);
    const float iou = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
    if (iou > iou_threshold || t == win) live = false;

    if (t == 0) {
      scores_b[round] = m;
      reinterpret_cast<float4*>(boxes_b)[round] = make_float4(w_ymin, w_xmin, w_ymax, w_xmax);
    }
    ++count;
  }
  if (t == 0) out_count[b] = count;
}

}  // namespace

extern "C" int vbt_nms_launch(const float* logits, const float* boxes, int32_t* out_count,
                              float* out_scores, float* out_boxes, int batch, int k,
                              int max_det, float iou_threshold, float score_threshold,
                              void* stream) {
  if (batch <= 0 || k <= 0 || k > kMaxCandidates || max_det <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  nms_kernel<<<batch, kMaxCandidates, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, boxes, out_count, out_scores, out_boxes, k, max_det, iou_threshold,
      score_threshold);
  return (int)cudaGetLastError();
}
