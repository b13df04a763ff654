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
// K = 512), a fraction of a microsecond of HBM time, and does a few hundred
// thousand operations, so it is bound by the latency of its 25 serial
// rounds: a round cannot start before the last one's winner is known.
//
// Design: a round crosses as few threads as it can. The 4 warps of a CTA own
// one image and every lane keeps 4 consecutive candidates in registers: the
// score's bit pattern as the sort key (scores are >= 0, so they order as
// unsigned integers; 0 once the candidate is dead), the box and its area.
// One warp an image with 16 candidates a lane, and two with 8, were slower:
// a lane's candidates make a round that many dependent passes long (PERF.md
// has the times). A round is a pass over the
// lane's own keys, one __reduce_max_sync, one __ballot_sync on equality
// (lane l holds candidates below lane l + 1's, so the lowest lane among the
// ties holds the lowest index) and one shuffle for the winner's index; the
// winner's box is one broadcast 16-byte load from the image's boxes in
// shared memory. The image's warps swap their (max, index) pairs through
// shared memory behind one barrier a round, double-buffered by round parity
// so that one barrier is enough.
//
// Products and sums in the IoU use __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn
// so nvcc cannot contract them into FMAs or take a fast division, which
// would round differently from the plain version and could flip an
// iou > threshold decision. The exact division is a long, branchy chain
// (reciprocal, Newton steps, a range check and a slow path) that a lone
// warp cannot hide, and the quotient itself is never written out: only the
// decision iou > threshold is. So a candidate whose inter lies outside
// union * threshold * (1 -+ 2^-10) is decided by that comparison, whose own
// rounding (2^-22 relative) is far inside the margin, and the division is
// taken only inside the band, where rounding could matter, or where the
// operands leave the range the margin was proved for. Every decision is the
// one __fdiv_rn(inter, union) > threshold gives.
//
// Built by vbt_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (vbt_tpu_torch/ops/nms_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCandidates = 512;
constexpr int G = 4;                          // warps an image, which is a CTA
constexpr int kThreads = 32 * G;
constexpr int C = kMaxCandidates / kThreads;  // candidates a lane
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ logits,  // (B, K)
           const float* __restrict__ boxes,   // (B, K, 4) ymin, xmin, ymax, xmax
           int32_t* __restrict__ out_count,   // (B,)
           float* __restrict__ out_scores,    // (B, D)
           float* __restrict__ out_boxes,     // (B, D, 4)
           int k, int max_det, float iou_threshold, float score_threshold) {
  __shared__ float4 s_box[kMaxCandidates];
  __shared__ uint2 s_best[2][G];  // (max key, its candidate) per warp, by round parity

  const int lane = threadIdx.x & 31;
  const int wi = threadIdx.x >> 5;
  const int b = blockIdx.x;

  // This warp's share of the boxes, coalesced; candidates past K are pads.
  const float4* boxes_in = reinterpret_cast<const float4*>(boxes) + (int64_t)b * k;
  for (int i = lane; i < 32 * C; i += 32) {
    const int idx = wi * 32 * C + i;
    s_box[idx] = idx < k ? boxes_in[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncwarp();

  const int first = (wi * 32 + lane) * C;  // this lane's first candidate
  uint32_t key[C];
  float ymin[C], xmin[C], ymax[C], xmax[C], area[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int idx = first + j;
    const float4 bx = s_box[idx];
    ymin[j] = bx.x;
    xmin[j] = bx.y;
    ymax[j] = bx.z;
    xmax[j] = bx.w;
    area[j] = __fmul_rn(__fsub_rn(bx.z, bx.x), __fsub_rn(bx.w, bx.y));
    float score = 0.f;
    if (idx < k) score = 1.f / (1.f + expf(-logits[(int64_t)b * k + idx]));
    // A dead candidate and a live one of score 0 both count as 0 in the argmax.
    key[j] = idx < k && score >= score_threshold ? __float_as_uint(score) : 0u;
  }

  // Unfilled slots are 0, as in the Pallas kernel's zero-initialised outputs.
  float* scores_b = out_scores + (int64_t)b * max_det;
  float4* boxes_b = reinterpret_cast<float4*>(out_boxes) + (int64_t)b * max_det;
  for (int j = wi * 32 + lane; j < max_det; j += 32 * G) {
    scores_b[j] = 0.f;
    boxes_b[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // The first round's barrier orders these zeros before thread 0's results.
  // The comparison decides only for a threshold and a union in a range where
  // neither product below can overflow, underflow or lose the margin.
  const bool banded = iou_threshold >= 1e-3f && iou_threshold <= 1e3f;
  const float thr_hi = __fmul_rn(iou_threshold, 1.f + 0x1p-10f);
  const float thr_lo = __fmul_rn(iou_threshold, 1.f - 0x1p-10f);

  int count = 0;
  for (int round = 0; round < max_det; ++round) {
    // This lane's best key by a tree of maxima, then the lowest j that holds it.
    uint32_t tree[C];
#pragma unroll
    for (int j = 0; j < C; ++j) tree[j] = key[j];
#pragma unroll
    for (int s = C / 2; s > 0; s /= 2) {
#pragma unroll
      for (int j = 0; j < s; ++j) tree[j] = max(tree[j], tree[j + s]);
    }
    const uint32_t best = tree[0];
    uint32_t holders = 0;
#pragma unroll
    for (int j = 0; j < C; ++j) holders |= (key[j] == best ? 1u : 0u) << j;
    const int best_j = __ffs(holders) - 1;
    uint32_t m = __reduce_max_sync(kFullMask, best);
    const unsigned ties = __ballot_sync(kFullMask, best == m);
    int win = __shfl_sync(kFullMask, first + best_j, __ffs(ties) - 1);
    if (lane == 0) s_best[round & 1][wi] = make_uint2(m, (uint32_t)win);
    __syncthreads();
    // Warps in ascending order hold ascending candidates: a later warp wins only if larger.
#pragma unroll
    for (int w = 0; w < G; ++w) {
      const uint2 v = s_best[round & 1][w];
      if (w == 0 || v.x > m) {
        m = v.x;
        win = (int)v.y;
      }
    }
    if (m == 0u) break;  // the same for every thread of the image: later rounds find nothing too

    const float4 wb = s_box[win];
    const float w_area = __fmul_rn(__fsub_rn(wb.z, wb.x), __fsub_rn(wb.w, wb.y));
    uint32_t undecided = 0;  // candidates whose quotient may round across the threshold
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float inter_h = fmaxf(0.f, __fsub_rn(fminf(ymax[j], wb.z), fmaxf(ymin[j], wb.x)));
      const float inter_w = fmaxf(0.f, __fsub_rn(fminf(xmax[j], wb.w), fmaxf(xmin[j], wb.y)));
      const float inter = __fmul_rn(inter_h, inter_w);
      const float uni = __fsub_rn(__fadd_rn(area[j], w_area), inter);
      const bool in_range = banded && uni > 1e-12f && uni < 1e30f;
      const bool above = in_range && inter > __fmul_rn(uni, thr_hi);
      const bool below = in_range && inter < __fmul_rn(uni, thr_lo);
      if (above || first + j == win) key[j] = 0u;
      undecided |= (above || below ? 0u : 1u) << j;  // a NaN lands here too
    }
    if (__any_sync(kFullMask, undecided != 0u)) {
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if ((undecided >> j) & 1u) {
          const float inter_h = fmaxf(0.f, __fsub_rn(fminf(ymax[j], wb.z), fmaxf(ymin[j], wb.x)));
          const float inter_w = fmaxf(0.f, __fsub_rn(fminf(xmax[j], wb.w), fmaxf(xmin[j], wb.y)));
          const float inter = __fmul_rn(inter_h, inter_w);
          const float uni = __fsub_rn(__fadd_rn(area[j], w_area), inter);
          const float iou = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
          if (iou > iou_threshold) key[j] = 0u;
        }
      }
    }
    if (wi == 0 && lane == 0) {
      scores_b[round] = __uint_as_float(m);
      boxes_b[round] = wb;
    }
    ++count;
  }
  if (wi == 0 && lane == 0) out_count[b] = count;
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for arguments the kernel does
// not take, else the launch's own error.
extern "C" int vbt_nms_launch(const float* logits, const float* boxes, int32_t* out_count,
                              float* out_scores, float* out_boxes, int batch, int k,
                              int max_det, float iou_threshold, float score_threshold,
                              void* stream) {
  if (batch <= 0 || k <= 0 || k > kMaxCandidates || max_det <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  nms_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, boxes, out_count, out_scores, out_boxes, k, max_det, iou_threshold,
      score_threshold);
  return (int)cudaGetLastError();
}
