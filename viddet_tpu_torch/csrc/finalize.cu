// K4 finalize_candidates: map the hierarchical stage-2 winners back to
// (class id, candidate box).
//
// Replaces the Pallas kernel viddet_tpu/ops/nms_gather_pallas.py
// `finalize_candidates` (`_finalize_kernel`).  The merged array that
// stage 2 ranks is [per-winner top-(m-1) pairs (k*(m-1)) | hot rows
// (hot_j*C)], so for each of its topk winners q of image b:
//
//   q <  k*(m-1): box = q / (m-1),          class = i_m[b, box, q % (m-1)]
//   q >= k*(m-1): e = q - k*(m-1),
//                 box = hot_idx[b, e / C],   class = e % C
//   cls[b, t] = class (float32)        cand[b, t] = boxes_k[b, box]   (4 floats)
//
// The TPU kernel does these gathers as one-hot MXU matmuls and splits box
// ids into low and high halves to keep them exact in bf16; on the card
// they are integer arithmetic and direct indexed loads.
//
// Bound on an H100: bytes (the inputs are read once, 15 KB of output per
// image), and at the main path's size (B*topk = 12,800 threads) so few that
// launch latency dominates.  Design: one thread per winner.  A q outside
// [0, k*(m-1) + hot_j*C) writes NaN.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;

__global__ void finalize_kernel(const long long* __restrict__ i_m,
                                const long long* __restrict__ hot_idx,
                                const long long* __restrict__ q,
                                const float* __restrict__ boxes_k, int rows, int k, int m,
                                int c, int hot_j, int topk, float* __restrict__ cls,
                                float* __restrict__ cand) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int b = r / topk;
  const long long width = (long long)k * (m - 1);
  const long long v = q[r];
  long long box = -1;
  long long cl = 0;
  if (v >= 0 && v < width) {
    box = v / (m - 1);
    cl = i_m[((long long)b * k + box) * m + v % (m - 1)];
  } else if (v >= width && v < width + (long long)hot_j * c) {
    const long long e = v - width;
    box = hot_idx[(long long)b * hot_j + e / c];
    cl = e % c;
  }
  float4 out = make_float4(NAN, NAN, NAN, NAN);
  if (box >= 0 && box < k) {
    out = reinterpret_cast<const float4*>(boxes_k)[(long long)b * k + box];
    cls[r] = (float)cl;
  } else {
    cls[r] = NAN;
  }
  reinterpret_cast<float4*>(cand)[r] = out;
}

}  // namespace

// i_m (B, k, m) int64, hot_idx (B, 1, hot_j) int64, q (B, topk) int64,
// boxes_k (B, k, 4) float32 -> cls (B, topk) float32, cand (B, topk, 4).
extern "C" int viddet_finalize_candidates(const void* i_m, const void* hot_idx, const void* q,
                                          const void* boxes_k, int batch, int k, int m, int c,
                                          int hot_j, int topk, void* cls, void* cand,
                                          void* stream) {
  if (m < 2 || c < 1 || hot_j < 0 || k < 1 || topk < 0) return (int)cudaErrorInvalidValue;
  const int rows = batch * topk;
  if (rows > 0) {
    finalize_kernel<<<(rows + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(i_m), static_cast<const long long*>(hot_idx),
        static_cast<const long long*>(q), static_cast<const float*>(boxes_k), rows, k, m, c,
        hot_j, topk, static_cast<float*>(cls), static_cast<float*>(cand));
  }
  return (int)cudaGetLastError();
}
