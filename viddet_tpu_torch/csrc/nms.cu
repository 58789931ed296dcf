// K5 nms_keep_mask and K6 compact_and_pad: the greedy NMS tail.
//
// K5 replaces the Pallas kernel viddet_tpu/ops/nms_pallas.py
// `nms_keep_mask_pallas` (`_greedy_rows_kernel`, with the IoU matrix the
// wrapper builds at nms_pallas.py:230-248).  Over score-sorted,
// class-offset boxes: sup[i][j] = IoU(i, j) > thresh and j > i; in rank
// order keep[j] &= !(keep[i] && sup[i][j]); keep starts as `valid`.
// Bound on an H100: the 400-step serial scan, not bytes (a 400-box image
// is 6.4 KB) and not the 80k IoUs.  Design: one block per image.  The
// block computes the IoUs with the reference's exact expression (no
// multiply-add contraction: explicit round-to-nearest intrinsics, and the
// file is built with -fmad=false) into a K x ceil(K/64) word suppression
// bitmask in shared memory (22 KB at K = 400).  One warp then runs the
// scan: lane w holds keep word w in a register, and each rank costs one
// shuffle and at most one shared-memory word per lane.
//
// K6 replaces `compact_and_pad_pallas` (`_compact_kernel`): the kept rows
// move, in order, to the first post_nms slots (slot = inclusive count of
// kept rows - 1), and the rest become -1.  Bound: launch latency; the
// whole batch moves well under 1 MB.  Design: one block per image; the -1
// fill comes first, then a ballot scan over 256-wide tiles scatters the
// kept rows.
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kNmsThreads = 512;
constexpr int kCompactThreads = 256;

// IoU of boxes a and c exactly as viddet_tpu/ops/nms_pallas.py:237-247
// (and ops/boxes.py box_iou): each product and sum rounded on its own.
__device__ __forceinline__ float iou(const float* a, const float* c) {
  const float w = fmaxf(__fsub_rn(fminf(a[2], c[2]), fmaxf(a[0], c[0])), 0.0f);
  const float h = fmaxf(__fsub_rn(fminf(a[3], c[3]), fmaxf(a[1], c[1])), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float area_a = __fmul_rn(fmaxf(__fsub_rn(a[2], a[0]), 0.0f),
                                 fmaxf(__fsub_rn(a[3], a[1]), 0.0f));
  const float area_c = __fmul_rn(fmaxf(__fsub_rn(c[2], c[0]), 0.0f),
                                 fmaxf(__fsub_rn(c[3], c[1]), 0.0f));
  const float uni = fmaxf(__fsub_rn(__fadd_rn(area_a, area_c), inter), 1e-12f);
  return __fdiv_rn(inter, uni);
}

__global__ void __launch_bounds__(kNmsThreads)
nms_keep_kernel(const float* __restrict__ boxes, const bool* __restrict__ valid, int k,
                float thresh, float* __restrict__ keep_out) {
  extern __shared__ unsigned long long smem[];
  const int words = (k + 63) / 64;
  unsigned long long* sup = smem;                    // k * words
  float* bx = reinterpret_cast<float*>(sup + (size_t)k * words);  // k * 4
  const float* img = boxes + (size_t)blockIdx.x * k * 4;
  for (int i = threadIdx.x; i < 4 * k; i += blockDim.x) bx[i] = img[i];
  __syncthreads();

  for (int task = threadIdx.x; task < k * words; task += blockDim.x) {
    const int i = task / words, w = task - i * words;
    const float* a = bx + 4 * i;
    unsigned long long m = 0ull;
    const int j0 = max(w * 64, i + 1), j1 = min(w * 64 + 64, k);
    for (int j = j0; j < j1; ++j) {
      if (iou(a, bx + 4 * j) > thresh) m |= 1ull << (j - w * 64);
    }
    sup[task] = m;
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const bool* v = valid + (size_t)blockIdx.x * k;
    float* out = keep_out + (size_t)blockIdx.x * k;
    // The wrapper caps k at 1024, so words <= 16 and lane w owns word w.
    unsigned long long kw = 0ull;
    if (lane < words) {
      for (int jj = 0; jj < 64; ++jj) {
        const int j = lane * 64 + jj;
        if (j < k && v[j]) kw |= 1ull << jj;
      }
    }
    for (int i = 0; i < k; ++i) {
      const unsigned long long owner = __shfl_sync(0xffffffffu, kw, i >> 6);
      if ((owner >> (i & 63)) & 1ull) {
        if (lane < words) kw &= ~sup[(size_t)i * words + lane];
      }
    }
    if (lane < words) {
      for (int jj = 0; jj < 64; ++jj) {
        const int j = lane * 64 + jj;
        if (j < k) out[j] = ((kw >> jj) & 1ull) ? 1.0f : 0.0f;
      }
    }
  }
}

__global__ void __launch_bounds__(kCompactThreads)
compact_kernel(const float* __restrict__ keep, const float* __restrict__ scores,
               const float* __restrict__ cls, const float* __restrict__ boxes, int k, int post,
               float* __restrict__ ids, float* __restrict__ out_scores,
               float* __restrict__ out_boxes) {
  __shared__ int scratch[32];
  const size_t b = blockIdx.x;
  for (int s = threadIdx.x; s < post; s += blockDim.x) {
    ids[b * post + s] = -1.0f;
    out_scores[b * post + s] = -1.0f;
    for (int c = 0; c < 4; ++c) out_boxes[(b * post + s) * 4 + c] = -1.0f;
  }
  __syncthreads();  // the fill lands before any kept row overwrites it
  int before = 0;
  for (int base = 0; base < k && before < post; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool kept = i < k && keep[b * k + i] > 0.5f;
    int total;
    const int slot = before + viddet::block_exclusive_count(kept, scratch, &total);
    if (kept && slot < post) {
      ids[b * post + slot] = cls[b * k + i];
      out_scores[b * post + slot] = scores[b * k + i];
      for (int c = 0; c < 4; ++c) out_boxes[(b * post + slot) * 4 + c] = boxes[(b * k + i) * 4 + c];
    }
    before += total;
  }
}

}  // namespace

extern "C" int viddet_nms_keep_mask(const void* boxes, const void* valid, int batch, int k,
                                    float iou_thresh, void* keep, void* stream) {
  const int words = (k + 63) / 64;
  const size_t smem = (size_t)k * words * sizeof(unsigned long long) + (size_t)k * 4 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(nms_keep_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0 && k > 0) {
    nms_keep_kernel<<<batch, kNmsThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boxes), static_cast<const bool*>(valid), k, iou_thresh,
        static_cast<float*>(keep));
  }
  return (int)cudaGetLastError();
}

extern "C" int viddet_compact_and_pad(const void* keep, const void* scores, const void* cls,
                                      const void* boxes, int batch, int k, int post, void* ids,
                                      void* out_scores, void* out_boxes, void* stream) {
  if (batch > 0 && post > 0) {
    compact_kernel<<<batch, kCompactThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(keep), static_cast<const float*>(scores),
        static_cast<const float*>(cls), static_cast<const float*>(boxes), k, post,
        static_cast<float*>(ids), static_cast<float*>(out_scores),
        static_cast<float*>(out_boxes));
  }
  return (int)cudaGetLastError();
}
