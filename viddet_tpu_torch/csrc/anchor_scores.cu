// K1 anchor_scores: stage-1 anchor scores of the YOLO detection tail.
//
// Replaces the Pallas kernel viddet_tpu/ops/nms_gather_pallas.py
// `anchor_scores` (`_score_kernel`): for every cell and anchor of every
// scale, score = sigmoid(obj_a) * sigmoid(max_c cls_a), read from the
// per-scale cell-layout head tensors (B, h*w, na*(5+C)) and written as
// one (B, N) float32 row in (scale, cell, anchor) order, deepest scale
// first.  The max runs in the raw dtype (exact; the upcast follows).
//
// Bound on an H100: bytes.  Each anchor reads 1 + C raw values (81 bf16
// lanes at COCO width) and writes one float; there are a handful of
// flops per byte.  Design: one thread per (image, cell, anchor), so a
// warp reads 32 neighbouring anchor rows, which are contiguous in memory;
// the row's lanes stream through L1.  The sigmoid is PyTorch's own CUDA
// formula, 1 / (1 + expf(-x)) in float32, so the kernel can equal the
// plain PyTorch version bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxScales = 3;

struct ScaleTable {
  const void* raw[kMaxScales];
  int cells[kMaxScales];
  int start[kMaxScales + 1];  // first flat anchor index of each scale
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float sigmoidf_torch(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename T>
__global__ void anchor_scores_kernel(ScaleTable t, int nscales, int batch, int na,
                                     int num_pred, float* __restrict__ out) {
  const int n = t.start[nscales];
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)batch * n) return;
  const int b = (int)(gid / n);
  const int j = (int)(gid - (long long)b * n);
  int s = 0;
  while (s + 1 < nscales && j >= t.start[s + 1]) ++s;
  const int local = j - t.start[s];
  const int cell = local / na;
  const int a = local - cell * na;
  const T* row = static_cast<const T*>(t.raw[s]) +
                 ((long long)b * t.cells[s] + cell) * (long long)(na * num_pred) +
                 (long long)a * num_pred;
  T m = row[5];
  for (int c = 6; c < num_pred; ++c) {
    const T v = row[c];
    // NaN propagates, as in the reference's max.
    if (to_float(v) > to_float(m) || to_float(v) != to_float(v)) m = v;
  }
  out[gid] = sigmoidf_torch(to_float(row[4])) * sigmoidf_torch(to_float(m));
}

}  // namespace

extern "C" int viddet_anchor_scores(const void* raw0, const void* raw1, const void* raw2,
                                    int cells0, int cells1, int cells2, int nscales,
                                    int batch, int na, int num_pred, int is_bf16,
                                    void* out, void* stream) {
  ScaleTable t;
  const void* raws[kMaxScales] = {raw0, raw1, raw2};
  const int cells[kMaxScales] = {cells0, cells1, cells2};
  t.start[0] = 0;
  for (int s = 0; s < kMaxScales; ++s) {
    t.raw[s] = raws[s];
    t.cells[s] = cells[s];
    t.start[s + 1] = t.start[s] + (s < nscales ? cells[s] * na : 0);
  }
  const long long total = (long long)batch * t.start[nscales];
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (blocks > 0) {
    if (is_bf16) {
      anchor_scores_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(t, nscales, batch, na, num_pred, o);
    } else {
      anchor_scores_kernel<float><<<blocks, threads, 0, st>>>(t, nscales, batch, na, num_pred, o);
    }
  }
  return (int)cudaGetLastError();
}
