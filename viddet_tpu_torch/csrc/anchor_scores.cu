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
// flops per byte.  A thread that walks its own anchor row in global
// memory makes every load instruction of a warp touch 32 rows 170 bytes
// apart, 2 bytes each: the loads are bound by L1 wavefronts, not bytes.
// Design: a block owns a contiguous span of anchor rows of one scale (up
// to kThreads rows, across cells and images, since a scale's rows are one
// contiguous array) and copies it into shared memory with 16-byte
// cp.async, neighbouring threads on neighbouring addresses.  The span may
// start at any element offset (a contiguous tensor may carry a storage
// offset), so its ragged head and tail, before the first and after the
// last 16-byte boundary, are copied element by element; the span sits in
// shared memory at the same offset modulo 16 as in device memory.  Then
// each thread takes one anchor's class max from shared memory (a row
// stride of 85 halfwords or words is odd: no bank conflicts) and writes
// its score.  A row too long for the staging buffer is read from device
// memory directly.  The sigmoid is PyTorch's own CUDA formula,
// 1 / (1 + expf(-x)) in float32, and the max is order-free, so the kernel
// equals the plain PyTorch version bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxScales = 3;
constexpr int kThreads = 128;            // anchors a block owns, at most
constexpr int kMaxStageBytes = 48 * 1024 - 16;  // dynamic shared memory without opting in

struct ScaleTable {
  const void* raw[kMaxScales];
  int cells[kMaxScales];
  int start[kMaxScales + 1];        // first flat anchor index of each scale in a row of out
  int first_block[kMaxScales + 1];  // first block of each scale
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float sigmoidf_torch(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
anchor_scores_kernel(ScaleTable t, int nscales, int batch, int na, int num_pred, int per_block,
                     int staged, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char stage[];
  int s = 0;
  while (s + 1 < nscales && (int)blockIdx.x >= t.first_block[s + 1]) ++s;
  const long long per_image = (long long)t.cells[s] * na;
  const long long rows = per_image * batch;
  const long long a0 = (long long)(blockIdx.x - t.first_block[s]) * per_block;
  const int n = (int)min((long long)per_block, rows - a0);
  const T* span = static_cast<const T*>(t.raw[s]) + a0 * num_pred;

  const T* src = span;
  if (staged) {
    // Byte range [g, g + len) of device memory lands at [head, head + len)
    // of the buffer, head = g mod 16, so 16-byte chunks stay aligned on both sides.
    const uintptr_t g = reinterpret_cast<uintptr_t>(span);
    const int len = n * num_pred * (int)sizeof(T);
    const int head = (int)(g & 15);
    const int body0 = min((16 - head) & 15, len);     // bytes before the first boundary
    const int chunks = (len - body0) >> 4;
    const int tail0 = body0 + (chunks << 4);
    unsigned char* dst = stage + head;
    const unsigned char* gsrc = reinterpret_cast<const unsigned char*>(span);
    for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
      cp_async16(dst + body0 + 16 * i, gsrc + body0 + 16 * i);
    }
    const int e = (int)sizeof(T);
    for (int i = threadIdx.x; i < body0 / e; i += blockDim.x) {
      reinterpret_cast<T*>(dst)[i] = span[i];
    }
    for (int i = threadIdx.x; i < (len - tail0) / e; i += blockDim.x) {
      reinterpret_cast<T*>(dst + tail0)[i] = span[tail0 / e + i];
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    src = reinterpret_cast<const T*>(dst);
  }

  const int j = threadIdx.x;
  if (j >= n) return;
  const T* row = src + (long long)j * num_pred;
  T m = row[5];
  for (int c = 6; c < num_pred; ++c) {
    const T v = row[c];
    // NaN propagates, as in the reference's max.
    if (to_float(v) > to_float(m) || to_float(v) != to_float(v)) m = v;
  }
  const long long q = a0 + j;  // anchor index within the scale
  const long long b = q / per_image;
  out[b * t.start[nscales] + t.start[s] + (q - b * per_image)] =
      sigmoidf_torch(to_float(row[4])) * sigmoidf_torch(to_float(m));
}

}  // namespace

extern "C" int viddet_anchor_scores(const void* raw0, const void* raw1, const void* raw2,
                                    int cells0, int cells1, int cells2, int nscales,
                                    int batch, int na, int num_pred, int is_bf16,
                                    void* out, void* stream) {
  if (nscales < 1 || nscales > kMaxScales) return (int)cudaErrorInvalidValue;
  const int elem = is_bf16 ? 2 : 4;
  const int row_bytes = num_pred * elem;
  const int staged = row_bytes <= kMaxStageBytes;
  const int per_block = staged ? min(kThreads, kMaxStageBytes / row_bytes) : kThreads;
  ScaleTable t;
  const void* raws[kMaxScales] = {raw0, raw1, raw2};
  const int cells[kMaxScales] = {cells0, cells1, cells2};
  t.start[0] = 0;
  t.first_block[0] = 0;
  for (int s = 0; s < kMaxScales; ++s) {
    const long long rows = s < nscales ? (long long)cells[s] * na : 0;
    t.raw[s] = raws[s];
    t.cells[s] = cells[s];
    t.start[s + 1] = t.start[s] + (int)rows;
    t.first_block[s + 1] = t.first_block[s] + (int)((rows * batch + per_block - 1) / per_block);
  }
  // Every block of a scale owns per_block consecutive rows of the scale's
  // whole batch.
  const unsigned blocks = (unsigned)t.first_block[nscales];
  const size_t smem = staged ? (size_t)per_block * row_bytes + 16 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (blocks > 0) {
    if (is_bf16) {
      anchor_scores_kernel<__nv_bfloat16><<<blocks, kThreads, smem, st>>>(
          t, nscales, batch, na, num_pred, per_block, staged, o);
    } else {
      anchor_scores_kernel<float><<<blocks, kThreads, smem, st>>>(
          t, nscales, batch, na, num_pred, per_block, staged, o);
    }
  }
  return (int)cudaGetLastError();
}
