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
// Bound on an H100: bytes in principle (0.67 MB at batch 32, 0.2 us), in
// practice latency: a candidate winner's class id depends on its q, so a
// winner takes two dependent L2 round trips after the launch (a thread
// that looked up each input in turn would take three for a winner from
// the hot rows: q, its hot id, its box).  Design: a block per image, a
// thread per winner (at most 1024 a block): each thread loads its
// q, the block stages the image's boxes (16-byte cp.async) and hot ids in
// shared memory while those loads are in flight, a candidate winner loads
// its class id from i_m, and every box comes from shared memory; cls and
// cand are written coalesced, cand as float4.  Staging i_m too (28.8 KB an
// image through one SM), blocks of 128 winners, and a thread-block cluster
// per image sharing the staged rows through distributed shared memory all
// measured slower (PERF.md).  A q outside [0, k*(m-1) + hot_j*C), or a hot
// id outside [0, k), writes NaN.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

// Block x resolves winners [s * blockDim.x, (s + 1) * blockDim.x) of image
// b = x / slices, s = x % slices, one a thread.  See the header.
__global__ void __launch_bounds__(kMaxThreads)
finalize_kernel(const long long* __restrict__ i_m, const long long* __restrict__ hot_idx,
                const long long* __restrict__ q, const float* __restrict__ boxes_k, int k, int m,
                int c, int hot_j, int topk, int slices, float* __restrict__ cls,
                float* __restrict__ cand) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sbox = reinterpret_cast<float4*>(smem);           // the image's k boxes
  long long* shot = reinterpret_cast<long long*>(sbox + k);  // its hot_j winner ids
  const long long b = blockIdx.x / slices;
  const int r = (int)(blockIdx.x - b * slices) * blockDim.x + threadIdx.x;
  const int width = k * (m - 1);
  // The winner's q, then the image's boxes and hot ids staged while it is
  // in flight, then (a candidate winner) its class id straight from i_m.
  const long long v = r < topk ? q[b * topk + r] : -1;
  const float4* gbox = reinterpret_cast<const float4*>(boxes_k) + b * k;
  for (int i = threadIdx.x; i < k; i += blockDim.x) cp_async16(sbox + i, gbox + i);
  for (int i = threadIdx.x; i < hot_j; i += blockDim.x) {
    cp_async8(shot + i, hot_idx + b * hot_j + i);
  }
  int box = -1;
  long long cl = 0;
  if (v >= 0 && v < width) {
    box = (int)v / (m - 1);
    cl = i_m[(b * k + box) * m + (int)v % (m - 1)];
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (r >= topk) return;
  if (v >= width && v < width + (long long)hot_j * c) {
    const int e = (int)(v - width);
    const long long h = shot[e / c];
    box = h >= 0 && h < k ? (int)h : -1;
    cl = e % c;
  }
  float4 out = make_float4(NAN, NAN, NAN, NAN);
  float cv = NAN;
  if (box >= 0) {
    out = sbox[box];
    cv = (float)cl;
  }
  cls[b * topk + r] = cv;
  reinterpret_cast<float4*>(cand)[b * topk + r] = out;
}

}  // namespace

// i_m (B, k, m) int64, hot_idx (B, 1, hot_j) int64, q (B, topk) int64,
// boxes_k (B, k, 4) float32, 16-byte aligned -> cls (B, topk) float32,
// cand (B, topk, 4), 16-byte aligned.  A block stages k * 16 + hot_j * 8
// bytes, at most the 227 KB a block can have.
extern "C" int viddet_finalize_candidates(const void* i_m, const void* hot_idx, const void* q,
                                          const void* boxes_k, int batch, int k, int m, int c,
                                          int hot_j, int topk, void* cls, void* cand,
                                          void* stream) {
  const size_t smem = (size_t)k * 16 + (size_t)hot_j * 8;
  if (m < 2 || c < 1 || hot_j < 0 || k < 1 || topk < 0 || smem > 232448 ||
      (reinterpret_cast<uintptr_t>(boxes_k) | reinterpret_cast<uintptr_t>(cand)) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(finalize_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0 && topk > 0) {
    const int threads = min(kMaxThreads, (topk + 31) / 32 * 32);
    const int slices = (topk + threads - 1) / threads;
    finalize_kernel<<<(unsigned)batch * slices, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(i_m), static_cast<const long long*>(hot_idx),
        static_cast<const long long*>(q), static_cast<const float*>(boxes_k), k, m, c, hot_j,
        topk, slices, static_cast<float*>(cls), static_cast<float*>(cand));
  }
  return (int)cudaGetLastError();
}
