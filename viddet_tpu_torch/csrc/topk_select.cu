// K2 topk_indices: exact top-k index SET of each row, ascending indices.
//
// Replaces the Pallas kernel viddet_tpu/ops/topk_pallas.py
// `topk_indices_pallas` (`_select_kernel`).  For a row of scores >= 0
// (-1.0 marks padding) it returns the same k indices as lax.top_k,
// including its lowest-index-first choice among ties at the k-th value:
//   1. a 31-step binary search on the float32 bit patterns finds the k-th
//      largest value T (non-negative floats order like their bits as
//      integers; -1.0's pattern is negative and never counts);
//   2. the row keeps every score > T plus the first (k - count(> T)) ties
//      at T in index order;
//   3. kept indices are written in ascending order.
//
// Bound on an H100: at (32, 32000) the row bytes (4 MB in all) take about
// a microsecond at 3.35 TB/s, so the bound is latency: 31 dependent
// block-wide counts.  Design: one block of 1024 threads per row; the row is
// read once into dynamic shared memory (128 KB at N = 32000), each search
// step is a strided shared-memory count plus one warp-reduce and one
// block-reduce, and steps 2-3 walk the row in 1024-wide tiles with a ballot
// scan that carries the tie and output counts from tile to tile.
#include <climits>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kHiBits = 0x7F800000 + 1;  // exclusive bound: +inf's pattern
constexpr int kSearchIters = 31;

__global__ void __launch_bounds__(kThreads)
topk_select_kernel(const float* __restrict__ scores, int n, int k, long long* __restrict__ out) {
  extern __shared__ int bits[];  // n ints
  __shared__ int scratch[32];
  const float* row = scores + (long long)blockIdx.x * n;
  long long* orow = out + (long long)blockIdx.x * k;
  for (int i = threadIdx.x; i < n; i += blockDim.x) bits[i] = __float_as_int(row[i]);
  __syncthreads();

  // Invariant: count(bits >= lo) >= k > count(bits >= hi).
  int lo = 0, hi = kHiBits;
  for (int it = 0; it < kSearchIters; ++it) {
    const int mid = lo + (hi - lo) / 2;
    int c = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) c += bits[i] >= mid;
    if (viddet::block_sum(c, scratch) >= k) lo = mid; else hi = mid;
  }
  const int t = lo;

  int c = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) c += bits[i] > t;
  const int need = k - viddet::block_sum(c, scratch);  // ties to keep

  int ties_before = 0, written = 0;
  for (int base = 0; base < n && written < k; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int b = i < n ? bits[i] : INT_MIN;
    const bool tie = b == t;
    int tie_total, sel_total;
    const int tie_rank = ties_before + viddet::block_exclusive_count(tie, scratch, &tie_total);
    const bool sel = b > t || (tie && tie_rank < need);
    const int pos = written + viddet::block_exclusive_count(sel, scratch, &sel_total);
    if (sel) orow[pos] = i;
    ties_before += tie_total;
    written += sel_total;
  }
  // A row that breaks the precondition (fewer than k non-negative scores)
  // gets -1 in the slots it cannot fill.
  for (int p = written + threadIdx.x; p < k; p += blockDim.x) orow[p] = -1;
}

}  // namespace

extern "C" int viddet_topk_indices(const void* scores, int batch, int n, int k, void* out,
                                   void* stream) {
  const size_t smem = (size_t)n * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(topk_select_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    topk_select_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(scores), n, k, static_cast<long long*>(out));
  }
  return (int)cudaGetLastError();
}

extern "C" const char* viddet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
