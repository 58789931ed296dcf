// Measurement probes, not port kernels.
//
// The launch floor: an empty kernel launched through the same C interface
// as the port's kernels, at a given grid, block size and dynamic shared
// memory.  At one block of one warp its device time is the least that any
// launch shows on the card; at a kernel's own grid it is what that grid
// costs before the kernel does any work.  Given a source and destination,
// each thread instead copies one 4-byte word from device memory to device
// memory: the least a kernel of that grid takes that loads a value and
// stores what depends on it (one global round trip, then the store).
// They are the yardsticks beside the bound for the kernels whose work
// takes less than a launch (K4, K6, K3's extract_m=0 form).
//
// The scan round: the time of one tile round of K5's greedy scan
// (viddet::greedy_scan in csrc/nms_scan.cuh, which csrc/nms.cu's
// nms_scan_kernel runs), so that K5's time can be set beside
// the bound its dependent chain imposes (ceil(k/64) tile rounds times this
// latency), which a bound from bytes and operations leaves out.
//
// One block of K5's scan width runs greedy_scan `passes` times over k boxes
// with K5's shared layout.  Every box is kept and the suppression words are
// zero, so each of the 64 diagonal steps of a tile takes its branch and
// every warp of the OR step loads both of its rows: the longest chain.
// Time two pass counts with CUDA events and divide the difference by the
// tile rounds between them.
#include <cuda_runtime.h>

#include "nms_scan.cuh"

namespace {

constexpr int kThreads = 512;  // as nms_scan_kernel

__global__ void __launch_bounds__(kThreads)
scan_tile_probe_kernel(int k, int passes, unsigned long long* out) {
  extern __shared__ unsigned long long smem[];
  const int words = (k + 63) / 64, kp = words * 64;
  unsigned long long* cols = smem;
  unsigned long long* kw = smem + (size_t)words * kp;
  // Zero, from a value the compiler cannot fold (the host keeps k >= 1),
  // so the scan keeps its loads.
  const unsigned long long zero = k < 1 ? ~0ull : 0ull;
  for (int i = threadIdx.x; i < words * kp; i += blockDim.x) cols[i] = zero;
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    const int left = k - 64 * w;
    kw[w] = left >= 64 ? ~0ull : (1ull << left) - 1ull;
  }
  __syncthreads();
  for (int p = 0; p < passes; ++p) viddet::greedy_scan(cols, kp, words, kw);
  for (int w = threadIdx.x; w < words; w += blockDim.x) out[w] = kw[w];
}

__global__ void launch_floor_kernel() {}

__global__ void round_trip_kernel(const unsigned* __restrict__ src, unsigned* __restrict__ dst) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  dst[i] = src[i];
}

}  // namespace

// blocks >= 1, 1 <= threads <= 1024; smem: dynamic shared bytes a block;
// src, dst: nullptr (the empty kernel), or blocks * threads words each.
extern "C" int viddet_launch_floor_probe(int blocks, int threads, int smem, const void* src,
                                         void* dst, void* stream) {
  if (blocks < 1 || threads < 1 || threads > 1024 || smem < 0 ||
      (src == nullptr) != (dst == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (src == nullptr) {
    cudaError_t err = cudaFuncSetAttribute(launch_floor_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    launch_floor_kernel<<<blocks, threads, smem, st>>>();
  } else {
    cudaError_t err = cudaFuncSetAttribute(round_trip_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    round_trip_kernel<<<blocks, threads, smem, st>>>(static_cast<const unsigned*>(src),
                                                     static_cast<unsigned*>(dst));
  }
  return (int)cudaGetLastError();
}

// One block; 1 <= k <= 1024; out: ceil(k/64) words of device memory.
extern "C" int viddet_scan_round_probe(int k, int passes, void* out, void* stream) {
  if (k < 1 || k > 1024 || passes < 0) return (int)cudaErrorInvalidValue;
  const int words = (k + 63) / 64;
  const size_t smem = ((size_t)words * 64 * words + words) * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(scan_tile_probe_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  scan_tile_probe_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      k, passes, static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}
