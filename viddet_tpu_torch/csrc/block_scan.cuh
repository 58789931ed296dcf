// Block-wide reductions and scans shared by the selection kernels.
//
// Every helper is called by all threads of a block (blockDim.x a multiple
// of 32, at most 1024) and synchronises the block; `scratch` is a
// __shared__ array of at least 32 ints.
#pragma once

#include <cuda_runtime.h>

namespace viddet {

// Sum of `v` over the block, returned to every thread.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = __reduce_add_sync(0xffffffffu, v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < nwarps; ++w) total += scratch[w];
  __syncthreads();  // scratch is free again on return
  return total;
}

// Exclusive prefix count of `flag` over the block in thread order; the
// block's total count goes to *total.
__device__ __forceinline__ int block_exclusive_count(bool flag, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int in_warp = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) scratch[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < nwarps; ++w) {
    const int c = scratch[w];
    before += (w < warp) ? c : 0;
    all += c;
  }
  __syncthreads();
  *total = all;
  return before + in_warp;
}

}  // namespace viddet
