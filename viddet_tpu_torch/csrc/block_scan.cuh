// Block-wide scans shared by the selection kernels.
//
// Every helper is called by all threads of a block (blockDim.x a multiple
// of 32, at most 1024) and synchronises the block; `scratch` is a
// __shared__ array of at least 32 ints.
#pragma once

#include <cuda_runtime.h>

namespace viddet {

// Exclusive prefix sum of `v` over the block in thread order; the block's
// total goes to *total.
__device__ __forceinline__ int block_exclusive_sum(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < nwarps; ++w) {
    const int c = scratch[w];
    before += (w < warp) ? c : 0;
    all += c;
  }
  __syncthreads();  // scratch is free again on return
  *total = all;
  return before + incl - v;
}

}  // namespace viddet
