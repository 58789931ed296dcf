// The greedy scan of K5 (csrc/nms.cu, nms_scan_kernel), shared with the
// probe that times its dependent chain (csrc/latency_probe.cu).
#pragma once

#include <cuda_runtime.h>

namespace viddet {

// Greedy NMS over a suppression bitmask in shared memory, by 64-box tiles.
//
// `cols` is word-major: cols[w * kp + i] holds bit (j - 64 w) set iff row i
// suppresses box j (IoU above the threshold and j > i), for the words
// w >= i / 64 that the scan reads; kp is a multiple of 64 and at least the
// box count.  `kw` holds `words` keep words, initially the valid boxes (0
// past the last box).  Tile t in order: one thread resolves the tile's
// 64 x 64 diagonal block serially in a register (a kept box i drops the
// later boxes of its tile that it suppresses); then one warp per later word
// ORs the suppression words of the tile's kept rows and clears them from
// that keep word.  The chain is 64 register steps and two barriers a tile.
// Called by every thread of the block (blockDim.x a multiple of 32).
__device__ __forceinline__ void greedy_scan(const unsigned long long* cols, int kp, int words,
                                            unsigned long long* kw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int t = 0; t < words; ++t) {
    if (threadIdx.x == 0) {
      const unsigned long long* diag = cols + (size_t)t * kp + t * 64;
      unsigned long long cur = kw[t];
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const unsigned long long d = diag[i];  // independent of cur: loads run ahead
        if ((cur >> i) & 1ull) cur &= ~d;
      }
      kw[t] = cur;
    }
    __syncthreads();
    const unsigned long long kept = kw[t];
    for (int w = t + 1 + warp; w < words; w += nwarps) {
      const unsigned long long* col = cols + (size_t)w * kp + t * 64;
      unsigned long long m = 0ull;
      if ((kept >> lane) & 1ull) m |= col[lane];
      if ((kept >> (lane + 32)) & 1ull) m |= col[lane + 32];
      const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(m));
      const unsigned hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(m >> 32));
      if (lane == 0) kw[w] &= ~((static_cast<unsigned long long>(hi) << 32) | lo);
    }
    __syncthreads();
  }
}

}  // namespace viddet
