// A measurement probe, not a port kernel: the time of one dependent round
// of K5's greedy scan (csrc/nms.cu, nms_keep_kernel), so that K5's time can
// be set beside the bound its serial scan imposes (its k dependent rounds
// times this latency), which a bound from bytes and operations leaves out.
//
// One warp runs K5's scan loop `passes` times over k steps: a 64-bit
// shuffle of the keep word that owns step i, a bit test, and a masked AND
// with one shared-memory word per lane, with K5's shared layout (k rows of
// `words` words).  The keep words start all ones and the suppression words
// are zero, so every round takes the branch and each round's shuffle reads
// the word the previous round wrote.  Time two pass counts with CUDA
// events and divide the difference by the rounds between them.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 512;  // 32 KB of static shared memory
constexpr int kMaxWords = kMaxK / 64;

__global__ void scan_round_kernel(int k, int passes, unsigned long long* out) {
  __shared__ unsigned long long sup[kMaxK * kMaxWords];
  const int lane = threadIdx.x;
  const int words = (k + 63) / 64;
  // Zero, from a value the compiler cannot fold (the host keeps k <= kMaxK),
  // so the loop below keeps its loads.
  const unsigned long long zero = k > kMaxK ? ~0ull : 0ull;
  for (int i = lane; i < k * words; i += 32) sup[i] = zero;
  __syncwarp();
  unsigned long long kw = lane < words ? ~0ull : 0ull;
  for (int p = 0; p < passes; ++p) {
    for (int i = 0; i < k; ++i) {
      const unsigned long long owner = __shfl_sync(0xffffffffu, kw, i >> 6);
      if ((owner >> (i & 63)) & 1ull) {
        if (lane < words) kw &= ~sup[(size_t)i * words + lane];
      }
    }
  }
  out[lane] = kw;
}

}  // namespace

// One block of one warp; 1 <= k <= 512; out: 32 words of device memory.
extern "C" int viddet_scan_round_probe(int k, int passes, void* out, void* stream) {
  if (k < 1 || k > kMaxK || passes < 0) return (int)cudaErrorInvalidValue;
  scan_round_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      k, passes, static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}
