// K2 topk_indices: exact top-k index SET of each row, ascending indices.
//
// Replaces the Pallas kernel viddet_tpu/ops/topk_pallas.py
// `topk_indices_pallas` (`_select_kernel`).  For a row of scores >= 0
// (-1.0 marks padding) it returns the same k indices as lax.top_k,
// including its lowest-index-first choice among ties at the k-th value:
//   1. find the k-th largest value T (non-negative floats order like their
//      bit patterns as integers; a negative pattern, -1.0 or -0.0, is
//      below every valid score and is never kept);
//   2. keep every score > T plus the first (k - count(> T)) ties at T in
//      index order;
//   3. write the kept indices in ascending order.
//
// Bound on an H100: a row is at most 224 KB and the whole batch a few MB,
// a few microseconds at 3.35 TB/s, so the bound is latency: the chain of
// dependent row-wide counts that finds T, and how many SMs share a row.
// Design:
//   - a radix select on the bit patterns: 4 passes of 8-bit digits (bit 31
//     is 0 for every key), so 4 dependent row-wide rounds.  A pass histograms
//     the digit of the keys that match the digits chosen so far, one
//     sub-histogram per warp with warp-aggregated shared atomics
//     (__match_any_sync), so the few bins of a probability row do not
//     serialise; a suffix scan over the 256 bins picks the k-th value's
//     digit;
//   - a thread-block cluster per row (the wrapper picks its size, at most
//     8, so that batch x size fills the SMs).  Block r holds the r-th
//     contiguous slice of the row in shared memory; each pass merges the
//     blocks' histograms through distributed shared memory
//     (map_shared_rank) between two cluster barriers;
//   - the final pass counts, per thread, the scores > T and the ties in a
//     contiguous chunk; a block scan and one exchange of the blocks' counts
//     across the cluster give each thread the ties and the kept scores of
//     everything before it, so it knows which ties it keeps and where its
//     indices go.  Slices and chunks follow index order, so the output is
//     ascending without a sort.
// Keys are clamped to [0, +inf's pattern] for the histograms: the plain
// version's bisection never looks past +inf, and a negative pattern counts
// as 0 there, which changes T only for a row that breaks the precondition,
// where T is 0 either way.  The selection compares the raw patterns.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kPasses = 4;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr unsigned kInfBits = 0x7F800000u;
static_assert(kThreads == kBins, "thread t owns bin t in the merge and the suffix scan");

__device__ __forceinline__ unsigned radix_key(int bits) {
  return bits < 0 ? 0u : min(static_cast<unsigned>(bits), kInfBits);
}

__global__ void __launch_bounds__(kThreads)
topk_radix_select_kernel(const float* __restrict__ scores, int n, int k, int slice,
                         long long* __restrict__ out) {
  extern __shared__ int bits[];            // this block's slice of the row
  __shared__ unsigned sub[kWarps][kBins];  // per-warp histograms of one pass
  __shared__ unsigned hist[2][kBins];      // the block's histogram, by pass parity
  __shared__ int counts[2];                // the block's (> T, == T) counts
  __shared__ int row_counts[4];            // before this block: >, ==; whole row: >, ==
  __shared__ unsigned pick[2];             // the chosen digit, the rank left
  __shared__ int scratch[32];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int row = blockIdx.x / csize;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int begin = min(n, rank * slice);
  const int len = min(n, begin + slice) - begin;
  const float* src = scores + static_cast<long long>(row) * n + begin;
  for (int i = tid; i < len; i += kThreads) bits[i] = __float_as_int(src[i]);

  // Digits of T from the top: pass p takes bits [24 - 8p, 32 - 8p).
  unsigned hi_mask = 0u, hi_val = 0u;
  int rank_left = k;  // T is the rank_left-th largest key matching hi_val
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 24 - 8 * pass;
    for (int i = tid; i < kWarps * kBins; i += kThreads) (&sub[0][0])[i] = 0u;
    __syncthreads();
    for (int base = 0; base < len; base += kThreads) {  // the same trip count in every warp
      const int i = base + tid;
      unsigned digit = kBins;  // no bin
      if (i < len) {
        const unsigned u = radix_key(bits[i]);
        if ((u & hi_mask) == hi_val) digit = (u >> shift) & 0xFFu;
      }
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (digit < kBins && lane == __ffs(peers) - 1) atomicAdd(&sub[warp][digit], __popc(peers));
    }
    __syncthreads();
    unsigned h = 0u;
    for (int w = 0; w < kWarps; ++w) h += sub[w][tid];
    hist[pass & 1][tid] = h;
    cluster.sync();
    // Thread t takes bin 255 - t, so that an exclusive scan in thread order
    // counts the keys in the bins above it.
    const int bin = kBins - 1 - tid;
    int cnt = 0;
    for (int r = 0; r < csize; ++r) cnt += cluster.map_shared_rank(&hist[pass & 1][0], r)[bin];
    int total;
    const int above = viddet::block_exclusive_sum(cnt, scratch, &total);
    if (above < rank_left && rank_left <= above + cnt) {
      pick[0] = static_cast<unsigned>(bin);
      pick[1] = static_cast<unsigned>(rank_left - above);
    }
    __syncthreads();
    hi_mask |= 0xFFu << shift;
    hi_val |= pick[0] << shift;
    rank_left = static_cast<int>(pick[1]);
  }
  const int t = static_cast<int>(hi_val);

  // Thread chunks of odd length (no shared-memory bank conflicts), in index order.
  const int e = ((len + kThreads - 1) / kThreads) | 1;
  const int c0 = min(len, tid * e), c1 = min(len, c0 + e);
  int gt = 0, tie = 0;
  for (int i = c0; i < c1; ++i) {
    gt += bits[i] > t;
    tie += bits[i] == t;
  }
  int gt_block, tie_block;
  const int gt_before = viddet::block_exclusive_sum(gt, scratch, &gt_block);
  const int tie_before = viddet::block_exclusive_sum(tie, scratch, &tie_block);
  if (tid == 0) {
    counts[0] = gt_block;
    counts[1] = tie_block;
  }
  cluster.sync();
  if (warp == 0) {
    int g = 0, q = 0;
    if (lane < csize) {
      const int* c = cluster.map_shared_rank(counts, lane);
      g = c[0];
      q = c[1];
    }
    const int gb = __reduce_add_sync(0xffffffffu, lane < rank ? g : 0);
    const int qb = __reduce_add_sync(0xffffffffu, lane < rank ? q : 0);
    const int ga = __reduce_add_sync(0xffffffffu, g);
    const int qa = __reduce_add_sync(0xffffffffu, q);
    if (lane == 0) {
      row_counts[0] = gb;
      row_counts[1] = qb;
      row_counts[2] = ga;
      row_counts[3] = qa;
    }
  }
  cluster.sync();  // row_counts is visible; no block leaves while another reads its counts

  const int need = max(0, k - row_counts[2]);  // ties the row keeps
  int ties = row_counts[1] + tie_before;
  int pos = row_counts[0] + gt_before + min(ties, need);
  long long* orow = out + static_cast<long long>(row) * k;
  for (int i = c0; i < c1; ++i) {
    const int b = bits[i];
    const bool sel = b > t || (b == t && ties < need);
    ties += b == t;
    if (sel) {
      if (pos < k) orow[pos] = begin + i;
      ++pos;
    }
  }
  // A row that breaks the precondition (fewer than k non-negative scores)
  // gets -1 in the slots it cannot fill.
  const int filled = min(k, row_counts[2] + min(row_counts[3], need));
  for (int p = filled + rank * kThreads + tid; p < k; p += csize * kThreads) orow[p] = -1;
}

}  // namespace

// One cluster of `cluster` blocks per row (1 <= cluster <= 8); block r
// holds scores [r * slice, (r + 1) * slice) of its row, slice = ceil(n /
// cluster), in dynamic shared memory.
extern "C" int viddet_topk_indices(const void* scores, int batch, int n, int k, int cluster,
                                   void* out, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  const int slice = (n + cluster - 1) / cluster;
  const size_t smem = static_cast<size_t>(slice) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(topk_radix_select_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch > 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(batch * cluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, topk_radix_select_kernel, static_cast<const float*>(scores),
                             n, k, slice, static_cast<long long*>(out));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* viddet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
