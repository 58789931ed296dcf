// K5 nms_keep_mask and K6 compact_and_pad: the greedy NMS tail.
//
// K5 replaces the Pallas kernel viddet_tpu/ops/nms_pallas.py
// `nms_keep_mask_pallas` (`_greedy_rows_kernel`, with the IoU matrix the
// wrapper builds at nms_pallas.py:230-248).  Over score-sorted,
// class-offset boxes: sup[i][j] = IoU(i, j) > thresh and j > i; in rank
// order keep[j] &= !(keep[i] && sup[i][j]); keep starts as `valid`.
// Bound on an H100: not bytes (a 1000-box image is 16 KB) and hardly
// operations (K^2 / 2 IoUs, 0.5 M an image at K = 1000), but the greedy
// scan's dependent chain, and how many SMs do the rest.  Design, two
// kernels on the stream:
//   - nms_mask_kernel: the grid covers (image, 64-row tile, 64-column
//     word) over the upper triangle only, all in grid x: about 1,100
//     blocks at batch 8 and K = 1000.  The block stages its 64 row and 64
//     column boxes (four scalar loads each: any 4-byte alignment) and
//     their areas in shared memory; each warp takes 8 rows, a lane one
//     column of each half-word, and a ballot makes 32 bits of a row's
//     word.  The 64 words go to a word-major scratch tensor in global
//     memory, (B, ceil(K/64), K) (1 MB at batch 8 and K = 1000; it stays
//     in L2), so the block's stores are contiguous.  The IoU is the
//     reference's exact expression (no multiply-add contraction: explicit
//     round-to-nearest intrinsics, and the file is built with -fmad=false);
//   - nms_scan_kernel: one block an image copies the words its scan reads
//     (the upper triangle, 68 KB at K = 1000) into shared memory with
//     cp.async, every copy in flight at once, and runs
//     viddet::greedy_scan (csrc/nms_scan.cuh): per 64-box tile, 64 serial
//     register steps on the diagonal, then one warp per later word ORs the
//     kept rows' words into it: a chain of K register steps and 2 K / 64
//     barriers, which csrc/latency_probe.cu times.
//
// K6 replaces `compact_and_pad_pallas` (`_compact_kernel`): the kept rows
// move, in order, to the first post_nms slots (slot = inclusive count of
// kept rows - 1), and the rest become -1.  Bound: bytes, and those take
// 0.13 us at batch 32 and K = 400 (under 0.5 MB), below the launch floor:
// an empty kernel's device time on an H100 is 0.87 us
// (csrc/latency_probe.cu; PERF.md), and this kernel's 1.6 us.  So what a
// design can cut is the chain inside the launch: the dependent round
// trips and barriers.  Design: one pass, one block per image of up to 1024
// threads (K rounded up to whole warps; a larger K loops over tiles,
// carrying the count).  Each thread issues all its loads at once (keep,
// score, class and the four box floats, scalar, so any 4-byte offset
// works), then one block scan (a ballot and popc within the warp, the
// warp totals through shared memory, one barrier), then the stores: a
// kept row whose slot is below post writes it (the box as one 16-byte
// store: the wrapper allocates the output), and thread s writes the -1
// fill of slot s when s is at or past the kept count.  Every output
// element is written once, and no barrier orders a fill before an
// overwrite.
#include <cuda_runtime.h>

#include "nms_scan.cuh"

namespace {

constexpr int kMaskThreads = 256;  // 8 warps, 8 rows of a 64-row tile each
constexpr int kScanThreads = 512;  // 16 warps: one per later word at K <= 1024
constexpr int kCompactMaxThreads = 1024;

// Area of a box exactly as viddet_tpu/ops/boxes.py box_area.
__device__ __forceinline__ float area(float4 a) {
  return __fmul_rn(fmaxf(__fsub_rn(a.z, a.x), 0.0f), fmaxf(__fsub_rn(a.w, a.y), 0.0f));
}

// IoU of boxes a and c exactly as viddet_tpu/ops/nms_pallas.py:237-247
// (and ops/boxes.py box_iou), given their areas: each product and sum
// rounded on its own.
__device__ __forceinline__ float iou(float4 a, float area_a, float4 c, float area_c) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)), 0.0f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float uni = fmaxf(__fsub_rn(__fadd_rn(area_a, area_c), inter), 1e-12f);
  // 0 / uni is +0 exactly (uni >= 1e-12): most pairs do not overlap, and a
  // zero dividend would take the division's slow path.
  return inter > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float* __restrict__ boxes, int k, int words, float thresh,
                unsigned long long* __restrict__ mask) {
  // blockIdx.x: the image, then a (row tile, column word >= row tile) pair.
  const int pairs = words * (words + 1) / 2;
  const size_t image = blockIdx.x / pairs;
  int q = blockIdx.x % pairs, rt = 0;
  while (q >= words - rt) {
    q -= words - rt;
    ++rt;
  }
  const int w = rt + q;
  __shared__ float4 box[2][64];  // the tile's rows, the word's columns
  __shared__ float box_area[2][64];
  __shared__ unsigned bits[64][2];
  const float* img = boxes + image * k * 4;
  if (threadIdx.x < 128) {
    const int side = threadIdx.x >> 6, x = threadIdx.x & 63;
    const int j = (side ? w : rt) * 64 + x;
    const float4 c = j < k ? make_float4(img[4 * j], img[4 * j + 1], img[4 * j + 2], img[4 * j + 3])
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    box[side][x] = c;
    box_area[side][x] = area(c);
  }
  __syncthreads();
  // Warp v takes rows 8v .. 8v + 7 of the tile; lane l the columns l and
  // 32 + l of the word: one ballot gives 32 bits of a row's word.
  const int lane = threadIdx.x & 31, v = threadIdx.x >> 5;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int jj = half * 32 + lane, j = w * 64 + jj;
    const float4 c = box[1][jj];
    const float area_c = box_area[1][jj];
#pragma unroll
    for (int r = 8 * v; r < 8 * v + 8; ++r) {
      const int i = rt * 64 + r;
      const bool sup = j > i && j < k && iou(box[0][r], box_area[0][r], c, area_c) > thresh;
      const unsigned ballot = __ballot_sync(0xffffffffu, sup);
      if (lane == 0) bits[r][half] = ballot;
    }
  }
  __syncthreads();
  const int i = rt * 64 + threadIdx.x;
  if (threadIdx.x < 64 && i < k) {
    mask[(image * words + w) * k + i] =
        (static_cast<unsigned long long>(bits[threadIdx.x][1]) << 32) | bits[threadIdx.x][0];
  }
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const unsigned long long* __restrict__ mask, const bool* __restrict__ valid,
                int k, int words, float* __restrict__ keep_out) {
  extern __shared__ unsigned long long smem[];
  const int kp = words * 64;
  unsigned long long* cols = smem;                      // words x kp, word-major
  unsigned long long* kw = smem + (size_t)words * kp;  // words keep words
  // Word w is read for the rows of tiles 0..w only: copy those, all loads
  // in flight at once.
  const unsigned long long* src = mask + (size_t)blockIdx.x * words * k;
  for (int w = 0; w < words; ++w) {
    const int rows = min(k, (w + 1) * 64);
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      cp_async8(cols + (size_t)w * kp + i, src + (size_t)w * k + i);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  const bool* v = valid + (size_t)blockIdx.x * k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int w = warp; w < words; w += kScanThreads / 32) {
    const int j = w * 64 + lane;
    const unsigned lo = __ballot_sync(0xffffffffu, j < k && v[j]);
    const unsigned hi = __ballot_sync(0xffffffffu, j + 32 < k && v[j + 32]);
    if (lane == 0) kw[w] = (static_cast<unsigned long long>(hi) << 32) | lo;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  viddet::greedy_scan(cols, kp, words, kw);
  float* out = keep_out + (size_t)blockIdx.x * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    out[j] = ((kw[j >> 6] >> (j & 63)) & 1ull) ? 1.0f : 0.0f;
  }
}

__global__ void __launch_bounds__(kCompactMaxThreads)
compact_kernel(const float* __restrict__ keep, const float* __restrict__ scores,
               const float* __restrict__ cls, const float* __restrict__ boxes, int k, int post,
               float* __restrict__ ids, float* __restrict__ out_scores,
               float4* __restrict__ out_boxes) {
  __shared__ int warp_kept[2][32];  // a tile's kept count per warp, two tiles apart
  const size_t b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  int before = 0;  // kept rows in the tiles before this one
  for (int base = 0, tile = 0; base < k && before < post; base += blockDim.x, tile ^= 1) {
    const int i = base + threadIdx.x;
    float kp = 0.0f, sc = 0.0f, cl = 0.0f, x0 = 0.0f, y0 = 0.0f, x1 = 0.0f, y1 = 0.0f;
    if (i < k) {
      const size_t e = b * k + i;
      kp = keep[e];
      sc = scores[e];
      cl = cls[e];
      x0 = boxes[e * 4];
      y0 = boxes[e * 4 + 1];
      x1 = boxes[e * 4 + 2];
      y1 = boxes[e * 4 + 3];
    }
    const bool kept = kp > 0.5f;
    const unsigned ballot = __ballot_sync(0xffffffffu, kept);
    if (lane == 0) warp_kept[tile][warp] = __popc(ballot);
    __syncthreads();
    const int n = lane < nwarps ? warp_kept[tile][lane] : 0;
    const int slot = before + __reduce_add_sync(0xffffffffu, lane < warp ? n : 0) +
                     __popc(ballot & ((1u << lane) - 1u));
    if (kept && slot < post) {
      ids[b * post + slot] = cl;
      out_scores[b * post + slot] = sc;
      out_boxes[b * post + slot] = make_float4(x0, y0, x1, y1);
    }
    before += __reduce_add_sync(0xffffffffu, n);
  }
  for (int s = before + threadIdx.x; s < post; s += blockDim.x) {
    ids[b * post + s] = -1.0f;
    out_scores[b * post + s] = -1.0f;
    out_boxes[b * post + s] = make_float4(-1.0f, -1.0f, -1.0f, -1.0f);
  }
}

}  // namespace

// mask: (batch, ceil(k/64), k) 64-bit scratch words, written then read
// here; the wrapper allocates it.
extern "C" int viddet_nms_keep_mask(const void* boxes, const void* valid, int batch, int k,
                                    float iou_thresh, void* mask, void* keep, void* stream) {
  const int words = (k + 63) / 64;
  const size_t smem = ((size_t)words * 64 * words + words) * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(nms_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0 && k > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* m = static_cast<unsigned long long*>(mask);
    nms_mask_kernel<<<batch * (words * (words + 1) / 2), kMaskThreads, 0, s>>>(
        static_cast<const float*>(boxes), k, words, iou_thresh, m);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    nms_scan_kernel<<<batch, kScanThreads, smem, s>>>(m, static_cast<const bool*>(valid), k, words,
                                                     static_cast<float*>(keep));
  }
  return (int)cudaGetLastError();
}

// out_boxes: 16-byte aligned (float4 stores).
extern "C" int viddet_compact_and_pad(const void* keep, const void* scores, const void* cls,
                                      const void* boxes, int batch, int k, int post, void* ids,
                                      void* out_scores, void* out_boxes, void* stream) {
  if (reinterpret_cast<size_t>(out_boxes) % 16) return (int)cudaErrorInvalidValue;
  if (batch > 0 && post > 0) {
    const int threads = k < 1 ? 32 : min(kCompactMaxThreads, (k + 31) / 32 * 32);
    compact_kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(keep), static_cast<const float*>(scores),
        static_cast<const float*>(cls), static_cast<const float*>(boxes), k, post,
        static_cast<float*>(ids), static_cast<float*>(out_scores),
        static_cast<float4*>(out_boxes));
  }
  return (int)cudaGetLastError();
}
