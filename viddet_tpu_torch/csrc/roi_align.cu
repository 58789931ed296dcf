// K7 multilevel_roi_align: FPN ROIAlign of the Faster R-CNN box head.
//
// Replaces the Pallas kernel viddet_tpu/ops/roi_align_pallas.py
// `multilevel_roi_align_pallas` (`_kernel`).  It computes the JAX
// package's oracle, viddet_tpu/ops/roi_align.py
// `multilevel_roi_align_packed`, which viddet_tpu_torch/ops/roi_align.py
// repeats in plain PyTorch: for every roi (image b, level l given by the
// wrapper), on its level's (H, W, C) map, the 14 x 14 sample lattice
//
//   coord_i = roi_lo * (1/stride) + ((i + 0.5) / 2) * (max(extent, 1e-3) / 7)
//
// per axis, each sample bilinear over its four neighbouring cells (zero
// outside (-1, H) x (-1, W), clamped to the map inside), and each of the
// 7 x 7 bins the mean of its 2 x 2 samples, written (7, 7, C) float32.
//
// The TPU kernel DMAs a 48 x 56-cell window of the roi into VMEM and
// contracts it with two separable weight matrices on the MXU; rois wider
// than the window lose their outer samples there.  Here there is no
// window, so the kernel is exact for any roi.
//
// Bound on an H100: bytes.  At the Faster R-CNN path's full width (batch
// 8, 300 rois, C = 256) the (8, 300, 7, 7, 256) float32 output is 120.4 MB
// and the bf16 P2..P5 pyramid 89.1 MB: 36 us for the output alone, 63 us
// with the whole pyramid read once, at 3.35 TB/s.  The arithmetic, about
// 1.1 GFLOP, takes 16 us on the CUDA cores at their peak, but it is exact
// (-fmad=false: every product and sum its own instruction) and each tap's
// bf16 values need converting, so some 48 instructions per channel and
// bin are unavoidable: about 45 M warp instructions at the path's shape,
// 43 us if every SM issued four a cycle.  So in practice instruction
// issue bounds the kernel, and instructions, not bytes, are what a design
// has to save.
// Design: one block per (roi, 512-byte channel slice: 256 bf16 or 128
// float32 channels, the last slice ragged), a warp per bin row, a lane per
// 16 bytes of channels, so a tap is one coalesced 512-byte row read as
// one 16-byte load a lane, and the per-sample work (cell offsets, weights,
// validity) is shared by 8 bf16 channels.  The first 28 threads compute
// the 14 row and 14 column samples (cell offsets, fractions, validity)
// into shared memory; after one barrier each warp walks its 7 bins, issuing
// a sample row's 8 tap loads together (clamped cells, so every load is in
// the map; an invalid sample's value is then 0) before its arithmetic.
// Registers are capped so that 4 blocks (28 warps) share an SM: on the
// path's shape on an H100 that was faster than all 16 taps of a bin in
// flight at the 2 blocks an SM their registers allow.  Taps
// that neighbouring samples and bins share hit L1: a roi reads about a
// third as many distinct cells as it has taps.  Where a cell's slice is not
// 16-byte aligned (C = 258 in bf16: cells 516 bytes apart; a level at a
// 4-byte offset) a lane reads 4 bytes at a time.  Every rounding is an _rn
// intrinsic and the file is built with -fmad=false, in the plain version's
// order (taps left to right, samples row by row, then / 4), so the kernel
// equals the plain version bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kP = 7;                  // bins per side
constexpr int kS = 2;                  // samples per bin side
constexpr int kN = kP * kS;            // samples per roi side
constexpr int kLaneBytes = 16;         // channels of a lane in a cell
constexpr int kSliceBytes = 32 * kLaneBytes;
constexpr int kThreads = kP * 32;      // a warp per bin row
constexpr int kBlocksPerSM = 4;        // 72 registers a thread: 28 warps an SM

struct Levels {
  const void* feat[kMaxLevels];  // (B, H, W, C) each
  int h[kMaxLevels];
  int w[kMaxLevels];
  float stride[kMaxLevels];
};

// A lane's 16 bytes of one cell: one load where aligned, else 4-byte words
// (up to the lane's `bytes`, the rest 0).
__device__ __forceinline__ uint4 load_lane(const unsigned char* p, bool vec, int bytes) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned* q = reinterpret_cast<const unsigned*>(p);
  return make_uint4(__ldg(q), bytes > 4 ? __ldg(q + 1) : 0u, bytes > 8 ? __ldg(q + 2) : 0u,
                    bytes > 12 ? __ldg(q + 3) : 0u);
}

// The lane's channel values of a cell, as float32.
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {  // 8 bf16
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {  // 4 float32
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
roi_align_kernel(Levels lv, const float* __restrict__ rois, const int* __restrict__ levels,
                 int rois_per_image, int c, int slices, float* __restrict__ out) {
  constexpr int kCh = kLaneBytes / (int)sizeof(T);  // channels of a lane
  __shared__ int row0[kN], row1[kN], col0[kN], col1[kN];  // byte offsets of cells
  __shared__ float frac_y[kN], frac_x[kN];
  __shared__ bool valid_y[kN], valid_x[kN];

  const int roi = blockIdx.x / slices;
  const int ch0 = (blockIdx.x - roi * slices) * (kSliceBytes / (int)sizeof(T));
  const int b = roi / rois_per_image;
  const int l = levels[roi];
  const int h = lv.h[l], w = lv.w[l];
  const int cell_bytes = c * (int)sizeof(T);

  if (threadIdx.x < 2 * kN) {
    const bool is_y = threadIdx.x < kN;
    const int i = is_y ? threadIdx.x : threadIdx.x - kN;
    const float scale = __fdiv_rn(1.0f, lv.stride[l]);
    const float* box = rois + (size_t)roi * 4;
    const float lo = __fmul_rn(box[is_y ? 1 : 0], scale);
    const float hi = __fmul_rn(box[is_y ? 3 : 2], scale);
    const float bin = __fdiv_rn(fmaxf(__fsub_rn(hi, lo), 1e-3f), (float)kP);
    const float g = __fdiv_rn(__fadd_rn((float)i, 0.5f), (float)kS);
    const float coord = __fadd_rn(lo, __fmul_rn(g, bin));
    const int extent = is_y ? h : w;
    const float ext = (float)extent;
    const bool ok = coord > -1.0f && coord < ext;
    const float cl = fminf(fmaxf(coord, 0.0f), __fsub_rn(ext, 1.0f));
    const float f0 = floorf(cl);
    const int i0 = (int)f0;
    const int i1 = min(i0 + 1, extent - 1);
    const float frac = __fsub_rn(cl, f0);
    if (is_y) {
      row0[i] = i0 * w * cell_bytes;
      row1[i] = i1 * w * cell_bytes;
      frac_y[i] = frac;
      valid_y[i] = ok;
    } else {
      col0[i] = i0 * cell_bytes;
      col1[i] = i1 * cell_bytes;
      frac_x[i] = frac;
      valid_x[i] = ok;
    }
  }
  __syncthreads();

  const int py = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bytes = min(kLaneBytes, cell_bytes - ch0 * (int)sizeof(T) - kLaneBytes * lane);
  if (bytes <= 0) return;
  const unsigned char* img = static_cast<const unsigned char*>(lv.feat[l]) +
                             (size_t)b * h * w * cell_bytes + ch0 * sizeof(T) + kLaneBytes * lane;
  const bool vec = bytes == kLaneBytes && ((reinterpret_cast<uintptr_t>(img) | cell_bytes) & 15) == 0;
  const int nch = bytes / (int)sizeof(T);
  float* dst = out + ((size_t)roi * kP * kP + py * kP) * c + ch0 + kCh * lane;
  const bool store4 = nch == kCh && ((reinterpret_cast<uintptr_t>(dst) | (c * 4)) & 15) == 0;

  int ry[kS][2];
  float ly[kS];
  bool vy[kS];
#pragma unroll
  for (int sy = 0; sy < kS; ++sy) {
    const int iy = py * kS + sy;
    ry[sy][0] = row0[iy];
    ry[sy][1] = row1[iy];
    ly[sy] = frac_y[iy];
    vy[sy] = valid_y[iy];
  }
  for (int px = 0; px < kP; ++px) {
    float acc[kCh];
#pragma unroll
    for (int sy = 0; sy < kS; ++sy) {
      uint4 tap[kS][4];
#pragma unroll
      for (int sx = 0; sx < kS; ++sx) {
        const int ix = px * kS + sx;
        const int x0 = col0[ix], x1 = col1[ix];
        tap[sx][0] = load_lane(img + ry[sy][0] + x0, vec, bytes);
        tap[sx][1] = load_lane(img + ry[sy][0] + x1, vec, bytes);
        tap[sx][2] = load_lane(img + ry[sy][1] + x0, vec, bytes);
        tap[sx][3] = load_lane(img + ry[sy][1] + x1, vec, bytes);
      }
      const float hy = __fsub_rn(1.0f, ly[sy]);
#pragma unroll
      for (int sx = 0; sx < kS; ++sx) {
        const int ix = px * kS + sx;
        const float lx = frac_x[ix];
        const float hx = __fsub_rn(1.0f, lx);
        const float w00 = __fmul_rn(hy, hx), w01 = __fmul_rn(hy, lx);
        const float w10 = __fmul_rn(ly[sy], hx), w11 = __fmul_rn(ly[sy], lx);
        const bool ok = vy[sy] && valid_x[ix];
        float v00[kCh], v01[kCh], v10[kCh], v11[kCh];
        unpack(tap[sx][0], v00);
        unpack(tap[sx][1], v01);
        unpack(tap[sx][2], v10);
        unpack(tap[sx][3], v11);
#pragma unroll
        for (int q = 0; q < kCh; ++q) {
          const float v =
              ok ? __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(v00[q], w00), __fmul_rn(v01[q], w01)),
                                       __fmul_rn(v10[q], w10)),
                             __fmul_rn(v11[q], w11))
                 : 0.0f;
          acc[q] = (sy == 0 && sx == 0) ? v : __fadd_rn(acc[q], v);
        }
      }
    }
    const float inv = 1.0f / (kS * kS);  // a power of two: exact
    float* o = dst + px * c;
    if (store4) {
#pragma unroll
      for (int q = 0; q < kCh; q += 4) {
        *reinterpret_cast<float4*>(o + q) = make_float4(
            __fmul_rn(acc[q], inv), __fmul_rn(acc[q + 1], inv), __fmul_rn(acc[q + 2], inv),
            __fmul_rn(acc[q + 3], inv));
      }
    } else {
#pragma unroll
      for (int q = 0; q < kCh; q += 2) {
        if (q < nch) {
          *reinterpret_cast<float2*>(o + q) =
              make_float2(__fmul_rn(acc[q], inv), __fmul_rn(acc[q + 1], inv));
        }
      }
    }
  }
}

}  // namespace

// feats: nlevels (B, H_l, W_l, C) maps of one dtype; heights, widths,
// strides: host arrays of kMaxLevels entries; rois (B*R, 4) float32; levels
// (B*R) int32 in [0, nlevels); out (B*R, 7, 7, C) float32.  C must be even.
extern "C" int viddet_roi_align(const void* feat0, const void* feat1, const void* feat2,
                                const void* feat3, const int* heights, const int* widths,
                                const float* strides, int nlevels, int batch,
                                int rois_per_image, int c, int is_bf16, const void* rois,
                                const void* levels, void* out, void* stream) {
  if (nlevels < 1 || nlevels > kMaxLevels || c < 2 || c % 2) return (int)cudaErrorInvalidValue;
  Levels lv;
  const void* feats[kMaxLevels] = {feat0, feat1, feat2, feat3};
  for (int i = 0; i < kMaxLevels; ++i) {
    lv.feat[i] = feats[i];
    lv.h[i] = heights[i];
    lv.w[i] = widths[i];
    lv.stride[i] = strides[i];
  }
  const int elem = is_bf16 ? 2 : 4;
  const int slices = (c * elem + kSliceBytes - 1) / kSliceBytes;
  const long long blocks = (long long)batch * rois_per_image * slices;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    const float* r = static_cast<const float*>(rois);
    const int* lev = static_cast<const int*>(levels);
    float* o = static_cast<float*>(out);
    const unsigned grid = (unsigned)blocks;
    if (is_bf16) {
      roi_align_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(lv, r, lev, rois_per_image, c,
                                                                 slices, o);
    } else {
      roi_align_kernel<float><<<grid, kThreads, 0, s>>>(lv, r, lev, rois_per_image, c, slices, o);
    }
  }
  return (int)cudaGetLastError();
}
