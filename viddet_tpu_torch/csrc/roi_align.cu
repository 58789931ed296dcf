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
// window: every sample reads its own four cells, so the kernel is exact for
// any roi.
//
// Bound on an H100: bytes.  At the Faster R-CNN path's full width (batch
// 8, 300 rois, C = 256) the (8, 300, 7, 7, 256) float32 output is 120.4 MB
// and the bf16 P2..P5 pyramid 89.1 MB: 36 us for the output alone, 63 us
// with the whole pyramid read once, at 3.35 TB/s.  The arithmetic, about
// 1.1 GFLOP, takes 16 us on the CUDA cores.
// Design: one block per roi; its threads span the channels, two a thread,
// so each tap is one coalesced row read (512 bytes of bf16 at C = 256) that
// L2 mostly serves, since one image's pyramid (11 MB in bf16) fits the 50
// MB L2.  The first 28 threads compute the 14 row and 14 column samples
// (cell indices, fractions, validity) into shared memory; then each thread
// walks the 49 bins x 4 samples x 4 taps, accumulating in float32, and
// writes each bin's channel pair as one 8-byte store, coalesced over the
// block.  Every rounding is an _rn intrinsic and the file is built with
// -fmad=false, in the plain version's order (taps left to right, samples
// row by row, then / 4), so the kernel equals the plain version bit for
// bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kP = 7;           // bins per side
constexpr int kS = 2;           // samples per bin side
constexpr int kN = kP * kS;     // samples per roi side
constexpr int kThreads = 128;   // channel pairs; C = 256 is one pair a thread

struct Levels {
  const void* feat[kMaxLevels];  // (B, H, W, C) each
  int h[kMaxLevels];
  int w[kMaxLevels];
  float stride[kMaxLevels];
};

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_kernel(Levels lv, const float* __restrict__ rois, const int* __restrict__ levels,
                 int rois_per_image, int c, float* __restrict__ out) {
  __shared__ int row0[kN], row1[kN], col0[kN], col1[kN];  // cell offsets in elements
  __shared__ float frac_y[kN], frac_x[kN];
  __shared__ bool valid_y[kN], valid_x[kN];

  const int roi = blockIdx.x;
  const int b = roi / rois_per_image;
  const int l = levels[roi];
  const int h = lv.h[l], w = lv.w[l];

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
      row0[i] = i0 * w * c;
      row1[i] = i1 * w * c;
      frac_y[i] = frac;
      valid_y[i] = ok;
    } else {
      col0[i] = i0 * c;
      col1[i] = i1 * c;
      frac_x[i] = frac;
      valid_x[i] = ok;
    }
  }
  __syncthreads();

  const T* img = static_cast<const T*>(lv.feat[l]) + (size_t)b * h * w * c;
  float* dst = out + (size_t)roi * kP * kP * c;
  for (int ch = 2 * threadIdx.x; ch < c; ch += 2 * blockDim.x) {
    const T* base = img + ch;
    for (int py = 0; py < kP; ++py) {
      for (int px = 0; px < kP; ++px) {
        float2 acc = make_float2(0.0f, 0.0f);
        for (int sy = 0; sy < kS; ++sy) {
          const int iy = py * kS + sy;
          const float ly = frac_y[iy];
          const float hy = __fsub_rn(1.0f, ly);
          for (int sx = 0; sx < kS; ++sx) {
            const int ix = px * kS + sx;
            float2 v = make_float2(0.0f, 0.0f);
            if (valid_y[iy] && valid_x[ix]) {
              const float lx = frac_x[ix];
              const float hx = __fsub_rn(1.0f, lx);
              const float w00 = __fmul_rn(hy, hx), w01 = __fmul_rn(hy, lx);
              const float w10 = __fmul_rn(ly, hx), w11 = __fmul_rn(ly, lx);
              const float2 v00 = load_pair(base + row0[iy] + col0[ix]);
              const float2 v01 = load_pair(base + row0[iy] + col1[ix]);
              const float2 v10 = load_pair(base + row1[iy] + col0[ix]);
              const float2 v11 = load_pair(base + row1[iy] + col1[ix]);
              v.x = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(v00.x, w00), __fmul_rn(v01.x, w01)),
                                        __fmul_rn(v10.x, w10)),
                              __fmul_rn(v11.x, w11));
              v.y = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(v00.y, w00), __fmul_rn(v01.y, w01)),
                                        __fmul_rn(v10.y, w10)),
                              __fmul_rn(v11.y, w11));
            }
            if (sy == 0 && sx == 0) {
              acc = v;
            } else {
              acc.x = __fadd_rn(acc.x, v.x);
              acc.y = __fadd_rn(acc.y, v.y);
            }
          }
        }
        const float inv = 1.0f / (kS * kS);  // a power of two: exact
        *reinterpret_cast<float2*>(dst + (py * kP + px) * c + ch) =
            make_float2(__fmul_rn(acc.x, inv), __fmul_rn(acc.y, inv));
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
  const int blocks = batch * rois_per_image;
  if (blocks > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    const float* r = static_cast<const float*>(rois);
    const int* lev = static_cast<const int*>(levels);
    float* o = static_cast<float*>(out);
    if (is_bf16) {
      roi_align_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(lv, r, lev, rois_per_image, c, o);
    } else {
      roi_align_kernel<float><<<blocks, kThreads, 0, s>>>(lv, r, lev, rois_per_image, c, o);
    }
  }
  return (int)cudaGetLastError();
}
