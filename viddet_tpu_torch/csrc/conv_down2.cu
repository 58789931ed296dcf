// K8 conv_down2_bn_leaky: stride-2 3x3 convolution ("SAME": one zero row
// and column at the high side), folded inference BatchNorm and leaky ReLU,
// as one implicit GEMM.
//
// Replaces the Pallas kernel viddet_tpu/ops/conv_pallas.py
// `conv_down2_bn_leaky` (`_kernel_pairview`), which builds an im2col
// block in VMEM and runs one matmul per row chunk.  Here, with x NHWC
// (B, H, W, Cin) and the weights as a (9*Cin, Cout) matrix in (dy, dx,
// cin) row order:
//
//   GEMM   M = B*(H/2)*(W/2) output pixels, N = Cout, K = 9*Cin
//   A[m, (dy, dx, ci)] = x[b, 2*oy + dy, 2*ox + dx, ci]  (0 at row H or column W)
//   out[m, n] = leaky(acc[m, n] * a[n] + b[n]), rounded once to x's dtype (NHWC)
//
// The zero pad is folded into the loads: an out-of-range tap is a
// zero-filled copy, so no padded copy of x is ever made.  The epilogue
// applies the affine and the leaky ReLU in float32 to the float32
// accumulator, as the plain version does: each step is an _rn intrinsic
// (and the file is built with -fmad=false), so acc * a + b is rounded
// twice, never contracted into an FMA.
//
// Bound on an H100: bytes.  At the main path's three layers (batch 32 at
// 416 px: 32->64, 64->128 and 128->256 channels) the work is 153 GFLOP
// and about 930 MB of activations read and written once, 0.155 ms at the
// 989 TFLOP/s dense bf16 tensor-core peak against 0.278 ms at 3.35 TB/s.
// Design, bf16: 128 x 64 output tiles, 256 threads (8 warps of 32 x 32),
// K in steps of 32 staged through shared memory in two buffers filled by
// 16-byte cp.async copies (zero-filled where the tap is padding), and
// mma.sync m16n8k16 bf16 tensor-core products with float32 accumulation,
// fed by ldmatrix.  Each input pixel is read by up to four tiles' taps,
// which the L2 cache serves.  This is the simple first form: wgmma and
// TMA, a deeper pipeline and larger tiles are the next steps.  When Cin or
// Cout is not a multiple of 8 the same tiles are filled by scalar loads.
// float32 inputs take a plain FMA path (64 x 64 tiles, 4 x 4 outputs a
// thread) with neither TF32 nor any library call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

struct ConvShape {
  int batch, h, w, cin, cout, h2, w2, k;
  long long m;
};

__device__ __forceinline__ float bn_leaky(float acc, float a, float b, float slope) {
  const float y = __fadd_rn(__fmul_rn(acc, a), b);
  return y >= 0.0f ? y : __fmul_rn(y, slope);
}

// x[b, 2*oy + dy, 2*ox + dx, ci] for GEMM row m and column k, 0 outside.
template <typename T>
__device__ __forceinline__ float input_at(const T* __restrict__ x, const ConvShape& s,
                                          long long m, int k) {
  if (m >= s.m || k >= s.k) return 0.0f;
  const long long plane = (long long)s.h2 * s.w2;
  const int b = (int)(m / plane);
  const int rem = (int)(m - b * plane);
  const int oy = rem / s.w2, ox = rem - (rem / s.w2) * s.w2;
  const int tap = k / s.cin, ci = k - (k / s.cin) * s.cin;
  const int iy = 2 * oy + tap / 3, ix = 2 * ox + tap % 3;
  if (iy >= s.h || ix >= s.w) return 0.0f;
  const T v = x[(((long long)b * s.h + iy) * s.w + ix) * s.cin + ci];
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(v);
  } else {
    return v;
  }
}

// ------------------------------------------------------------------ bf16

constexpr int BM = 128, BN = 64, BK = 32;
constexpr int kThreads = 256;
constexpr int kAStride = BK + 8;  // bf16 per shared row: 80 bytes, ldmatrix without conflicts
constexpr int kBStride = BN + 8;  // 144 bytes

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kVec: Cin and Cout are multiples of 8 and x and w are 16-byte aligned,
// so every 8-element k run of a tile row is one 16-byte copy.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    conv_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wm,
                     const float* __restrict__ fa, const float* __restrict__ fb, ConvShape s,
                     float slope, __nv_bfloat16* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 As[2][BM][kAStride];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][BK][kBStride];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const long long block_m = (long long)blockIdx.x * BM;
  const int block_n = blockIdx.y * BN;

  // The two A rows this thread copies (rows tid/4 and tid/4 + 64, one
  // 8-element k run each), decomposed once.
  const int a_run = (tid & 3) * 8;
  long long a_base[2];
  bool a_ok[2], a_last_y[2], a_last_x[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = block_m + (tid >> 2) + 64 * i;
    a_ok[i] = m < s.m;
    const long long mm = a_ok[i] ? m : 0;
    const long long plane = (long long)s.h2 * s.w2;
    const int b = (int)(mm / plane);
    const int rem = (int)(mm - b * plane);
    const int oy = rem / s.w2, ox = rem - (rem / s.w2) * s.w2;
    a_base[i] = (((long long)b * s.h + 2 * oy) * s.w + 2 * ox) * s.cin;
    a_last_y[i] = oy == s.h2 - 1;
    a_last_x[i] = ox == s.w2 - 1;
  }

  auto load_tiles = [&](int k0, int stage) {
    if constexpr (kVec) {
      const int k = k0 + a_run;
      const int tap = k / s.cin, ci = k - (k / s.cin) * s.cin;
      const int dy = tap / 3, dx = tap - (tap / 3) * 3;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bool ok = a_ok[i] && k < s.k && !(dy == 2 && a_last_y[i]) &&
                        !(dx == 2 && a_last_x[i]);
        const __nv_bfloat16* src = ok ? x + a_base[i] + ((long long)dy * s.w + dx) * s.cin + ci : x;
        cp_async16(&As[stage][(tid >> 2) + 64 * i][a_run], src, ok);
      }
      const int kb = k0 + (tid >> 3), n = block_n + (tid & 7) * 8;
      const bool ok = kb < s.k && n < s.cout;
      cp_async16(&Bs[stage][tid >> 3][(tid & 7) * 8], ok ? wm + (long long)kb * s.cout + n : wm,
                 ok);
    } else {
      for (int e = tid; e < BM * BK; e += kThreads) {
        As[stage][e / BK][e % BK] =
            __float2bfloat16(input_at(x, s, block_m + e / BK, k0 + e % BK));
      }
      for (int e = tid; e < BK * BN; e += kThreads) {
        const int kb = k0 + e / BN, n = block_n + e % BN;
        Bs[stage][e / BN][e % BN] =
            kb < s.k && n < s.cout ? wm[(long long)kb * s.cout + n] : __float2bfloat16(0.0f);
      }
    }
  };

  float acc[2][4][4] = {};
  const int k_tiles = (s.k + BK - 1) / BK;
  load_tiles(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < k_tiles) {
      load_tiles((kt + 1) * BK, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[2][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ldmatrix_x4(af[i], &As[stage][warp_m * 32 + i * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        ldmatrix_x4_trans(bf[jp],
                          &Bs[stage][kk + (lane & 15)][warp_n * 32 + jp * 16 + (lane >> 4) * 8]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_bf16(acc[i][j], af[i], bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = block_n + warp_n * 32 + j * 8 + (lane & 3) * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = block_m + warp_m * 32 + i * 16 + (lane >> 2) + half * 8;
        if (row >= s.m) continue;
        __nv_bfloat16* o = out + row * s.cout + col;
        if (col + 1 < s.cout && (s.cout & 1) == 0) {  // an aligned pair: one 4-byte store
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(
              bn_leaky(acc[i][j][half * 2], fa[col], fb[col], slope),
              bn_leaky(acc[i][j][half * 2 + 1], fa[col + 1], fb[col + 1], slope));
          continue;
        }
        if (col < s.cout) {
          o[0] = __float2bfloat16(bn_leaky(acc[i][j][half * 2], fa[col], fb[col], slope));
        }
        if (col + 1 < s.cout) {
          o[1] = __float2bfloat16(bn_leaky(acc[i][j][half * 2 + 1], fa[col + 1], fb[col + 1], slope));
        }
      }
    }
  }
}

// ------------------------------------------------------------------ float32

constexpr int FBM = 64, FBN = 64, FBK = 16;

__global__ void __launch_bounds__(256)
    conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ wm,
                    const float* __restrict__ fa, const float* __restrict__ fb, ConvShape s,
                    float slope, float* __restrict__ out) {
  __shared__ float As[FBK][FBM + 1];
  __shared__ float Bs[FBK][FBN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long block_m = (long long)blockIdx.x * FBM;
  const int block_n = blockIdx.y * FBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < s.k; k0 += FBK) {
    for (int e = tid; e < FBM * FBK; e += 256) {  // k fastest: channels are contiguous
      As[e % FBK][e / FBK] = input_at(x, s, block_m + e / FBK, k0 + e % FBK);
    }
    for (int e = tid; e < FBK * FBN; e += 256) {
      const int k = k0 + e / FBN, n = block_n + e % FBN;
      Bs[e / FBN][e % FBN] = k < s.k && n < s.cout ? wm[(long long)k * s.cout + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = block_m + ty * 4 + i;
    if (row >= s.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = block_n + tx * 4 + j;
      if (col < s.cout) out[row * s.cout + col] = bn_leaky(acc[i][j], fa[col], fb[col], slope);
    }
  }
}

}  // namespace

// x (B, H, W, Cin) and out (B, H/2, W/2, Cout), both NHWC in x's dtype;
// w (9*Cin, Cout) in x's dtype; a, b (Cout) float32.
extern "C" int viddet_conv_down2_bn_leaky(const void* x, const void* w, const void* a,
                                          const void* b, int batch, int h, int wd, int cin,
                                          int cout, float slope, int is_bf16, void* out,
                                          void* stream) {
  if (batch < 0 || h < 2 || wd < 2 || h % 2 || wd % 2 || cin < 1 || cin > 255 || cout < 1) {
    return (int)cudaErrorInvalidValue;
  }
  ConvShape s;
  s.batch = batch;
  s.h = h;
  s.w = wd;
  s.cin = cin;
  s.cout = cout;
  s.h2 = h / 2;
  s.w2 = wd / 2;
  s.k = 9 * cin;
  s.m = (long long)batch * s.h2 * s.w2;
  if (s.m == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  if (is_bf16) {
    const dim3 grid((unsigned)((s.m + BM - 1) / BM), (unsigned)((cout + BN - 1) / BN));
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    const bool vec = cin % 8 == 0 && cout % 8 == 0 && (uintptr_t)x % 16 == 0 &&
                     (uintptr_t)w % 16 == 0;
    if (vec) {
      conv_bf16_kernel<true><<<grid, kThreads, 0, st>>>(xb, wb, fa, fb, s, slope, ob);
    } else {
      conv_bf16_kernel<false><<<grid, kThreads, 0, st>>>(xb, wb, fa, fb, s, slope, ob);
    }
  } else {
    const dim3 grid((unsigned)((s.m + FBM - 1) / FBM), (unsigned)((cout + FBN - 1) / FBN));
    conv_f32_kernel<<<grid, 256, 0, st>>>(static_cast<const float*>(x),
                                          static_cast<const float*>(w), fa, fb, s, slope,
                                          static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
