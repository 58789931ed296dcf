// K8 conv_down2_bn_leaky: stride-2 3x3 convolution ("SAME": one zero row
// and column at the high side), folded inference BatchNorm and leaky ReLU,
// as one implicit GEMM.
//
// Replaces the Pallas kernel viddet_tpu/ops/conv_pallas.py:91
// `conv_down2_bn_leaky` (`_kernel_pairview`, :34), which views x as
// (B, H/2, 2, W/2, 2*Cin) (:126), builds an im2col block in VMEM and runs
// one matmul per row chunk.  Here, with x NHWC (B, H, W, Cin):
//
//   GEMM   M = B*(H/2)*(W/2) output pixels, N = Cout, K = 9*Cin
//   A[m, (dy, dx, ci)] = x[b, 2*oy + dy, 2*ox + dx, ci]  (0 at row H or column W)
//   out[m, n] = leaky(acc[m, n] * a[n] + b[n]), rounded once to x's dtype (NHWC)
//
// Epilogue, every route: the affine and the leaky ReLU in float32 on the
// float32 accumulator, as the plain version does, each step an _rn
// intrinsic (the file is built with -fmad=false), so acc * a + b is
// rounded twice, never contracted into an FMA.
//
// What bounds it on an H100: bytes.  At the main path's three layers
// (batch 32 at 416 px: 32->64, 64->128 and 128->256 channels) the work is
// 153 GFLOP and 931 MB of activations and weights read and written once:
// 0.155 ms at the 989 TFLOP/s dense bf16 tensor-core peak against 0.278
// ms at 3.35 TB/s.  But each input pixel is read by the taps of up to
// four output pixels and every tile reads its whole weight matrix, so the
// tiles fetch 2.3 GB from the L2 cache (the input halo alone 9/4 of the
// input; chip_smoke.py's `k8_l2_bytes` counts it).  L2 serves those
// re-reads, HBM only the first read.  The card's rate of fetching from L2
// into each SM is the likeliest limit of this kernel, a reading of its
// times that no hardware counter has confirmed (PERF.md).
//
// bf16 design (conv_bf16_tma_kernel), for Cin % 4 == 0, Cout % 8 == 0 and
// 16-byte aligned x: the TPU kernel's pair view is a 5-D TMA tensor map,
// dims {2*Cin, W/2, 2, H/2, B} innermost first.  For one kernel row dy,
// the taps dx = 0, 1 of an r x c tile of output pixels are the box
// (channels [0, 2*Cin), pair columns ox0.., parity dy%2, pair rows
// oy0 + dy/2..) and the tap dx = 2 the box one pair column on, channels
// [0, Cin) (a second map with Cin channels).  The SAME pad (row H, column
// W) lies exactly out of bounds of the maps (pair row H/2, pair column
// W/2), and so do a ragged chunk's channels past 2*Cin or Cin: TMA fills
// all of them with zeros, so no tap needs a mask or an index division.
// The wrapper cuts each box into 64-channel (128-byte) chunks and passes
// the list (ops/conv_cuda.py `k_schedule`); pack_weights_kernel lays the
// weights out K-major as (Cout, 64 * chunks), each chunk's rows
// zero-padded to 64.
//
// A persistent block per SM walks output tiles of 256 pixels (r x c,
// picked per layer by the wrapper to waste the fewest padded pixels) by
// N = 64 or 128 channels (the wrapper's tile_n: 64 where Cout fits).  One
// producer warp issues the two TMA loads of each chunk (input box 32 KB,
// weight box N x 128 bytes, both in the 128-byte swizzle) into a ring of
// four stages guarded by full and empty mbarriers; it runs ahead into the
// next tile while the consumers finish the current one.  Two consumer
// warpgroups each multiply 128 of the tile's pixels with two
// wgmma.m64nNk16 per 16 channels (float32 accumulators in registers),
// keeping one chunk's products in flight while releasing the stage
// before.  Tiles of 256 pixels rather than 128 halve the weight boxes
// fetched per pixel and the per-tile overhead.  The epilogue writes the
// bf16 tile, 64 channels at a time, into shared memory in the 128-byte
// swizzle (no bank conflicts) and one TMA store sends it out; rows and
// columns past the output's edge are clipped by the store. A wait that
// outlasts about four seconds traps instead of hanging the card.
//
// The other routes: bf16 shapes the maps cannot describe (Cin % 4 != 0,
// Cout % 8 != 0, or an x not 16-byte aligned) run conv_bf16_scalar_kernel
// (128 x 64 tiles filled element by element into two shared stages,
// mma.sync m16n8k16 from ldmatrix); float32 runs conv_f32_kernel (64 x 64
// tiles of plain FMA, no TF32, no library call).
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// ------------------------------------------------------------------ bf16, TMA + wgmma

constexpr int kChunk = 64;      // channels of one input box, k-elements of one weight box
constexpr int kRowBytes = 128;  // a chunk's row: 64 bf16, one 128-byte swizzle span
constexpr int kMaxChunks = 36;  // 3 rows x (ceil(2*255/64) + ceil(255/64))
constexpr int kSubM = 64;       // pixels of one wgmma
constexpr int kSubTiles = 2;    // wgmma blocks of 64 pixels per consumer warpgroup
constexpr int kTileM = 2 * kSubTiles * kSubM;  // pixels of a tile: 256
constexpr int kConsumerWarps = 8;
constexpr int kTmaThreads = (kConsumerWarps + 1) * 32;  // + one producer warp
constexpr long long kWatchdogCycles = 1ll << 33;
constexpr int kABytes = kTileM * kRowBytes;               // an input box: 32 KB
constexpr int kOutBlock = kSubTiles * kSubM * kRowBytes;  // a warpgroup's pixels x 64 channels
constexpr int kSmemLimit = 232448;                        // the H100's shared memory for a block

// Shared memory: the ring of (input box, weight box) stages, one output
// staging block per warpgroup, the barriers.  With N = 64 or 128 the ring
// has four stages (160 or 192 KB).
template <int kN>
struct TmaSmem {
  static constexpr int kBBytes = kN * kRowBytes;  // a weight box: 8 or 16 KB
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kFixed = 2 * kOutBlock + 1024 /* alignment */ + 256 /* barriers */;
  static constexpr int kStages = (kSmemLimit - kFixed) / kStageBytes;
  static constexpr int kBytes = kStages * kStageBytes + kFixed;
  static_assert(kStages >= 4 && kStages <= 8, "a ring of four to eight stages");
};

struct TmaPlan {
  int cout, tile_r, tile_c, tiles_x, tiles_y, tiles_n, num_tiles, nchunks;
  // per chunk: bit 0 pair-row offset (dy / 2), bit 1 parity (dy % 2),
  // bit 2 pair-column offset (1 for the dx = 2 box), bits 3.. first channel
  unsigned short chunk[kMaxChunks];
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  long long start = 0;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start == 0) {
      start = now;
    } else if (now - start > kWatchdogCycles) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read_all() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A shared-memory operand of wgmma: K-major rows of 128 bytes in the
// 128-byte swizzle, 8-row groups 1024 bytes apart.  A k-step of 16 bf16
// moves the start by 32 bytes inside the swizzle span.
__device__ __forceinline__ uint64_t sw128_desc(unsigned saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}


template <int kN>
__device__ __forceinline__ void wgmma(float (&d)[kN / 2], uint64_t da, uint64_t db) {
  if constexpr (kN == 64) {
    wgmma_m64n64(d, da, db);
  } else {
    wgmma_m64n128(d, da, db);
  }
}

// One persistent block: warps 0-7 are two consumer warpgroups, warp 8 the
// producer.  Tiles are numbered with the N tile fastest, then the tile
// column, row and image, so the blocks in flight share input rows and
// weights in L2.
template <int kN>
__global__ void __launch_bounds__(kTmaThreads, 1)
    conv_bf16_tma_kernel(const __grid_constant__ CUtensorMap map_x2,
                         const __grid_constant__ CUtensorMap map_x1,
                         const __grid_constant__ CUtensorMap map_w,
                         const __grid_constant__ CUtensorMap map_out, const TmaPlan plan,
                         const float* __restrict__ fa, const float* __restrict__ fb,
                         float slope) {
  using Smem = TmaSmem<kN>;
  constexpr int kStages = Smem::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* a_ring = smem;
  unsigned char* b_ring = a_ring + kStages * kABytes;
  unsigned char* out_tile = b_ring + kStages * Smem::kBBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_tile + 2 * kOutBlock);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer: one thread issues every load
    if (lane != 0) return;
    int s = 0;
    unsigned phase = 0;
    for (int t = blockIdx.x; t < plan.num_tiles; t += gridDim.x) {
      int rest = t;
      const int n0 = rest % plan.tiles_n * kN;
      rest /= plan.tiles_n;
      const int ox0 = rest % plan.tiles_x * plan.tile_c;
      rest /= plan.tiles_x;
      const int oy0 = rest % plan.tiles_y * plan.tile_r;
      const int b = rest / plan.tiles_y;
      for (int j = 0; j < plan.nchunks; ++j) {
        mbar_wait(&empty[s], phase ^ 1);
        mbar_expect_tx(&full[s], Smem::kStageBytes);
        const unsigned e = plan.chunk[j];
        const int dx2 = (e >> 2) & 1;
        tma_load_5d(a_ring + s * kABytes, dx2 ? &map_x1 : &map_x2, &full[s], (int)(e >> 3),
                    ox0 + dx2, (e >> 1) & 1, oy0 + (e & 1), b);
        tma_load_2d(b_ring + s * Smem::kBBytes, &map_w, &full[s], j * kChunk, n0);
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, w4 = warp & 3, t128 = threadIdx.x & 127;
  unsigned char* my_out = out_tile + wg * kOutBlock;
  float acc[kSubTiles][kN / 2];
  int s = 0;
  unsigned phase = 0;
  for (int t = blockIdx.x; t < plan.num_tiles; t += gridDim.x) {
    int rest = t;
    const int n0 = rest % plan.tiles_n * kN;
    rest /= plan.tiles_n;
    const int ox0 = rest % plan.tiles_x * plan.tile_c;
    rest /= plan.tiles_x;
    const int oy0 = rest % plan.tiles_y * plan.tile_r;
    const int b = rest / plan.tiles_y;

#pragma unroll
    for (int sub = 0; sub < kSubTiles; ++sub) {
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[sub][i] = 0.0f;
      fence_acc(acc[sub]);
    }
    int prev = -1;
    for (int j = 0; j < plan.nchunks; ++j) {
      mbar_wait(&full[s], phase);
      const unsigned a_addr = smem_addr(a_ring + s * kABytes) + wg * kOutBlock;
      const unsigned b_addr = smem_addr(b_ring + s * Smem::kBBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
#pragma unroll
        for (int sub = 0; sub < kSubTiles; ++sub) {
          wgmma<kN>(acc[sub], sw128_desc(a_addr + sub * kSubM * kRowBytes + kk * 32),
                    sw128_desc(b_addr + kk * 32));
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the chunk before this one is done: release its stage
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int sub = 0; sub < kSubTiles; ++sub) fence_acc(acc[sub]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);

    // Epilogue, 64 channels at a time: this warpgroup's 128 pixels into its
    // staging block (rows of 128 bytes in the 128-byte swizzle: no bank
    // conflicts), once the block's last TMA store has read it; then one
    // TMA store of the block.
#pragma unroll
    for (int q = 0; q < kN / 64; ++q) {
      if (t128 == 0) bulk_wait_read_all();
      named_sync(1 + wg, 128);
#pragma unroll
      for (int g8 = 0; g8 < 8; ++g8) {
        const int g = q * 8 + g8;
        const int col = n0 + g * 8 + 2 * (lane & 3);
        const bool in = col < plan.cout;  // Cout % 8 == 0: col and col + 1 together
        const float a0 = in ? __ldg(fa + col) : 0.0f, a1 = in ? __ldg(fa + col + 1) : 0.0f;
        const float b0 = in ? __ldg(fb + col) : 0.0f, b1 = in ? __ldg(fb + col + 1) : 0.0f;
#pragma unroll
        for (int sub = 0; sub < kSubTiles; ++sub) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = sub * kSubM + w4 * 16 + (lane >> 2) + 8 * h;
            const __nv_bfloat162 v =
                __floats2bfloat162_rn(bn_leaky(acc[sub][4 * g + 2 * h], a0, b0, slope),
                                      bn_leaky(acc[sub][4 * g + 2 * h + 1], a1, b1, slope));
            *reinterpret_cast<__nv_bfloat162*>(my_out + row * kRowBytes +
                                               ((g8 ^ (row & 7)) << 4) + 4 * (lane & 3)) = v;
          }
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + wg, 128);
      if (t128 == 0 && n0 + q * 64 < plan.cout) {
        tma_store_4d(&map_out, my_out, n0 + q * 64, ox0, oy0 + wg * (plan.tile_r / 2), b);
        bulk_commit();
      }
    }
  }
  if (t128 == 0) bulk_wait_all();
}

// The TMA kernel's weights: w (Cout, Cin, 3, 3), float32 or bf16, to bf16
// (Cout, 64 * chunks), K-major: chunk j's columns [64 j, 64 j + width)
// hold the weight rows [row0, row0 + width) of the (dy, dx, ci) order,
// the rest zeros (ops/conv_cuda.py `pack_weight` in plain PyTorch).
struct PackSpans {
  int nchunks;
  unsigned short width[kMaxChunks], row0[kMaxChunks];
};

template <typename T>
__global__ void pack_weights_kernel(const T* __restrict__ w, int cout, int cin, PackSpans spans,
                                    __nv_bfloat16* __restrict__ packed) {
  const int cols = kChunk * spans.nchunks;
  const long long total = (long long)cout * cols;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(i / cols), col = (int)(i % cols), j = col / kChunk, t = col % kChunk;
    float v = 0.0f;
    if (t < spans.width[j]) {
      const int row = spans.row0[j] + t, tap = row / cin, ci = row % cin;  // tap = 3 dy + dx
      const T wv = w[((long long)n * cin + ci) * 9 + tap];
      if constexpr (sizeof(T) == 2) {
        v = __bfloat162float(wv);
      } else {
        v = wv;
      }
    }
    packed[i] = __float2bfloat16(v);  // round to nearest even, as torch's cast
  }
}

// ------------------------------------------------------------------ bf16, scalar fill

constexpr int BM = 128, BN = 64, BK = 32;
constexpr int kThreads = 256;
constexpr int kAStride = BK + 8;  // bf16 per shared row: 80 bytes, ldmatrix without conflicts
constexpr int kBStride = BN + 8;  // 144 bytes

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

// Any Cin, Cout and alignment: 128 x 64 tiles filled element by element
// into two shared stages, 8 warps of 32 x 32, wm as (9*Cin, Cout).
__global__ void __launch_bounds__(kThreads)
    conv_bf16_scalar_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ wm, const float* __restrict__ fa,
                            const float* __restrict__ fb, ConvShape s, float slope,
                            __nv_bfloat16* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 As[2][BM][kAStride];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][BK][kBStride];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const long long block_m = (long long)blockIdx.x * BM;
  const int block_n = blockIdx.y * BN;

  auto load_tiles = [&](int k0, int stage) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      As[stage][e / BK][e % BK] = __float2bfloat16(input_at(x, s, block_m + e / BK, k0 + e % BK));
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kb = k0 + e / BN, n = block_n + e % BN;
      Bs[stage][e / BN][e % BN] =
          kb < s.k && n < s.cout ? wm[(long long)kb * s.cout + n] : __float2bfloat16(0.0f);
    }
  };

  float acc[2][4][4] = {};
  const int k_tiles = (s.k + BK - 1) / BK;
  load_tiles(0, 0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < k_tiles) load_tiles((kt + 1) * BK, stage ^ 1);
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

// ------------------------------------------------------------------ host: tensor maps

// cuTensorMapEncodeTiled's type (cuda.h); the function is looked up
// through the runtime, so the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 map with 128-byte swizzle; out-of-bounds elements read as zero
// and are not written.  dims innermost first, strides in bytes of dims 1...
// No L2 promotion: on the card it ran slightly faster than 128 or 256 bytes.
bool encode_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const EncodeTiledFn fn = encode_tiled();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(base), dims,
            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kN>
int launch_tma(const void* x, const void* w, const float* fa, const float* fb, const ConvShape& s,
               const TmaPlan& plan, float slope, void* out, cudaStream_t st) {
  CUtensorMap map_x2, map_x1, map_w, map_out;
  const cuuint64_t cin = (cuuint64_t)s.cin, w2 = (cuuint64_t)s.w2, h2 = (cuuint64_t)s.h2;
  const cuuint64_t x_strides[4] = {4 * cin, 2 * (cuuint64_t)s.w * cin, 4 * (cuuint64_t)s.w * cin,
                                   2 * (cuuint64_t)s.h * s.w * cin};
  const cuuint32_t x_box[5] = {kChunk, (cuuint32_t)plan.tile_c, 1, (cuuint32_t)plan.tile_r, 1};
  const cuuint64_t x2_dims[5] = {2 * cin, w2, 2, h2, (cuuint64_t)s.batch};
  const cuuint64_t x1_dims[5] = {cin, w2, 2, h2, (cuuint64_t)s.batch};
  const cuuint64_t kp = (cuuint64_t)kChunk * plan.nchunks;
  const cuuint64_t w_dims[2] = {kp, (cuuint64_t)s.cout}, w_strides[1] = {2 * kp};
  const cuuint32_t w_box[2] = {kChunk, kN};
  const cuuint64_t cout = (cuuint64_t)s.cout;
  const cuuint64_t o_dims[4] = {cout, w2, h2, (cuuint64_t)s.batch};
  const cuuint64_t o_strides[3] = {2 * cout, 2 * w2 * cout, 2 * h2 * w2 * cout};
  const cuuint32_t o_box[4] = {kChunk, (cuuint32_t)plan.tile_c, (cuuint32_t)(plan.tile_r / 2), 1};
  if (!encode_map(&map_x2, x, 5, x2_dims, x_strides, x_box) ||
      !encode_map(&map_x1, x, 5, x1_dims, x_strides, x_box) ||
      !encode_map(&map_w, w, 2, w_dims, w_strides, w_box) ||
      !encode_map(&map_out, out, 4, o_dims, o_strides, o_box)) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = plan.num_tiles < sms ? plan.num_tiles : sms;
  const cudaError_t err = cudaFuncSetAttribute(
      conv_bf16_tma_kernel<kN>, cudaFuncAttributeMaxDynamicSharedMemorySize, TmaSmem<kN>::kBytes);
  if (err != cudaSuccess) return (int)err;
  conv_bf16_tma_kernel<kN><<<grid, kTmaThreads, TmaSmem<kN>::kBytes, st>>>(
      map_x2, map_x1, map_w, map_out, plan, fa, fb, slope);
  return (int)cudaGetLastError();
}

// The bf16 TMA route: pack the weights into `packed`, then the conv.
int run_tma(const void* x, const void* w, int w_is_bf16, const float* fa, const float* fb,
            const ConvShape& s, const int* sched, int nsched, int tile_r, int tile_c, int tile_n,
            float slope, void* packed, void* out, cudaStream_t st) {
  TmaPlan plan;
  PackSpans spans;
  plan.cout = s.cout;
  plan.tile_r = tile_r;
  plan.tile_c = tile_c;
  plan.tiles_x = (s.w2 + tile_c - 1) / tile_c;
  plan.tiles_y = (s.h2 + tile_r - 1) / tile_r;
  plan.tiles_n = (s.cout + tile_n - 1) / tile_n;
  const long long tiles = (long long)s.batch * plan.tiles_y * plan.tiles_x * plan.tiles_n;
  if (tiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  plan.num_tiles = (int)tiles;
  plan.nchunks = spans.nchunks = nsched;
  for (int j = 0; j < nsched; ++j) {
    const int* e = sched + 6 * j;  // (row offset, parity, column offset, channel, width, weight row)
    const int span = e[2] ? s.cin : 2 * s.cin;
    if ((unsigned)e[0] > 1 || (unsigned)e[1] > 1 || (unsigned)e[2] > 1 || e[3] < 0 ||
        e[3] >= span || e[3] % kChunk || e[4] < 1 || e[4] > kChunk || e[4] > span - e[3] ||
        e[5] < 0 || e[5] + e[4] > s.k) {
      return (int)cudaErrorInvalidValue;
    }
    plan.chunk[j] = (unsigned short)(e[0] | e[1] << 1 | e[2] << 2 | e[3] << 3);
    spans.width[j] = (unsigned short)e[4];
    spans.row0[j] = (unsigned short)e[5];
  }
  const long long pack_total = (long long)s.cout * kChunk * nsched;
  const unsigned pack_blocks = (unsigned)((pack_total + 255) / 256 < 1024 ? (pack_total + 255) / 256 : 1024);
  auto* pk = static_cast<__nv_bfloat16*>(packed);
  if (w_is_bf16) {
    pack_weights_kernel<<<pack_blocks, 256, 0, st>>>(static_cast<const __nv_bfloat16*>(w), s.cout,
                                                      s.cin, spans, pk);
  } else {
    pack_weights_kernel<<<pack_blocks, 256, 0, st>>>(static_cast<const float*>(w), s.cout, s.cin,
                                                      spans, pk);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return tile_n == 64 ? launch_tma<64>(x, packed, fa, fb, s, plan, slope, out, st)
                      : launch_tma<128>(x, packed, fa, fb, s, plan, slope, out, st);
}

}  // namespace

// x (B, H, W, Cin) and out (B, H/2, W/2, Cout), both NHWC in x's dtype;
// a, b (Cout) float32.  With a schedule (bf16 only; `sched` a host array
// of 6 ints per 64-channel chunk, from ops/conv_cuda.py `k_schedule`), w
// is (Cout, Cin, 3, 3), bf16 if w_is_bf16 else float32, `packed` a bf16
// scratch of Cout x 64 * nsched, and the TMA kernel runs on tiles of
// tile_r x tile_c = 256 output pixels by tile_n = 64 or 128 channels (all
// three chosen by the wrapper), on min(tiles, SM count) persistent blocks.
// Without one, w is (9*Cin, Cout) in x's dtype.
extern "C" int viddet_conv_down2_bn_leaky(const void* x, const void* w, int w_is_bf16,
                                          const void* a, const void* b, int batch, int h, int wd,
                                          int cin, int cout, float slope, int is_bf16,
                                          const int* sched, int nsched, int tile_r, int tile_c,
                                          int tile_n, void* packed, void* out, void* stream) {
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
  if (sched != nullptr) {
    const bool ok = is_bf16 && cin % 4 == 0 && cout % 8 == 0 && (uintptr_t)x % 16 == 0 &&
                    (uintptr_t)packed % 16 == 0 && (uintptr_t)out % 16 == 0 && nsched >= 1 &&
                    nsched <= kMaxChunks && tile_r % 2 == 0 && tile_r * tile_c == kTileM &&
                    tile_c <= 256 && tile_r <= 256 && (tile_n == 64 || tile_n == 128);
    if (!ok) return (int)cudaErrorInvalidValue;
    return run_tma(x, w, w_is_bf16, fa, fb, s, sched, nsched, tile_r, tile_c, tile_n, slope,
                   packed, out, st);
  }
  if (is_bf16) {
    const dim3 grid((unsigned)((s.m + BM - 1) / BM), (unsigned)((cout + BN - 1) / BN));
    conv_bf16_scalar_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), fa, fb, s,
        slope, static_cast<__nv_bfloat16*>(out));
  } else {
    const dim3 grid((unsigned)((s.m + FBM - 1) / FBM), (unsigned)((cout + FBN - 1) / FBN));
    conv_f32_kernel<<<grid, 256, 0, st>>>(static_cast<const float*>(x),
                                          static_cast<const float*>(w), fa, fb, s, slope,
                                          static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
