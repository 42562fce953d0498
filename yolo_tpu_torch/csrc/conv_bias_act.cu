// Fused conv + folded-BN bias + leaky(0.1)/linear block for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// yolo_tpu/ops/pallas/conv_kernel.py::fused_conv_bias_act (body _kernel).
// Same contract: stride-1 SAME 3x3 or 1x1 conv, CIN and CO multiples of 128,
// fp32 accumulation, + fp32 bias, leaky(0.1) or linear, output in the
// input's dtype (bf16 or fp32). Plain version:
// yolo_tpu_torch/ops/conv.py::fused_conv_bias_act.
//
// Layouts (the Darknet executor's channels_last tensors, read in place):
//   x    (B, H, W, CIN)  NHWC bytes
//   w    (CO, ks, ks, CIN) bytes of an OIHW channels_last kernel
//   bias (CO,) fp32
//   out  (B, H, W, CO)   NHWC bytes
//
// An implicit GEMM: M = B*H*W output pixels, N = CO, K = ks*ks*CIN, with
// k = (ky*ks + kx)*CIN + ci. Row n of the kernel is then K contiguous
// values: the weights are a plain row-major (CO, K) matrix. A K chunk of 64
// lies inside one tap because CIN % 128 == 0, so a chunk of the A operand is,
// for each output pixel, 64 contiguous input channels of one tap; a tap
// outside the image (the SAME halo) reads zeros, so the input is never
// padded in memory.
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): a layer
// does 2*M FLOP per weight element it reads (one bf16 weight: M FLOP per
// byte). At batch 32 and 128, M >= 5408 and the tensor cores bound every
// 3x3 layer (the 1x1 layers at 26x26 and 52x52 move more bytes than they
// compute). At batch 1, M = 169 at 13x13, below the card's ridge (~295
// FLOP per byte): there the weights' bytes (up to 23.6 MB a layer) bound
// it, and the 52x52 layers stay compute-bound.
//
// bf16 design (conv_bf16_kernel):
//   * wgmma.mma_async m64nBNk16 from shared memory, fp32 accumulators in
//     registers for the whole K loop. BM = 64, 128 or 192 rows per block:
//     one warpgroup (128 threads) per 64 rows; BN = 128 or 256 columns.
//     The 192x256 tile (three warpgroups, at most 168 registers a thread)
//     reads 22% fewer operand bytes per MAC than 128x256 and gives YOLOv2's
//     13x13 layers at batch 32 one wave of 116 tiles instead of two of 172.
//   * K in chunks of BK = 64 bf16 (one 128-byte row of the 128B swizzle).
//     Both operands are K-major in that swizzled layout; a wgmma descriptor
//     walks the four k16 slices of a chunk by advancing its start address.
//   * A ring of STAGES chunks in dynamic shared memory, both tiles of a
//     chunk copied by TMA and completing on the stage's "full" mbarrier:
//     the weights as a (BN x 64) box of a SWIZZLE_128B tiled tensor map,
//     the activations in im2col mode (cuTensorMapEncodeIm2col): BM
//     consecutive output pixels, each at the chunk's tap of its window,
//     64 channels each, zeros outside the image. Both maps are
//     __grid_constant__ parameters.
//   * Thread 0 issues the copies STAGES - 2 chunks ahead of the chunk in
//     the tensor cores; the warpgroups run the chunk before it on
//     (wgmma.wait_group 1) and release a stage once its wgmma has finished,
//     one arrive per warp on the stage's "empty" mbarrier, which thread 0
//     waits on before it refills the stage. No block barrier per chunk.
//     (A separate producer warpgroup would leave the consumers 128
//     registers a thread at 512 threads: too few for 128 accumulators.)
//   * Split-K for small M (ops/cuda/conv_kernel.py::plan picks BM, BN and
//     the split so that tiles x splits fill the 132 SMs): split s of S takes
//     the K chunks [s*steps/S, (s+1)*steps/S) and writes its fp32 partial
//     tile to a workspace; conv_splitk_reduce_kernel then sums the partials
//     in split order (no atomics: the result is the same run to run) and
//     applies the epilogue. Without a split the epilogue runs on the
//     accumulators: + bias, leaky and the cast into a bf16 tile staged in
//     the idle ring, then 16-byte stores of whole tile rows; no fp32
//     activation reaches memory.
// fp32 design (conv_f32_kernel): true fp32 products (no TF32, as JAX's
// Precision.HIGHEST), a 64x64 tile per block, each thread a 4x4 block of
// FFMAs.
//
// The library is built with -fmad=false (the NMS kernel needs its IoU
// uncontracted). The fp32 path therefore spells its multiply-adds as
// __fmaf_rn; the epilogue's add and multiply stay separate roundings, as
// in the plain version. bf16 products are exact in fp32, and wgmma is not
// touched by the flag.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float act_fn(float v, int leaky) {
  return (leaky && !(v > 0.0f)) ? 0.1f * v : v;
}

// ---- bf16: wgmma on a TMA ring -----------------------------------------
constexpr int kBK = 64;          // K chunk: 64 bf16 = one 128-byte row
constexpr int kRowBytes = 128;   // a tile row of one chunk in shared memory

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the barrier's phase `parity` has completed. The spin stays
// in one asm block with no exit other than the barrier: a divergent exit
// (a timeout's trap) makes ptxas serialize the wgmma instructions.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// One TMA copy of the (box rows x 64) weight tile at (k0, n0) into `dst`,
// completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int k0, int n0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0), "r"(n0)
      : "memory");
}

// One TMA copy of the activation tile in im2col mode: BM pixels of 64
// channels from channel c, the pixels' windows starting at (x, y) of image
// n and running on in NHW order, each read at tap offset (ox, oy); a tap
// outside the image reads zeros.
__device__ __forceinline__ void tma_load_im2col(uint32_t dst,
                                                const CUtensorMap* map,
                                                uint32_t bar, int c, int x,
                                                int y, int n, int ox, int oy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier"
      "::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c),
      "r"(x), "r"(y), "r"(n), "h"(static_cast<uint16_t>(ox)),
      "h"(static_cast<uint16_t>(oy))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128B swizzle:
// rows of 128 bytes, groups of 8 rows 1024 bytes apart (SBO), the tile
// 1024-byte aligned. LBO is unused for this layout.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
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

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma fence or wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d += A (64 x 16, K-major, smem) * B (16 x BN, K-major, smem)
template <int BN>
struct Wgmma;

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
          ACC8(56)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(float (&d)[128], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
        "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
        "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
        "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
        "%127}, "
        "%128, %129, p, 1, 1, 0, 0;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
          ACC8(56), ACC8(64), ACC8(72), ACC8(80), ACC8(88), ACC8(96),
          ACC8(104), ACC8(112), ACC8(120)
        : "l"(a), "l"(b), "r"(1));
  }
};

#undef ACC8

// Shared memory of one block: the ring's A and B tiles and a full and an
// empty mbarrier per stage, plus slack to align the ring to 1024 bytes.
template <int BM, int BN, int STAGES>
constexpr int ring_bytes() {
  return STAGES * (BM + BN) * kRowBytes + STAGES * 16 + 1024;
}

template <int BM, int BN, int STAGES>
__global__ void __launch_bounds__(BM * 2)
conv_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                 int batch, int h, int w, int cin, int co, int ks, int leaky,
                 int splits) {
  static_assert(STAGES >= 3, "the ring runs STAGES - 2 chunks ahead");
  constexpr int kA = BM * kRowBytes, kB = BN * kRowBytes;  // stage bytes
  constexpr int kAhead = STAGES - 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_a = base, s_b = base + STAGES * kA;
  const uint32_t s_full = s_b + STAGES * kB, s_empty = s_full + 8 * STAGES;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;  // warpgroup, thread in it
  const long long m_total = (long long)batch * h * w;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int steps = ks * ks * cin / kBK;
  const int split = blockIdx.z;
  const int step0 = static_cast<int>((long long)split * steps / splits);
  const int n_steps =
      static_cast<int>((long long)(split + 1) * steps / splits) - step0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(s_full + 8 * s, 1);
      mbar_init(s_empty + 8 * s, BM / 16);  // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 copies K chunk step0 + i into stage i % STAGES, both tiles by
  // TMA: the activations in im2col mode (BM pixels of 64 channels from the
  // tile's first pixel's window corner, at the chunk's tap), the weights as
  // a (BN x 64) box
  const int pad = ks >> 1;
  const int px = static_cast<int>(m0 % w) - pad;
  const int py = static_cast<int>((m0 / w) % h) - pad;
  const int pn = static_cast<int>(m0 / ((long long)w * h));
  auto load = [&](int i) {
    const int s = i % STAGES;
    if (i >= STAGES) mbar_wait(s_empty + 8 * s, ((i / STAGES) - 1) & 1);
    const int k0 = (step0 + i) * kBK;
    const int tap = k0 / cin;
    const uint32_t bar = s_full + 8 * s;
    mbar_expect_tx(bar, kA + kB);
    tma_load_im2col(s_a + s * kA, &xmap, bar, k0 - tap * cin, px, py, pn,
                    tap % ks, tap / ks);
    tma_load_2d(s_b + s * kB, &wmap, bar, k0, n0);
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  if (tid == 0)
    for (int i = 0; i < kAhead && i < n_steps; ++i) load(i);
  // the zeros are in place before the first wgmma; a fence inside the loop
  // would make ptxas serialize the wgmmas (it reads as a write of the
  // accumulators while one is in flight)
  fence_acc(acc);
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % STAGES;
    // chunk i + kAhead goes to the stage of chunk i - 2, which every warp
    // has released (below) once its wgmma of that chunk finished. The copy
    // is issued before this chunk's wgmma: no divergent code may sit
    // between a wgmma and its wait, or ptxas serializes them
    if (tid == 0 && i + kAhead < n_steps) load(i + kAhead);
    mbar_wait(s_full + 8 * s, (i / STAGES) & 1);  // both tiles landed
    const uint64_t da = wgmma_desc(s_a + s * kA + wg * 64 * kRowBytes);
    const uint64_t db = wgmma_desc(s_b + s * kB);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // k16 slice: +32 bytes
      Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();  // chunk i may still run; chunk i - 1 has finished
    if (i > 0 && (t & 31) == 0) mbar_arrive(s_empty + 8 * ((i - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // accumulator layout of wgmma m64nN: warp q of the warpgroup holds rows
  // 16q + lane/4 (+8), columns 8j + 2*(lane%4) (+1) in acc[4j .. 4j+3]
  const int warp = t >> 5, lane = t & 31;
  const int tile_row = wg * 64 + warp * 16 + (lane >> 2);
  const int tile_col = 2 * (lane & 3);
  if (splits > 1) {  // the fp32 partial tile, for the reduction
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + tile_row + 8 * half;
        if (m >= m_total) continue;
        *reinterpret_cast<float2*>(ws + (split * m_total + m) * co + n0 +
                                   tile_col + 8 * j) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
    return;
  }
  // + bias, leaky, cast into a bf16 tile staged in the idle ring (rows
  // padded by 16 bytes, so the pair stores of a warp hit 32 banks), then
  // 16-byte stores of whole rows
  constexpr int kOutLd = BN * 2 + 16;  // bytes per staged row
  uint8_t* staged = smem_raw + (base - smem_addr(smem_raw));
  __syncthreads();  // every warpgroup's wgmma has stopped reading the ring
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = tile_col + 8 * j;
    const float b0 = bias[n0 + n], b1 = bias[n0 + n + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = tile_row + 8 * half;
      *reinterpret_cast<__nv_bfloat162*>(staged + r * kOutLd + n * 2) =
          __floats2bfloat162_rn(act_fn(acc[4 * j + 2 * half] + b0, leaky),
                                act_fn(acc[4 * j + 2 * half + 1] + b1, leaky));
    }
  }
  __syncthreads();
  constexpr int kRowChunks = BN * 2 / 16;  // 16-byte chunks of a tile row
  for (int c = tid; c < BM * kRowChunks; c += BM * 2) {
    const int r = c / kRowChunks, q = c % kRowChunks;
    const long long m = m0 + r;
    if (m < m_total)
      *reinterpret_cast<uint4*>(out + m * co + n0 + q * 8) =
          *reinterpret_cast<const uint4*>(staged + r * kOutLd + q * 16);
  }
}

// out = act(sum over s in order of ws[s] + bias), 4 channels per thread
__global__ void __launch_bounds__(kThreads)
conv_splitk_reduce_kernel(const float* __restrict__ ws,
                          const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out, long long mn,
                          int co, int splits, int leaky) {
  const long long stride = (long long)gridDim.x * blockDim.x * 4;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       i < mn; i += stride) {
    float4 v = *reinterpret_cast<const float4*>(ws + i);
    for (int s = 1; s < splits; ++s) {
      const float4 p = *reinterpret_cast<const float4*>(ws + s * mn + i);
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    const float4 b = *reinterpret_cast<const float4*>(bias + i % co);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(act_fn(v.x + b.x, leaky),
                                                    act_fn(v.y + b.y, leaky));
    const __nv_bfloat162 hi = __floats2bfloat162_rn(act_fn(v.z + b.z, leaky),
                                                    act_fn(v.w + b.w, leaky));
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&lo);
    packed.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + i) = packed;
  }
}

// ---- fp32: FFMA --------------------------------------------------------
constexpr int kFM = 64, kFN = 64, kFK = 16;
constexpr int kFLd = kFM + 4;  // 272-byte rows keep float4 reads aligned

__global__ void __launch_bounds__(kThreads)
conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                const float* __restrict__ bias, float* __restrict__ out,
                int batch, int h, int w, int cin, int co, int ks, int leaky) {
  __shared__ __align__(16) float s_a[kFK][kFLd];  // [k][m]
  __shared__ __align__(16) float s_b[kFK][kFLd];  // [k][n]

  const int tid = threadIdx.x;
  const long long m_total = (long long)batch * h * w;
  const long long m0 = (long long)blockIdx.x * kFM;
  const int n0 = blockIdx.y * kFN;
  const int pad = ks >> 1;
  const int k_total = ks * ks * cin;

  // loader: tile row `row`, 4 consecutive k at kc
  const int row = tid >> 2, kc = (tid & 3) * 4;
  const long long m = m0 + row;
  const bool m_ok = m < m_total;
  const long long mm = m_ok ? m : 0;
  const int ax = static_cast<int>(mm % w);
  const int ay = static_cast<int>((mm / w) % h);
  const int ab = static_cast<int>(mm / ((long long)w * h));
  const float* b_row = wt + (size_t)(n0 + row) * k_total + kc;

  // compute: a 4x4 block of outputs, rows ty*4.., columns tx*4..
  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k_total; k0 += kFK) {
    const int tap = k0 / cin;
    const int ci0 = k0 - tap * cin;
    const int iy = ay + tap / ks - pad, ix = ax + tap % ks - pad;
    float4 av = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (m_ok && iy >= 0 && iy < h && ix >= 0 && ix < w)
      av = *reinterpret_cast<const float4*>(
          x + (((size_t)ab * h + iy) * w + ix) * cin + ci0 + kc);
    const float4 bv = *reinterpret_cast<const float4*>(b_row + k0);
    __syncthreads();  // the previous tile has been consumed
    s_a[kc + 0][row] = av.x;
    s_a[kc + 1][row] = av.y;
    s_a[kc + 2][row] = av.z;
    s_a[kc + 3][row] = av.w;
    s_b[kc + 0][row] = bv.x;
    s_b[kc + 1][row] = bv.y;
    s_b[kc + 2][row] = bv.z;
    s_b[kc + 3][row] = bv.w;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&s_a[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&s_b[kk][tx * 4]);
      const float ar[4] = {a.x, a.y, a.z, a.w};
      const float br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fmaf_rn(ar[i], br[j], acc[i][j]);
    }
  }

  const int n = n0 + tx * 4;
  const float4 bb = *reinterpret_cast<const float4*>(bias + n);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long mo = m0 + ty * 4 + i;
    if (mo < m_total) {
      float4 v;
      v.x = act_fn(acc[i][0] + bb.x, leaky);
      v.y = act_fn(acc[i][1] + bb.y, leaky);
      v.z = act_fn(acc[i][2] + bb.z, leaky);
      v.w = act_fn(acc[i][3] + bb.w, leaky);
      *reinterpret_cast<float4*>(out + mo * co + n) = v;
    }
  }
}

// ---- host ---------------------------------------------------------------
// Errors of yolo_conv_bias_act besides CUDA's own codes.
constexpr int kErrPlan = -1;        // a plan the kernels were not built for
constexpr int kErrEntryPoint = -2;  // no tensor-map encoder in the driver
constexpr int kErrTensorMap = -3;   // the driver refused a tensor map

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);
typedef CUresult (*EncodeIm2colFn)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const int*, const int*,
                                   cuuint32_t, cuuint32_t, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// The tensor-map encoders live in the driver library; the runtime hands
// out their addresses, so the library needs no -lcuda.
void* driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t err =
      cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
  return (err == cudaSuccess && q == cudaDriverEntryPointSuccess) ? p
                                                                  : nullptr;
}

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn =
      reinterpret_cast<EncodeTiledFn>(driver_entry("cuTensorMapEncodeTiled"));
  return fn;
}

EncodeIm2colFn encode_im2col() {
  static const EncodeIm2colFn fn = reinterpret_cast<EncodeIm2colFn>(
      driver_entry("cuTensorMapEncodeIm2col"));
  return fn;
}

template <int BM, int BN, int STAGES>
int launch_bf16(const void* x, const void* w, const void* bias, void* out,
                void* ws, int batch, int h, int width, int cin, int co,
                int ks, int leaky, int splits, cudaStream_t st) {
  constexpr int kSmem = ring_bytes<BM, BN, STAGES>();
  auto kernel = conv_bf16_kernel<BM, BN, STAGES>;
  // above 48 KB of dynamic shared memory only on request: once per device
  static std::atomic<unsigned long long> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return kErrPlan;
  if (!((allowed.load() >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed.fetch_or(1ull << dev);
  }

  const EncodeTiledFn tiled = encode_tiled();
  const EncodeIm2colFn im2col = encode_im2col();
  if (tiled == nullptr || im2col == nullptr) return kErrEntryPoint;
  // weights: a row-major (CO, K) matrix, a (BN x 64) box per chunk
  const int k_total = ks * ks * cin;
  CUtensorMap wmap;
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(k_total),
                               static_cast<cuuint64_t>(co)};
  const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(k_total) * 2};
  const cuuint32_t wbox[2] = {kBK, BN};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (tiled(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
            wdims, wstrides, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return kErrTensorMap;
  // activations: NHWC in im2col mode, BM pixels x 64 channels per chunk.
  // A pixel's window corner runs over [-pad, W - 1 - pad] (the bounding
  // box's corners: -pad from the top left, pad - (ks - 1) from the bottom
  // right), and a tap outside the image reads zeros
  CUtensorMap xmap;
  const cuuint64_t xdims[4] = {
      static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(width),
      static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(batch)};
  const cuuint64_t xstrides[3] = {
      static_cast<cuuint64_t>(cin) * 2,
      static_cast<cuuint64_t>(cin) * 2 * width,
      static_cast<cuuint64_t>(cin) * 2 * width * h};
  const int pad = ks / 2;
  const int lower[2] = {-pad, -pad};
  const int upper[2] = {pad - (ks - 1), pad - (ks - 1)};
  if (im2col(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(x), xdims, xstrides, lower, upper, kBK, BM,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return kErrTensorMap;

  const long long m_total = (long long)batch * h * width;
  const dim3 grid(static_cast<unsigned>((m_total + BM - 1) / BM), co / BN,
                  splits);
  kernel<<<grid, BM * 2, kSmem, st>>>(
      xmap, wmap, static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), batch, h,
      width, cin, co, ks, leaky, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long mn = m_total * co;
  const long long want = (mn / 4 + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < 4096 ? want : 4096);
  conv_splitk_reduce_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), mn, co, splits, leaky);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or a
// negative code of its own (kErrPlan, kErrEntryPoint, kErrTensorMap). The
// caller checks the shapes (CIN % 128 == 0, CO % 128 == 0, ks in {1, 3},
// batch * h * w >= 1), the dtypes, the layouts and 16-byte alignment, and
// allocates `out`. bf16 != 0: x, w and out are bf16; else fp32.
// The plan (ops/cuda/conv_kernel.py::plan) is checked here: bf16 takes
// (bm, bn) = (192, 256), (128, 256), (128, 128) or (64, 128) with
// co % bn == 0 and 1 <= splits <= ks*ks*cin/64, and with splits > 1 a
// workspace of splits * batch*h*w * co floats; fp32 takes (64, 64) and 1
// split.
extern "C" int yolo_conv_bias_act(const void* x, const void* w,
                                  const void* bias, void* out, void* ws,
                                  int batch, int h, int width, int cin, int co,
                                  int ks, int leaky, int bf16, int bm, int bn,
                                  int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16) {
    if (bm != kFM || bn != kFN || splits != 1) return kErrPlan;
    const long long m_total = (long long)batch * h * width;
    const dim3 grid(static_cast<unsigned>((m_total + kFM - 1) / kFM),
                    co / kFN);
    conv_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), batch, h,
        width, cin, co, ks, leaky);
    return static_cast<int>(cudaGetLastError());
  }
  const int steps = ks * ks * cin / kBK;
  if (bn <= 0 || co % bn != 0 || splits < 1 || splits > steps ||
      (splits > 1 && ws == nullptr))
    return kErrPlan;
  // each ring fills most of the 227 KB a block may use: 230,464 bytes at
  // 192x256, 197,696 at 128x256, 197,728 at 128x128, and 99,392 at 64x128
  // (two blocks per SM)
  if (bm == 192 && bn == 256)
    return launch_bf16<192, 256, 4>(x, w, bias, out, ws, batch, h, width, cin,
                                    co, ks, leaky, splits, st);
  if (bm == 128 && bn == 256)
    return launch_bf16<128, 256, 4>(x, w, bias, out, ws, batch, h, width, cin,
                                    co, ks, leaky, splits, st);
  if (bm == 128 && bn == 128)
    return launch_bf16<128, 128, 6>(x, w, bias, out, ws, batch, h, width, cin,
                                    co, ks, leaky, splits, st);
  if (bm == 64 && bn == 128)
    return launch_bf16<64, 128, 4>(x, w, bias, out, ws, batch, h, width, cin,
                                   co, ks, leaky, splits, st);
  return kErrPlan;
}
