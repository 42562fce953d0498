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
// Precision.HIGHEST) on the CUDA cores, whose FFMA peak (67 TFLOP/s) bounds
// every YOLOv2-COCO layer even at batch 1 (fp32's ridge is ~20 FLOP per
// byte; a batch-1 13x13 layer does 84 FLOP per weight byte).
//   * The same TMA ring as the bf16 body (im2col activations, tiled
//     weights, full/empty mbarriers per stage, thread 0 issuing the copies
//     STAGES - 2 chunks ahead, no block barrier per chunk), with K chunks
//     of 32 fp32: one 128-byte row of the 128B swizzle, inside one tap.
//   * A register tile that outruns shared memory: an 8x8 block of FFMA
//     accumulators per thread fed by 16-byte float4 reads along k (16
//     FFMAs per LDS.128, free of bank conflicts in the swizzle), on
//     128x128 tiles (256 threads) or 64x128 tiles (128 threads, three
//     blocks and 12 warps per SM: the extra warps hide the shared-memory
//     latency that two warps per scheduler leave exposed).
//   * Split-K for small M, through the same plan and the same in-order
//     reduction (fp32 output), and an epilogue staged in the idle ring
//     with 16-byte row stores.
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
#include <type_traits>

#include "tma_ring.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float act_fn(float v, int leaky) {
  return (leaky && !(v > 0.0f)) ? 0.1f * v : v;
}

// ---- bf16: wgmma on a TMA ring -----------------------------------------
constexpr int kBK = 64;          // K chunk: 64 bf16 = one 128-byte row

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

// four activated outputs, stored in the output's dtype
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<const uint32_t*>(&lo);
  packed.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = packed;
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// out = act(sum over s in order of ws[s] + bias), 4 channels per thread
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_splitk_reduce_kernel(const float* __restrict__ ws,
                          const float* __restrict__ bias,
                          T* __restrict__ out, long long mn, int co,
                          int splits, int leaky) {
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
    store4(out + i, make_float4(act_fn(v.x + b.x, leaky),
                                act_fn(v.y + b.y, leaky),
                                act_fn(v.z + b.z, leaky),
                                act_fn(v.w + b.w, leaky)));
  }
}

// ---- fp32: FFMA on a TMA ring ------------------------------------------
constexpr int kFBK = 32;  // K chunk: 32 fp32 = one 128-byte row

// 16 bytes of shared memory, issued where the source puts it
__device__ __forceinline__ void lds4(float (&v)[4], uint32_t addr) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(addr));
}

// BM x BN outputs per block of (BM / 8) * (BN / 8) threads, an 8x8 block
// of FFMA accumulators per thread. A warp is 8 thread rows (tm) by 4
// thread columns (tn); thread (tm, tn) owns tile rows tm + (BM / 8) * i
// and columns tn + (BN / 8) * j, i, j < 8. Each step of 4 k reads, per
// thread, 8 float4 of A and 8 of B along k (16 LDS.128 for 256 FFMA):
// in the 128B swizzle, row r's 16-byte group q lies at group q ^ (r % 8),
// so the 8 rows of a warp's A read fall on 8 distinct bank groups (the
// four quarter-warps read the same 8: a broadcast), and its 4 B rows on
// 4. Every row of a thread has the same r % 8, so one XOR per step
// serves all 16 reads.
template <int BM, int BN, int STAGES>
__global__ void __launch_bounds__((BM / 8) * (BN / 8), BM == 64 ? 3 : 1)
conv_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap,
                const float* __restrict__ bias, float* __restrict__ out,
                float* __restrict__ ws, int batch, int h, int w, int cin,
                int co, int ks, int leaky, int splits) {
  constexpr int kTM = BM / 8, kTN = BN / 8;  // the thread grid
  constexpr int kBlock = kTM * kTN;
  constexpr int kWarpsM = kTM / 8;
  static_assert(kTM % 8 == 0 && kTN % 8 == 0 && kBlock % 32 == 0,
                "warps of 8x4 threads, rows with one swizzle phase");
  static_assert(STAGES >= 3, "the ring runs STAGES - 2 chunks ahead");
  constexpr int kA = BM * kRowBytes, kB = BN * kRowBytes;  // stage bytes
  constexpr int kAhead = STAGES - 2;
  constexpr int kQ = kFBK / 4;  // 4-deep k steps of a chunk
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  uint8_t* const ring = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t s_a = base, s_b = base + STAGES * kA;
  const uint32_t s_full = s_b + STAGES * kB, s_empty = s_full + 8 * STAGES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long long m_total = (long long)batch * h * w;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int steps = ks * ks * cin / kFBK;
  const int split = blockIdx.z;
  const int step0 = static_cast<int>((long long)split * steps / splits);
  const int n_steps =
      static_cast<int>((long long)(split + 1) * steps / splits) - step0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(s_full + 8 * s, 1);
      mbar_init(s_empty + 8 * s, kBlock / 32);  // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 copies K chunk step0 + i into stage i % STAGES, as the bf16
  // body does: BM pixels of 32 channels in im2col mode, a (BN x 32) box
  // of the weights. A chunk's activations are the pixels' channels
  // of a 32-channel run of one tap (ci, tx, ty); thread 0 issues the
  // chunks in order and steps that position along, with no division
  const int pad = ks >> 1;
  const int px = static_cast<int>(m0 % w) - pad;
  const int py = static_cast<int>((m0 / w) % h) - pad;
  const int pn = static_cast<int>(m0 / ((long long)w * h));
  const int tap0 = step0 * kFBK / cin;
  int ci = step0 * kFBK - tap0 * cin, tx = tap0 % ks, ty = tap0 / ks;
  auto load = [&](int i) {
    const int s = i % STAGES;
    if (i >= STAGES) mbar_wait(s_empty + 8 * s, ((i / STAGES) - 1) & 1);
    const uint32_t bar = s_full + 8 * s;
    mbar_expect_tx(bar, kA + kB);
    tma_load_im2col(s_a + s * kA, &xmap, bar, ci, px, py, pn, tx, ty);
    tma_load_2d(s_b + s * kB, &wmap, bar, (step0 + i) * kFBK, n0);
    ci += kFBK;
    if (ci == cin) {
      ci = 0;
      if (++tx == ks) {
        tx = 0;
        ++ty;
      }
    }
  };

  // the fragments of one 4-deep k step: the thread's 8 A rows and 8 B
  // rows, a float4 along k each, at the step's swizzled 16-byte group
  const int tm = (warp % kWarpsM) * 8 + (lane & 7);
  const int tn = (warp / kWarpsM) * 4 + (lane >> 3);
  const uint32_t a_row = s_a + tm * kRowBytes, b_row = s_b + tn * kRowBytes;
  auto fetch = [&](float (&fa)[8][4], float (&fb)[8][4], int stage, int q) {
    const uint32_t a = a_row + stage * kA + ((q ^ (tm & 7)) << 4);
    const uint32_t b = b_row + stage * kB + ((q ^ (tn & 7)) << 4);
#pragma unroll
    for (int r = 0; r < 8; ++r) lds4(fa[r], a + r * kTM * kRowBytes);
#pragma unroll
    for (int c = 0; c < 8; ++c) lds4(fb[c], b + c * kTN * kRowBytes);
  };
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
  auto ffma = [&](const float (&fa)[8][4], const float (&fb)[8][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[r][c] = __fmaf_rn(fa[r][kk], fb[c][kk], acc[r][c]);
  };

  if (tid == 0)
    for (int i = 0; i < kAhead && i < n_steps; ++i) load(i);
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % STAGES;
    // chunk i + kAhead goes to the stage of chunk i - 2, which every warp
    // has released (below)
    if (tid == 0 && i + kAhead < n_steps) load(i + kAhead);
    mbar_wait(s_full + 8 * s, (i / STAGES) & 1);  // both tiles landed
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      float fa[8][4], fb[8][4];
      fetch(fa, fb, s, q);
      ffma(fa, fb);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(s_empty + 8 * s);  // this warp read stage s
  }

  // the tile staged in the idle ring (rows padded by 16 bytes: a warp's
  // scalar stores hit 32 banks), then 16-byte stores of whole rows: the
  // fp32 partial tile for the reduction, or + bias and leaky
  constexpr int kOutLd = BN + 4;  // floats per staged row
  float* staged = reinterpret_cast<float*>(ring);
  __syncthreads();  // every warp has stopped reading the ring
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      staged[(tm + r * kTM) * kOutLd + tn + c * kTN] = acc[r][c];
  __syncthreads();
  constexpr int kRowVecs = BN / 4;  // float4s of a tile row
  for (int v = tid; v < BM * kRowVecs; v += kBlock) {
    const int r = v / kRowVecs, q = v % kRowVecs;
    const long long m = m0 + r;
    if (m >= m_total) break;  // rows only grow with v
    float4 o = *reinterpret_cast<const float4*>(staged + r * kOutLd + q * 4);
    if (splits > 1) {
      store4(ws + (split * m_total + m) * co + n0 + q * 4, o);
    } else {
      const float4 b = *reinterpret_cast<const float4*>(bias + n0 + q * 4);
      o.x = act_fn(o.x + b.x, leaky);
      o.y = act_fn(o.y + b.y, leaky);
      o.z = act_fn(o.z + b.z, leaky);
      o.w = act_fn(o.w + b.w, leaky);
      store4(out + m * co + n0 + q * 4, o);
    }
  }
}

// ---- host ---------------------------------------------------------------

// The two tensor maps of a call in element type T, K chunks of one
// 128-byte row (64 bf16 or 32 fp32) in the 128B swizzle: the weights as a
// row-major (CO, K) matrix, a (BN x chunk) box each; the activations,
// NHWC, in im2col mode, BM pixels x chunk channels each. A pixel's window
// corner runs over [-pad, W - 1 - pad] (the bounding box's corners: -pad
// from the top left, pad - (ks - 1) from the bottom right), and a tap
// outside the image reads zeros.
template <typename T>
int encode_maps(CUtensorMap* xmap, CUtensorMap* wmap, const void* x,
                const void* w, int bm, int bn, int batch, int h, int width,
                int cin, int co, int ks) {
  return encode_conv_maps(xmap, wmap, x, w,
                          std::is_same<T, float>::value
                              ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          sizeof(T), bm, bn, batch, h, width, cin, co, ks);
}

// The conv kernel of an output type.
template <int BM, int BN, int STAGES>
auto body(__nv_bfloat16*) {
  return conv_bf16_kernel<BM, BN, STAGES>;
}

template <int BM, int BN, int STAGES>
auto body(float*) {
  return conv_f32_kernel<BM, BN, STAGES>;
}

// One conv in element type T (bf16: conv_bf16_kernel, fp32:
// conv_f32_kernel) on BM x BN tiles, then, with splits > 1, the reduction
// of the partial sums into T.
template <typename T, int BM, int BN, int STAGES>
int launch(const void* x, const void* w, const void* bias, void* out,
           void* ws, int batch, int h, int width, int cin, int co, int ks,
           int leaky, int splits, cudaStream_t st) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kSmem = ring_bytes<BM, BN, STAGES>();
  constexpr int kBlock = kF32 ? (BM / 8) * (BN / 8) : BM * 2;
  const auto kernel = body<BM, BN, STAGES>(static_cast<T*>(nullptr));
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
  CUtensorMap xmap, wmap;
  const int bad = encode_maps<T>(&xmap, &wmap, x, w, BM, BN, batch, h, width,
                                 cin, co, ks);
  if (bad != 0) return bad;

  const long long m_total = (long long)batch * h * width;
  const dim3 grid(static_cast<unsigned>((m_total + BM - 1) / BM), co / BN,
                  splits);
  kernel<<<grid, kBlock, kSmem, st>>>(
      xmap, wmap, static_cast<const float*>(bias), static_cast<T*>(out),
      static_cast<float*>(ws), batch, h, width, cin, co, ks, leaky, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long mn = m_total * co;
  const long long want = (mn / 4 + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < 4096 ? want : 4096);
  conv_splitk_reduce_kernel<T><<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<T*>(out), mn, co, splits, leaky);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or a
// negative code of its own (kErrPlan, kErrEntryPoint, kErrTensorMap). The
// caller checks the shapes (CIN % 128 == 0, CO % 128 == 0, ks in {1, 3},
// batch * h * w >= 1), the dtypes, the layouts and 16-byte alignment, and
// allocates `out`. bf16 != 0: x, w and out are bf16; else fp32.
// The plan (ops/cuda/conv_kernel.py::plan) is checked here: bf16 takes
// (bm, bn) = (192, 256), (128, 256), (128, 128) or (64, 128), fp32 takes
// (128, 128) or (64, 128); both with co % bn == 0 and 1 <= splits <= the
// K chunks (ks*ks*cin/64 in bf16, /32 in fp32), and with splits > 1 a
// workspace of splits * batch*h*w * co floats.
extern "C" int yolo_conv_bias_act(const void* x, const void* w,
                                  const void* bias, void* out, void* ws,
                                  int batch, int h, int width, int cin, int co,
                                  int ks, int leaky, int bf16, int bm, int bn,
                                  int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int steps = ks * ks * cin / (bf16 ? kBK : kFBK);
  if (bn <= 0 || co % bn != 0 || splits < 1 || splits > steps ||
      (splits > 1 && ws == nullptr))
    return kErrPlan;
  if (!bf16) {
    // 132,160 bytes of ring (4 stages) at 128x128: one block per SM, held
    // there by its registers (184 a thread); 74,800 (3 stages) at 64x128:
    // three blocks per SM, 12 warps, at most 168 registers a thread
    if (bm == 128 && bn == 128)
      return launch<float, 128, 128, 4>(x, w, bias, out, ws, batch, h, width,
                                        cin, co, ks, leaky, splits, st);
    if (bm == 64 && bn == 128)
      return launch<float, 64, 128, 3>(x, w, bias, out, ws, batch, h, width,
                                       cin, co, ks, leaky, splits, st);
    return kErrPlan;
  }
  // each ring fills most of the 227 KB a block may use: 230,464 bytes at
  // 192x256, 197,696 at 128x256, 197,728 at 128x128, and 99,392 at 64x128
  // (two blocks per SM)
  using bf = __nv_bfloat16;
  if (bm == 192 && bn == 256)
    return launch<bf, 192, 256, 4>(x, w, bias, out, ws, batch, h, width, cin,
                                   co, ks, leaky, splits, st);
  if (bm == 128 && bn == 256)
    return launch<bf, 128, 256, 4>(x, w, bias, out, ws, batch, h, width, cin,
                                   co, ks, leaky, splits, st);
  if (bm == 128 && bn == 128)
    return launch<bf, 128, 128, 6>(x, w, bias, out, ws, batch, h, width, cin,
                                   co, ks, leaky, splits, st);
  if (bm == 64 && bn == 128)
    return launch<bf, 64, 128, 4>(x, w, bias, out, ws, batch, h, width, cin,
                                  co, ks, leaky, splits, st);
  return kErrPlan;
}
