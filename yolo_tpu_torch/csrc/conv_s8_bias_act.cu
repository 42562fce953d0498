// int8 conv + dequantize + bias + activation, then requantize or cast, for
// Hopper (sm_90a).
//
// Replaces the int8 x int8 -> int32 conv of the JAX package's int8
// post-training quantization, yolo_tpu/models/quantize.py:234
// (lax.conv_general_dilated with preferred_element_type=int32 inside
// conv_block_int8): an XLA op there, with no Pallas kernel. Plain version:
// yolo_tpu_torch/ops/conv_s8.py::conv_s8_bias_act.
//
// Layouts (the Darknet executor's channels_last tensors, read in place):
//   x     (B, H, W, CIN)            int8 NHWC bytes
//   w     (CO, ks, ks, CIN/groups)  int8: an OIHW channels_last kernel
//   scale (CO,) fp32                x_scale * w_scale, formed by the caller
//   bias  (CO,) fp32
//   out   (B, H', W', CO)           int8, bf16 or fp32 NHWC bytes
// Any kernel size, stride, dilation and groups; darknet padding
// (ks / 2) * dilation; zeros outside the image.
//
// An implicit GEMM per group g: M = B*H'*W' output pixels, N = CO/groups,
// K = ks*ks*CIN/groups with k = (ky*ks + kx)*cin_g + ci, so that row n of
// the kernel is K contiguous bytes (K-major), as is each pixel's window
// tap in NHWC. The int32 sums are exact, so any order of summation gives
// the plain version's sums; the epilogue then repeats its fp32 arithmetic
// operation by operation (no contraction: the library is built
// -fmad=false, and the operations are spelled __fmul_rn / __fadd_rn /
// __fdiv_rn): __int2float_rn(acc) * scale[oc] + bias[oc], the activation
// (leaky, linear, relu, ramp exactly; mish, logistic and swish through
// expf / log1pf / tanhf, within an ulp or two of PyTorch's), then
// rintf(y / out_scale) (round half to even) clipped to [-127, 127], or
// __float2bfloat16_rn(y), or y.
//
// Three bodies, chosen by the wrapper (ops/cuda/conv_s8_kernel.py::plan):
//   * wgmma (stride 1, dilation 1, groups 1, CIN a multiple of 128, CO of
//     64: 20 of YOLOv2-COCO's 23 convs): conv_bias_act.cu's bf16 TMA ring
//     in int8 (tma_ring.cuh). K chunks of 128 bytes, one tap's 128
//     channels, are one row of the 128B swizzle, so the tiled weight box,
//     the im2col activation box (zeros outside the image, past the batch)
//     and the wgmma descriptors are that kernel's; a chunk is four
//     m64nBNk32 s8 wgmmas into int32 accumulators, two warpgroups of 64
//     rows, thread 0 issuing the copies one stage ahead of the tensor
//     cores. 128 x 64 tiles on a three-stage ring run three blocks an SM,
//     128 x 128 two: one block's fill and epilogue overlap another's K
//     loop. The epilogue stages the tile in the output's type in the idle
//     ring and stores whole rows 16 bytes at a time.
//   * mma (the other CIN/groups multiple of 32: convs 1-2 of YOLOv2-COCO,
//     with 32 and 64 channels, and the 425-filter head): mma.sync
//     m16n8k32 s8. A block of 8 warps covers BM pixels x 64 channels
//     (BM 128 or 64); K runs in chunks of 32 bytes, one tap's
//     32 channels, so a chunk of a pixel is two 16-byte copies. A 4-stage
//     cp.async ring (zero-fill outside the image and past M and N) keeps
//     three chunks in flight; fragments come from shared memory by
//     ldmatrix (rows padded to 48 bytes: conflict-free); the epilogue runs
//     on the accumulators in registers.
//   * dp4a (conv 0's CIN = 3, narrow groups): one thread per output
//     pixel and NPT channels; the block's weights staged in shared memory
//     as packed words in chunks of K, the pixel's window gathered four
//     bytes at a time (zeros outside the image and past K), __dp4a into
//     NPT int32 sums, stored as 16-byte vectors where the channels allow.
//
// What bounds it on an H100 (1979 TOPS int8 dense, 3.35 TB/s): the larger
// of 2*M*N*K operations at the int8 tensor rate and the bytes each input
// read once and the output written once. At batch 32 the 3x3 layers of
// YOLOv2-COCO are operation-bound (conv 0 and the 1x1 layers byte-bound);
// at batch 1 every layer is byte-bound (its weights). The wgmma body's
// 3x3 convs reach 10-51% of the int8 tensor rate at batch 32-128
// (tools/port_perf.py tiles_s8); conv 0 on the dp4a body lies further
// from its bound (ROADMAP B6).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tma_ring.cuh"

namespace {

enum Act { kLinear = 0, kLeaky, kMish, kLogistic, kSwish, kRelu, kRamp };
enum OutKind { kOutS8 = 0, kOutBf16, kOutF32 };

struct ConvS8Args {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* bias;
  void* out;
  float out_scale;
  int batch, h, w_, cin, co, ks, stride, dil, groups, pad, ho, wo;
  int cin_g, co_g, k;  // k = ks * ks * cin_g
  long long m;         // batch * ho * wo
  int act, out_kind;
};

__device__ __forceinline__ float sigmoid(float v) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kLeaky:
      return v > 0.0f ? v : __fmul_rn(v, 0.1f);
    case kMish: {
      // F.softplus (threshold 20), then x * tanh
      const float sp = v > 20.0f ? v : log1pf(expf(v));
      return __fmul_rn(v, tanhf(sp));
    }
    case kLogistic:
      return sigmoid(v);
    case kSwish:
      return __fmul_rn(v, sigmoid(v));
    case kRelu:
      return fmaxf(v, 0.0f);
    case kRamp:
      return __fadd_rn(fmaxf(v, 0.0f), __fmul_rn(0.1f, v));
    default:
      return v;
  }
}

// The activated fp32 value of an int32 sum: acc * scale + bias, activated.
__device__ __forceinline__ float dequant_act(int32_t acc, float scale,
                                             float bias, int act) {
  return activate(__fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias),
                  act);
}

__device__ __forceinline__ float dequant_act(const ConvS8Args& a, int oc,
                                             int32_t acc) {
  return dequant_act(acc, __ldg(a.scale + oc), __ldg(a.bias + oc), a.act);
}

// The value in the output's type: int8 codes at out_scale, bf16 or fp32.
__device__ __forceinline__ int8_t to_out(float v, float out_scale, int8_t*) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, out_scale)), -127.0f),
                        127.0f);
  return static_cast<int8_t>(__float2int_rn(q));
}

__device__ __forceinline__ __nv_bfloat16 to_out(float v, float,
                                                __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float to_out(float v, float, float*) { return v; }

// out[idx] from the int32 sum of output channel oc.
__device__ __forceinline__ void store_out(const ConvS8Args& a, long long idx,
                                          int oc, int32_t acc) {
  const float v = dequant_act(a, oc, acc);
  if (a.out_kind == kOutS8) {
    int8_t* out = static_cast<int8_t*>(a.out);
    out[idx] = to_out(v, a.out_scale, out);
  } else if (a.out_kind == kOutBf16) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
    out[idx] = to_out(v, a.out_scale, out);
  } else {
    static_cast<float*>(a.out)[idx] = v;
  }
}

// ---- mma body ------------------------------------------------------------
constexpr int kChunk = 32;    // K chunk: one tap, 32 channels (bytes)
constexpr int kRow = 48;      // shared row: the chunk + 16 bytes of padding
constexpr int kStages = 4;
constexpr int kMmaThreads = 256;

// 16 bytes global -> shared; zeros when !valid (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int32_t* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BM, int BN>
constexpr int mma_smem_bytes() {
  return kStages * (BM + BN) * kRow;
}

// BM x BN tile of group blockIdx.z; WM x WN warps, each a (BM/WM) x (BN/WN)
// warp tile of m16n8 mma tiles.
template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(kMmaThreads)
    conv_s8_mma_kernel(const ConvS8Args a) {
  static_assert(WM * WN == kMmaThreads / 32, "8 warps");
  constexpr int TM = BM / WM, TN = BN / WN;
  constexpr int MT = TM / 16, NT = TN / 8;
  static_assert(MT >= 1 && NT >= 2 && NT % 2 == 0, "warp tile");
  constexpr int A_COPIES = BM * 2, B_COPIES = BN * 2;  // 16-byte copies
  constexpr int A_ITERS = (A_COPIES + kMmaThreads - 1) / kMmaThreads;
  constexpr int B_ITERS = (B_COPIES + kMmaThreads - 1) / kMmaThreads;

  extern __shared__ __align__(16) int8_t smem[];
  int8_t* sa = smem;                          // [kStages][BM][kRow]
  int8_t* sb = smem + kStages * BM * kRow;    // [kStages][BN][kRow]

  const int tid = threadIdx.x;
  const int g = blockIdx.z;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int cpt = a.cin_g / kChunk;  // chunks per tap
  const int nk = a.k / kChunk;

  // each thread's A rows: the output pixel's batch offset and window origin
  long long a_base[A_ITERS];
  int a_iy[A_ITERS], a_ix[A_ITERS];
  bool a_ok[A_ITERS];
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) {
    const int c = tid + i * kMmaThreads;
    const long long m = m0 + (c >> 1);
    a_ok[i] = c < A_COPIES && m < a.m;
    const long long mm = a_ok[i] ? m : 0;
    const int ox = static_cast<int>(mm % a.wo);
    const long long t = mm / a.wo;
    const int oy = static_cast<int>(t % a.ho);
    const long long b = t / a.ho;
    a_base[i] = b * a.h * a.w_ * a.cin + static_cast<long long>(g) * a.cin_g +
                (c & 1) * 16;
    a_iy[i] = oy * a.stride - a.pad;
    a_ix[i] = ox * a.stride - a.pad;
  }

  auto load = [&](int stage, int kc) {
    const int tap = kc / cpt;
    const int c0 = (kc - tap * cpt) * kChunk;
    const int ky = tap / a.ks, kx = tap - ky * a.ks;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int c = tid + i * kMmaThreads;
      if (c < A_COPIES) {
        const int iy = a_iy[i] + ky * a.dil, ix = a_ix[i] + kx * a.dil;
        const bool ok =
            a_ok[i] && iy >= 0 && iy < a.h && ix >= 0 && ix < a.w_;
        const int8_t* src =
            ok ? a.x + a_base[i] +
                     (static_cast<long long>(iy) * a.w_ + ix) * a.cin + c0
               : a.x;
        cp_async16(sa + (stage * BM + (c >> 1)) * kRow + (c & 1) * 16, src,
                   ok);
      }
    }
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i) {
      const int c = tid + i * kMmaThreads;
      if (c < B_COPIES) {
        const int n = n0 + (c >> 1);
        const bool ok = n < a.co_g;
        const int8_t* src =
            ok ? a.w + static_cast<long long>(g * a.co_g + n) * a.k +
                     kc * kChunk + (c & 1) * 16
               : a.w;
        cp_async16(sb + (stage * BN + (c >> 1)) * kRow + (c & 1) * 16, src,
                   ok);
      }
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
  int32_t acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }

  // ldmatrix lane addresses: A, matrices (rows 0-7, bytes 0-15), (8-15,
  // 0-15), (0-7, 16-31), (8-15, 16-31) = a0..a3 of m16n8k32; B, (n 0-7,
  // bytes 0-15), (0-7, 16-31), (8-15, 0-15), (8-15, 16-31) = b0, b1 of two
  // n8 tiles
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_half = lane >> 4;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_half = (lane >> 3) & 1;

  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kc + kStages - 1;
    if (next < nk) load(next % kStages, next);
    cp_async_commit();

    const int stage = kc % kStages;
    const int8_t* ta = sa + stage * BM * kRow;
    const int8_t* tb = sb + stage * BN * kRow;
    uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      ldmatrix_x4(af[i],
                  ta + (wm * TM + i * 16 + a_row) * kRow + a_half * 16);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t r[4];
      ldmatrix_x4(r, tb + (wn * TN + j * 8 + b_row) * kRow + b_half * 16);
      bfr[j][0] = r[0];
      bfr[j][1] = r[1];
      bfr[j + 1][0] = r[2];
      bfr[j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bfr[j]);
  }
  cp_async_wait<0>();

  // c0, c1: row gid, columns 2*tig, 2*tig + 1; c2, c3: row gid + 8
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * TM + i * 16 + gid + half * 8;
      if (m >= a.m) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * TN + j * 8 + tig * 2 + e;
          if (n < a.co_g) {
            const int oc = g * a.co_g + n;
            store_out(a, m * a.co + oc, oc, acc[i][j][half * 2 + e]);
          }
        }
      }
    }
  }
}

// ---- wgmma body ----------------------------------------------------------
// conv_bias_act.cu's bf16 TMA ring, in int8: K chunks of CHUNK int8, one
// tap's CHUNK channels, each one row of the swizzle of that width (128,
// 64 or 32 bytes), so that with CHUNK 128 the ring, the im2col and tiled
// maps and the wgmma descriptors are that kernel's byte for byte; each
// chunk is CHUNK / 32 m64nBNk32 s8 wgmmas into int32 accumulators.
// Stride 1, dilation 1, groups 1, CIN a multiple of CHUNK and CO of BN.
// The epilogue stages the tile in the output's type in the idle ring,
// then stores whole rows 16 bytes at a time.
// wgmma descriptor of a K-major tile whose rows are CHUNK bytes in the
// swizzle of that width (128B, 64B or 32B): groups of 8 rows CHUNK * 8
// bytes apart (SBO), the tile aligned to that group.
template <int CHUNK>
__device__ __forceinline__ uint64_t wgmma_desc_of(uint32_t addr) {
  constexpr uint64_t kLayout = CHUNK == 128 ? 1 : CHUNK == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(CHUNK * 8 >> 4) << 32) | (kLayout << 62);
}

template <int R>
__device__ __forceinline__ void fence_acc(int32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define ACC8(i)                                                         \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),           \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d += A (64 x 32, K-major, smem) * B (32 x BN, K-major, smem), int8
template <int BN>
struct WgmmaS8;

template <>
struct WgmmaS8<64> {
  __device__ __forceinline__ static void mma(int32_t (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaS8<128> {
  __device__ __forceinline__ static void mma(int32_t (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
          ACC8(56)
        : "l"(a), "l"(b), "r"(1));
  }
};

#undef ACC8

// The ring's A and B tiles and a full and an empty mbarrier per stage,
// plus slack to align the ring to 1024 bytes; the staged output tile
// reuses the ring.
template <int BM, int BN, int STAGES, int CHUNK>
constexpr int wgmma_smem_bytes() {
  return STAGES * (BM + BN) * CHUNK + STAGES * 16 + 1024;
}

template <int BM, int BN, int STAGES, int CHUNK, typename TOut>
__global__ void __launch_bounds__(BM * 2)
    conv_s8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap,
                         const ConvS8Args a) {
  static_assert(STAGES >= 3, "the ring runs STAGES - 2 chunks ahead");
  static_assert(BM * (BN * sizeof(TOut) + 16) <= STAGES * (BM + BN) * CHUNK,
                "the staged output tile fits in the ring");
  constexpr int kA = BM * CHUNK, kB = BN * CHUNK;  // stage bytes
  constexpr int kAhead = STAGES - 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_a = base, s_b = base + STAGES * kA;
  const uint32_t s_full = s_b + STAGES * kB, s_empty = s_full + 8 * STAGES;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;  // warpgroup, thread in it
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int steps = a.k / CHUNK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(s_full + 8 * s, 1);
      mbar_init(s_empty + 8 * s, BM / 16);  // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 copies K chunk i into stage i % STAGES: the activations in
  // im2col mode (BM pixels of CHUNK channels from the tile's first
  // pixel's window corner, at the chunk's tap), the weights as a (BN x
  // CHUNK) box
  const int px = static_cast<int>(m0 % a.wo) - a.pad;
  const int py = static_cast<int>((m0 / a.wo) % a.ho) - a.pad;
  const int pn = static_cast<int>(m0 / (static_cast<long long>(a.wo) * a.ho));
  auto load = [&](int i) {
    const int s = i % STAGES;
    if (i >= STAGES) mbar_wait(s_empty + 8 * s, ((i / STAGES) - 1) & 1);
    const int k0 = i * CHUNK;
    const int tap = k0 / a.cin;
    const uint32_t bar = s_full + 8 * s;
    mbar_expect_tx(bar, kA + kB);
    tma_load_im2col(s_a + s * kA, &xmap, bar, k0 - tap * a.cin, px, py, pn,
                    tap % a.ks, tap / a.ks);
    tma_load_2d(s_b + s * kB, &wmap, bar, k0, n0);
  };

  int32_t acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  if (tid == 0)
    for (int i = 0; i < kAhead && i < steps; ++i) load(i);
  fence_acc(acc);
  for (int i = 0; i < steps; ++i) {
    const int s = i % STAGES;
    // as conv_bias_act.cu: the copy of chunk i + kAhead is issued before
    // this chunk's wgmma (no divergent code between a wgmma and its wait)
    if (tid == 0 && i + kAhead < steps) load(i + kAhead);
    mbar_wait(s_full + 8 * s, (i / STAGES) & 1);  // both tiles landed
    const uint64_t da = wgmma_desc_of<CHUNK>(s_a + s * kA + wg * 64 * CHUNK);
    const uint64_t db = wgmma_desc_of<CHUNK>(s_b + s * kB);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CHUNK / 32; ++kk)  // k32 slice: +32 bytes
      WgmmaS8<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
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
  // staged rows padded by 16 bytes; then 16-byte stores of whole rows
  constexpr int kOutLd = BN * static_cast<int>(sizeof(TOut)) + 16;
  uint8_t* staged = smem_raw + (base - smem_addr(smem_raw));
  __syncthreads();  // every warpgroup's wgmma has stopped reading the ring
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = tile_col + 8 * j + e;
      const float sc = __ldg(a.scale + n0 + n), bi = __ldg(a.bias + n0 + n);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        TOut* dst = reinterpret_cast<TOut*>(
            staged + (tile_row + 8 * half) * kOutLd) + n;
        *dst = to_out(dequant_act(acc[4 * j + 2 * half + e], sc, bi, a.act),
                      a.out_scale, dst);
      }
    }
  }
  __syncthreads();
  constexpr int kRowChunks = BN * static_cast<int>(sizeof(TOut)) / 16;
  uint8_t* out = static_cast<uint8_t*>(a.out);
  for (int c = tid; c < BM * kRowChunks; c += BM * 2) {
    const int r = c / kRowChunks, q = c % kRowChunks;
    const long long m = m0 + r;
    if (m < a.m)
      *reinterpret_cast<uint4*>(out + (m * a.co + n0) * sizeof(TOut) +
                                q * 16) =
          *reinterpret_cast<const uint4*>(staged + r * kOutLd + q * 16);
  }
}

// ---- dp4a body -----------------------------------------------------------
constexpr int kDp4aThreads = 128;
constexpr int kWordsPerChunk = 256;  // K words (1024 k) staged at a time

// NPT consecutive outputs of channels oc0.. to dst (16-byte aligned), in
// 16-byte stores of values packed in registers.
template <typename T, int NPT>
__device__ __forceinline__ void store_vec(const ConvS8Args& a,
                                          const int32_t (&acc)[NPT], int oc0,
                                          T* dst) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // values a store
#pragma unroll
  for (int v = 0; v < NPT / kPer; ++v) {
    uint4 packed;
    T* vals = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int n = v * kPer + i;
      vals[i] = to_out(dequant_act(a, oc0 + n, acc[n]), a.out_scale, dst);
    }
    reinterpret_cast<uint4*>(dst)[v] = packed;
  }
}

template <int NPT>
__global__ void __launch_bounds__(kDp4aThreads)
    conv_s8_dp4a_kernel(const ConvS8Args a) {
  extern __shared__ int32_t ws[];  // [NPT][kWordsPerChunk]
  const int g = blockIdx.z;
  const int n0 = blockIdx.y * NPT;
  const long long m =
      static_cast<long long>(blockIdx.x) * kDp4aThreads + threadIdx.x;
  const bool live = m < a.m;
  const long long mm = live ? m : 0;
  const int ox = static_cast<int>(mm % a.wo);
  const long long t = mm / a.wo;
  const int oy = static_cast<int>(t % a.ho);
  const long long b = t / a.ho;
  const int8_t* xb = a.x + b * a.h * a.w_ * a.cin +
                     static_cast<long long>(g) * a.cin_g;
  const int iy0 = oy * a.stride - a.pad, ix0 = ox * a.stride - a.pad;
  const int kwords = (a.k + 3) / 4;

  int32_t acc[NPT];
#pragma unroll
  for (int n = 0; n < NPT; ++n) acc[n] = 0;
  // the window position of the next k: channel, tap column, tap row
  int ci = 0, kx = 0, ky = 0;
  for (int w0 = 0; w0 < kwords; w0 += kWordsPerChunk) {
    const int nw = min(kWordsPerChunk, kwords - w0);
    __syncthreads();
    for (int i = threadIdx.x; i < NPT * nw; i += kDp4aThreads) {
      const int n = i / nw, j = i - n * nw;
      uint32_t word = 0;
      if (n0 + n < a.co_g) {
        const int8_t* row =
            a.w + static_cast<long long>(g * a.co_g + n0 + n) * a.k;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = (w0 + j) * 4 + e;
          if (k < a.k)
            word |= static_cast<uint32_t>(static_cast<uint8_t>(row[k]))
                    << (8 * e);
        }
      }
      ws[n * kWordsPerChunk + j] = static_cast<int32_t>(word);
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < nw; ++j) {
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = (w0 + j) * 4 + e;
        if (k < a.k) {
          const int iy = iy0 + ky * a.dil, ix = ix0 + kx * a.dil;
          if (iy >= 0 && iy < a.h && ix >= 0 && ix < a.w_)
            word |= static_cast<uint32_t>(static_cast<uint8_t>(
                        xb[(static_cast<long long>(iy) * a.w_ + ix) * a.cin +
                           ci]))
                    << (8 * e);
          if (++ci == a.cin_g) {
            ci = 0;
            if (++kx == a.ks) {
              kx = 0;
              ++ky;
            }
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NPT; ++n)
        acc[n] = __dp4a(static_cast<int>(word), ws[n * kWordsPerChunk + j],
                        acc[n]);
    }
  }
  if (!live) return;
  const int oc0 = g * a.co_g + n0;
  const long long idx0 = m * a.co + oc0;
  if (NPT % 16 == 0 && n0 + NPT <= a.co_g && (a.co % 16) == 0 &&
      (oc0 % 16) == 0) {
    // whole 16-byte groups of the pixel's channels (conv 0's 32): the
    // values packed in registers, one vector store per group
    if (a.out_kind == kOutS8) {
      store_vec<int8_t, NPT>(a, acc, oc0,
                             static_cast<int8_t*>(a.out) + idx0);
    } else if (a.out_kind == kOutBf16) {
      store_vec<__nv_bfloat16, NPT>(
          a, acc, oc0, static_cast<__nv_bfloat16*>(a.out) + idx0);
    } else {
      store_vec<float, NPT>(a, acc, oc0, static_cast<float*>(a.out) + idx0);
    }
    return;
  }
#pragma unroll
  for (int n = 0; n < NPT; ++n) {
    if (n0 + n < a.co_g) {
      const int oc = oc0 + n;
      store_out(a, idx0 + n, oc, acc[n]);
    }
  }
}

unsigned ceil_div(long long a, long long b) {
  return static_cast<unsigned>((a + b - 1) / b);
}

template <int BM, int BN, int WM, int WN>
int launch_mma(const ConvS8Args& a, cudaStream_t st) {
  const dim3 grid(ceil_div(a.m, BM), ceil_div(a.co_g, BN), a.groups);
  conv_s8_mma_kernel<BM, BN, WM, WN>
      <<<grid, kMmaThreads, mma_smem_bytes<BM, BN>(), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int STAGES, int CHUNK, typename TOut>
int launch_wgmma(const ConvS8Args& a, const void* x, const void* w,
                 cudaStream_t st) {
  constexpr int kSmem = wgmma_smem_bytes<BM, BN, STAGES, CHUNK>();
  const auto kernel = conv_s8_wgmma_kernel<BM, BN, STAGES, CHUNK, TOut>;
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
  const int bad = encode_conv_maps(&xmap, &wmap, x, w,
                                   CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, BM, BN,
                                   a.batch, a.h, a.w_, a.cin, a.co, a.ks,
                                   CHUNK);
  if (bad != 0) return bad;
  const dim3 grid(ceil_div(a.m, BM), a.co / BN, 1);
  kernel<<<grid, BM * 2, kSmem, st>>>(xmap, wmap, a);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int STAGES, int CHUNK>
int launch_wgmma_out(const ConvS8Args& a, const void* x, const void* w,
                     cudaStream_t st) {
  if (a.out_kind == kOutS8)
    return launch_wgmma<128, BN, STAGES, CHUNK, int8_t>(a, x, w, st);
  if (a.out_kind == kOutBf16)
    return launch_wgmma<128, BN, STAGES, CHUNK, __nv_bfloat16>(a, x, w, st);
  return launch_wgmma<128, BN, STAGES, CHUNK, float>(a, x, w, st);
}

template <int NPT>
int launch_dp4a(const ConvS8Args& a, cudaStream_t st) {
  const dim3 grid(ceil_div(a.m, kDp4aThreads), ceil_div(a.co_g, NPT),
                  a.groups);
  conv_s8_dp4a_kernel<NPT><<<grid, kDp4aThreads,
                             NPT * kWordsPerChunk * sizeof(int32_t), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// a negative code of its own (kErrPlan for a plan this file was not built
// for, kErrEntryPoint, kErrTensorMap). The caller checks the shapes,
// dtypes, layouts and 16-byte alignment, quantizes a float input,
// allocates `out` and picks the plan: body 0 = mma with (bm, bn) (128,
// 64) or (64, 64), which needs (cin / groups) % 32 == 0; body 1 = dp4a
// with aux = 32, 8 or 1 channels a thread; body 2 = wgmma with (bm, bn,
// aux = the K chunk) (128, 128, 128), (128, 64, 128), (128, 64, 64) or
// (128, 64, 32), which needs groups 1, stride 1, dilation 1, an odd
// kernel, cin % aux == 0 and co % bn == 0. act: linear, leaky,
// mish, logistic, swish, relu, ramp (0-6); out_kind: int8 at out_scale,
// bf16, fp32 (0-2). The mma and dp4a bodies stay within the default 48 KB
// of shared memory (the mma rings 36 and 24 KB, dp4a 32 KB at most); the
// wgmma rings ask for theirs.
extern "C" int yolo_conv_s8_bias_act(const void* x, const void* w,
                                     const void* scale, const void* bias,
                                     void* out, float out_scale, int batch,
                                     int h, int width, int cin, int co,
                                     int ks, int stride, int dil, int groups,
                                     int pad, int ho, int wo, int act,
                                     int out_kind, int body, int bm, int bn,
                                     int aux, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (groups < 1 || cin % groups != 0 || co % groups != 0 || act < 0 ||
      act > kRamp || out_kind < 0 || out_kind > kOutF32)
    return kErrPlan;
  ConvS8Args a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.out_scale = out_scale;
  a.batch = batch;
  a.h = h;
  a.w_ = width;
  a.cin = cin;
  a.co = co;
  a.ks = ks;
  a.stride = stride;
  a.dil = dil;
  a.groups = groups;
  a.pad = pad;
  a.ho = ho;
  a.wo = wo;
  a.cin_g = cin / groups;
  a.co_g = co / groups;
  a.k = ks * ks * a.cin_g;
  a.m = static_cast<long long>(batch) * ho * wo;
  a.act = act;
  a.out_kind = out_kind;
  if (body == 0) {
    if (a.cin_g % kChunk != 0) return kErrPlan;
    if (bm == 128 && bn == 64) return launch_mma<128, 64, 4, 2>(a, st);
    if (bm == 64 && bn == 64) return launch_mma<64, 64, 2, 4>(a, st);
    return kErrPlan;
  }
  if (body == 2) {
    // the TMA maps' geometry: stride 1, dilation 1, darknet padding; aux
    // is the K chunk, CIN a multiple of it
    if (groups != 1 || stride != 1 || dil != 1 || bm != 128 ||
        co % bn != 0 || ks % 2 != 1 || ho != h || wo != width ||
        cin % aux != 0)
      return kErrPlan;
    // 128-byte chunks: rings of 98 and 74 KB, two and three blocks an SM
    // (a block's fill and epilogue overlap another's K loop; a 128x256
    // tile's 196 KB ring, one block an SM, measured slower on every
    // YOLOv2-COCO shape). 64- and 32-byte chunks (CIN 64 and 32): more
    // stages of the narrower rows, 74 and 49 KB
    if (aux == 128 && bn == 128)
      return launch_wgmma_out<128, 3, 128>(a, x, w, st);
    if (aux == 128 && bn == 64)
      return launch_wgmma_out<64, 3, 128>(a, x, w, st);
    if (aux == 64 && bn == 64) return launch_wgmma_out<64, 6, 64>(a, x, w, st);
    if (aux == 32 && bn == 64) return launch_wgmma_out<64, 8, 32>(a, x, w, st);
    return kErrPlan;
  }
  if (body == 1) {
    if (aux == 32) return launch_dp4a<32>(a, st);
    if (aux == 8) return launch_dp4a<8>(a, st);
    if (aux == 1) return launch_dp4a<1>(a, st);
  }
  return kErrPlan;
}
