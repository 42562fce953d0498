// int8 conv + dequantize + bias + activation, then requantize or cast, and
// (stem body) the maxpool that follows it, for Hopper (sm_90a).
//
// Replaces the int8 x int8 -> int32 conv of the JAX package's int8
// post-training quantization, yolo_tpu/models/quantize.py:234
// (lax.conv_general_dilated with preferred_element_type=int32 inside
// conv_block_int8): an XLA op there, with no Pallas kernel. Plain version:
// yolo_tpu_torch/ops/conv_s8.py::conv_s8_bias_act (and, for the fused
// pool, ops/pool.py::maxpool_nchw after it).
//
// Layouts (the Darknet executor's channels_last tensors, read in place):
//   x     (B, H, W, CIN)            int8 NHWC bytes (the stem body also
//                                   reads bf16 or fp32 and quantizes)
//   w     (CO, ks, ks, CIN/groups)  int8: an OIHW channels_last kernel
//   scale (CO,) fp32                x_scale * w_scale, formed by the caller
//   bias  (CO,) fp32
//   out   (B, H', W', CO)           int8, bf16 or fp32 NHWC bytes (pooled
//                                   (B, H'', W'', CO) with a fused pool)
// Any kernel size, stride, dilation and groups; darknet padding
// (ks / 2) * dilation; zeros outside the image.
//
// An implicit GEMM per group g: M = B*H'*W' output pixels, N = CO/groups,
// K = ks*ks*CIN/groups with k = (ky*ks + kx)*cin_g + ci, so that row n of
// the kernel is K contiguous bytes (K-major), as is each pixel's window
// tap in NHWC. The int32 sums are exact, so any order of summation (and
// any split of K) gives the plain version's sums; the epilogue then
// repeats its fp32 arithmetic operation by operation (no contraction: the
// library is built -fmad=false, and the operations are spelled __fmul_rn /
// __fadd_rn / __fdiv_rn): __int2float_rn(acc) * scale[oc] + bias[oc], the
// activation (leaky, linear, relu, ramp exactly; mish, logistic and swish
// through expf / log1pf / tanhf, within an ulp or two of PyTorch's), then
// rintf(y / out_scale) (round half to even) clipped to [-127, 127], or
// __float2bfloat16_rn(y), or y. A float input is quantized as the plain
// quantize_input does: rintf(x.f32 * x_inv) clipped to [-127, 127].
//
// An int8 code is taken through the product with the correctly rounded
// reciprocal of out_scale, and through the IEEE quotient only where that
// product lies within 1e-4 of a half-integer (to_out: the same code).
// The unrolled tensor-core epilogues take leaky, linear, relu and ramp in
// registers; a conv with mish, logistic or swish, and the mma body's int8
// codes, write their int32 sums to a workspace, and the reduction
// (conv_s8_splitk_reduce_kernel) runs that epilogue: the unrolled code
// stays small in the instruction cache and holds no division.
//
// What bounds it on an H100 (1979 TOPS int8 dense, 3.35 TB/s): the larger
// of 2*M*N*K operations at the int8 tensor rate and the bytes each input
// read once and the output written once. At batch 32 the 3x3 layers of
// YOLOv2-COCO are operation-bound, conv 0 and the 1x1 layers byte-bound;
// at batch 1 every layer is byte-bound (its weights).
//
// Four bodies, chosen by the wrapper (ops/cuda/conv_s8_kernel.py::plan):
//   * stem (groups 1, dilation 1, stride 1 or 2, ks*ks*cin <= 32, CO % 8:
//     conv 0 of every built-in detector). Byte-bound (YOLOv2-COCO's conv 0
//     at batch 32 reads 33 MB of bf16 and, with pool 1 fused, writes 44 MB
//     of int8: 0.023 ms; its operations 0.005 ms), so the design removes
//     passes: a persistent block walks patches of 16 x 32 conv outputs,
//     quantizes each patch's input tile with its halo into shared memory
//     straight from the compute-dtype input (no quantize pass; the next
//     tile's first codes are loaded while this one computes), builds each
//     pixel's window as one K row of 32 bytes (zero weights past K) and
//     runs one mma.sync m16n8k32 s8 per 16 pixels and 8 channels, the
//     weights held in registers. Epilogues: without a pool, from the
//     accumulators (int8 codes gathered across the 4 lanes of a row, 8
//     channels a lane); a 2x2/2 pool of int8 codes in registers (the two
//     rows of an m16 tile are vertical neighbours, the column neighbour 4
//     lanes away), pooling the int32 sums with max (min where a scale is
//     negative: the epilogue is monotone) and requantizing once per pooled
//     value; any other pool staged in shared memory, each window pooled in
//     the output's type (NaN propagating, as F.max_pool2d). Darknet's pool
//     padding: taps outside the conv output are skipped, which equals the
//     int8-minimum / -inf fill.
//   * wgmma (stride 1, dilation 1, groups 1, odd ks, CIN % 32, CO % 64:
//     every other YOLOv2-COCO conv but the head). Operation-bound at batch
//     32-128 on the 3x3 convs, so the design keeps the tensor cores fed: a
//     persistent grid (one block an SM for 128 x 128 tiles on a 6-stage
//     ring, two for 128 x 64 tiles on 4 stages; 128 x 256 tiles ran the
//     13x13 convs 12% faster at batch 128 but spilled) walks
//     output tiles (and K splits where the tiles do not fill the card);
//     one thread of a producer warp (a warp, not a warpgroup: the
//     consumers keep 224 registers a thread) keeps every stage of the
//     ring in flight with TMA; two consumer warpgroups of 64
//     rows run m64nBNk32 s8 wgmmas and release each stage on its empty
//     mbarrier. A stage is 128 bytes of K at every CIN: one im2col box of
//     128 channels, or two of 64, or four of 32 (several taps on one
//     mbarrier; each box in the swizzle of its width), and one 128-byte
//     weight box (128B swizzle; past K the map reads zeros, so a ragged
//     last stage's unloaded activation boxes multiply zeros). The epilogue
//     stages each panel of the tile in its own buffer (not the ring) and
//     stores whole rows 16 bytes at a time, while the producer already
//     fills the next tile's stages. With a K split each block stores its
//     int32 partial tile and the reduction sums the splits (exact).
//   * mma (the other per-group CIN multiple of 32: the 425-filter head,
//     strided and grouped convs): mma.sync m16n8k32 s8. A block of 8 warps
//     covers BM pixels x 64 channels (BM 128 or 64); K runs in chunks of
//     32 bytes, one tap's 32 channels, so a chunk of a pixel is two
//     16-byte copies. A 4-stage cp.async ring (zero-fill outside the image
//     and past M and N) keeps three chunks in flight; fragments come from
//     shared memory by ldmatrix (rows padded to 48 bytes: conflict-free);
//     the epilogue runs on the accumulators in registers.
//   * dp4a (narrow groups, anything else): one thread per output pixel and
//     NPT channels; the block's weights staged in shared memory as packed
//     words in chunks of K, the pixel's window gathered four bytes at a
//     time (zeros outside the image and past K), __dp4a into NPT int32
//     sums, stored as 16-byte vectors where the channels allow.
//
// The int8 maxpool of the other pools is csrc/maxpool_s8.cu.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tma_ring.cuh"

namespace {

enum Act { kLinear = 0, kLeaky, kMish, kLogistic, kSwish, kRelu, kRamp };
enum OutKind { kOutS8 = 0, kOutBf16, kOutF32 };
enum InKind { kInS8 = 0, kInBf16, kInF32 };


struct ConvS8Args {
  const int8_t* x;
  const void* xin;  // x as the stem body reads it: int8, bf16 or fp32
  const int8_t* w;
  const float* scale;
  const float* bias;
  void* out;
  float out_scale;
  float out_inv;    // 1 / out_scale, correctly rounded
  float x_inv;      // 1 / x_scale (fp32): the stem body's quantization
  int batch, h, w_, cin, co, ks, stride, dil, groups, pad, ho, wo;
  int cin_g, co_g, k;  // k = ks * ks * cin_g
  long long m;         // batch * ho * wo
  int act, out_kind, x_kind;
  // the stem body's fused maxpool (size 1, stride 1, lead 0 without one)
  // and its output size
  int psize, pstride, plead, ph, pw;
  // the wgmma body's units (tile, K split), N tiles and K stages a tile:
  // read from the parameter bank, they hold no register
  int wg_units, wg_ntiles, wg_steps;
};

unsigned ceil_div(long long a, long long b) {
  return static_cast<unsigned>((a + b - 1) / b);
}

__device__ __forceinline__ float sigmoid(float v) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
}

// leaky, linear, relu and ramp: a few instructions, so that an epilogue
// unrolled over up to 128 values a thread stays small in the instruction
// cache (the unrolled epilogues take this path where the activation is
// one of these: is_simple)
__device__ __forceinline__ float activate_simple(float v, int act) {
  const float leaky = v > 0.0f ? v : __fmul_rn(v, 0.1f);
  const float relu = fmaxf(v, 0.0f);
  return act == kLeaky   ? leaky
         : act == kRelu  ? relu
         : act == kRamp  ? __fadd_rn(relu, __fmul_rn(0.1f, v))
                         : v;
}

__device__ __forceinline__ bool is_simple(int act) {
  return act == kLinear || act == kLeaky || act == kRelu || act == kRamp;
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kMish: {
      // F.softplus (threshold 20), then x * tanh
      const float sp = v > 20.0f ? v : log1pf(expf(v));
      return __fmul_rn(v, tanhf(sp));
    }
    case kLogistic:
      return sigmoid(v);
    case kSwish:
      return __fmul_rn(v, sigmoid(v));
    default:
      return activate_simple(v, act);
  }
}

// The activated fp32 value of an int32 sum: acc * scale + bias, activated
// (SIMPLE: the activation is one of activate_simple's).
template <bool SIMPLE = false>
__device__ __forceinline__ float dequant_act(int32_t acc, float scale,
                                             float bias, int act) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  return SIMPLE ? activate_simple(y, act) : activate(y, act);
}

__device__ __forceinline__ float dequant_act(const ConvS8Args& a, int oc,
                                             int32_t acc) {
  return dequant_act(acc, __ldg(a.scale + oc), __ldg(a.bias + oc), a.act);
}

// The value in the output's type: int8 codes at out_scale, bf16 or fp32.
// The code is rintf(__fdiv_rn(v, out_scale)) clipped to [-127, 127],
// taken through the product r with the correctly rounded reciprocal: r
// and the rounded quotient lie within 1.5 * 2^-23 of the exact quotient
// (relative), so below 129 within 2.3e-5 of each other: where r is 1e-4
// or more from a half-integer both round to the same integer, and past
// 128 both clip to 127; nearer a tie the IEEE quotient is taken.
__device__ __forceinline__ int8_t to_out(float v, const ConvS8Args& a,
                                         int8_t*) {
  float r = __fmul_rn(v, a.out_inv);
  if (fabsf(__fsub_rn(__fsub_rn(r, floorf(r)), 0.5f)) < 1e-4f)
    r = __fdiv_rn(v, a.out_scale);
  const float q = fminf(fmaxf(rintf(r), -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(q));
}

__device__ __forceinline__ __nv_bfloat16 to_out(float v, const ConvS8Args&,
                                                __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float to_out(float v, const ConvS8Args&, float*) {
  return v;
}

// out[idx] from the int32 sum of output channel oc.
__device__ __forceinline__ void store_out(const ConvS8Args& a, long long idx,
                                          int oc, int32_t acc) {
  const float v = dequant_act(a, oc, acc);
  if (a.out_kind == kOutS8) {
    int8_t* out = static_cast<int8_t*>(a.out);
    out[idx] = to_out(v, a, out);
  } else if (a.out_kind == kOutBf16) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
    out[idx] = to_out(v, a, out);
  } else {
    static_cast<float*>(a.out)[idx] = v;
  }
}

// out[idx], bf16 or fp32, from the int32 sum of output channel oc (the
// mma body's epilogue; its int8 codes go through the reduction, so that
// the kernel holds no division and its slow path)
__device__ __forceinline__ void store_float_out(const ConvS8Args& a,
                                                long long idx, int oc,
                                                int32_t acc) {
  const float v = dequant_act<true>(acc, __ldg(a.scale + oc),
                                    __ldg(a.bias + oc), a.act);
  if (a.out_kind == kOutBf16)
    static_cast<__nv_bfloat16*>(a.out)[idx] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(a.out)[idx] = v;
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
    conv_s8_mma_kernel(const __grid_constant__ ConvS8Args a, int32_t* ws) {
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
  // M < 2^31 (the launcher checks): pixel indices in 32 bits, whose
  // divisions need no subroutine
  const int m0 = blockIdx.x * BM;
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
    const int m = m0 + (c >> 1);
    a_ok[i] = c < A_COPIES && m < a.m;
    const int mm = a_ok[i] ? m : 0;
    const int ox = mm % a.wo;
    const int t = mm / a.wo;
    const int oy = t % a.ho;
    const int b = t / a.ho;
    a_base[i] = static_cast<long long>(b) * a.h * a.w_ * a.cin +
                static_cast<long long>(g) * a.cin_g + (c & 1) * 16;
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
  // int8 codes, or an activation other than activate_simple's: the sums
  // go to the workspace, and conv_s8_splitk_reduce_kernel runs the
  // epilogue
  auto each = [&](auto&& fn) {
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
              fn(m * a.co + oc, oc, acc[i][j][half * 2 + e]);
            }
          }
        }
      }
    }
  };
  if (ws != nullptr)
    each([&](long long idx, int, int32_t v) { ws[idx] = v; });
  else
    each([&](long long idx, int oc, int32_t v) {
      store_float_out(a, idx, oc, v);
    });
}

// ---- stem body ------------------------------------------------------------
// A persistent block walks patches of kStemRows x kStemCols conv outputs
// of one image (with a fused pool: the conv outputs a tile of pooled
// outputs needs, the pool's overlap included). Each patch's input tile,
// halo included, is quantized into one of two shared buffers while the
// block computes the patch before it (the next tile's first codes are
// loaded into registers before the compute). Each warp builds the A
// fragments of its m16 tiles (2 x 8 pixels) from the tile, one window
// (K <= 32 bytes) a row; the weights of a 32-channel chunk and their
// scales and biases live in registers. Three epilogues:
//   * direct (no pool): from the accumulators; int8 codes are gathered
//     across the 4 lanes of a row so that each lane stores 8 channels;
//   * pool2 (a 2x2/2 pool, int8 codes, a non-decreasing activation,
//     out_scale > 0): the sums are pooled in registers (the rows of an
//     m16 tile are vertical neighbours, the column neighbour is 4 lanes
//     away), with max where scale >= 0 and min where it is negative
//     (the epilogue is then non-increasing), and the epilogue runs once
//     per pooled value;
//   * staged (any other pool): the sums go to shared memory and the
//     epilogue pools each window in the output's type.
constexpr int kStemThreads = 256;
constexpr int kStemRows = 16, kStemCols = 32;
constexpr int kStemPix = kStemRows * kStemCols;  // 32 m16 tiles of 2 x 8
constexpr int kStemLd = 40;  // int32 words a staged pixel: 32 + 8 (banks)
constexpr int kStemAccBytes = kStemPix * kStemLd * 4;
constexpr int kStemPre = 8;  // input codes a thread loads ahead
constexpr int kStemMaxSmem = 220 * 1024;
enum StemPath { kStemDirect = 0, kStemPool2 = 1, kStemStaged = 2 };

__device__ __forceinline__ int8_t quantize_code(float v, float x_inv) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, x_inv)), -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(q));
}

__device__ __forceinline__ int8_t to_code(int8_t v, float) { return v; }

__device__ __forceinline__ int8_t to_code(__nv_bfloat16 v, float x_inv) {
  return quantize_code(__bfloat162float(v), x_inv);
}

__device__ __forceinline__ int8_t to_code(float v, float x_inv) {
  return quantize_code(v, x_inv);
}

// The running max of a pool window in the output's type: F.max_pool2d's
// rule for floats (a later tap wins if larger or NaN).
__device__ __forceinline__ int8_t pool_max(int8_t best, int8_t v) {
  return v > best ? v : best;
}

__device__ __forceinline__ float pool_max(float best, float v) {
  return (v > best || isnan(v)) ? v : best;
}

__device__ __forceinline__ __nv_bfloat16 pool_max(__nv_bfloat16 best,
                                                  __nv_bfloat16 v) {
  const float b = __bfloat162float(best), f = __bfloat162float(v);
  return (f > b || isnan(f)) ? v : best;
}

// 8 values of TOut -> 8 consecutive outputs at dst (8 * sizeof(TOut)
// bytes, aligned to that).
__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

__device__ __forceinline__ uint32_t bits8(int8_t v) {
  return static_cast<uint8_t>(v);
}

template <typename TOut>
__device__ __forceinline__ void store8(TOut* dst, const TOut (&v)[8]) {
  if constexpr (sizeof(TOut) == 1) {
    uint32_t w[2] = {0, 0};
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j >> 2] |= bits8(v[j]) << (8 * (j & 3));
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else if constexpr (sizeof(TOut) == 2) {
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j >> 1] |= bits16(v[j]) << (16 * (j & 1));
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// i / d for 0 <= i < 2^20 and d >= 1, through fp32: (i + 0.5) / d lies
// at least 0.5 / d from an integer, far beyond the product's error.
__device__ __forceinline__ int small_div(int i, float inv_d) {
  return __float2int_rz(__fmul_rn(static_cast<float>(i) + 0.5f, inv_d));
}

// The staged epilogue of one 32-channel chunk: each item is one output
// (pooled) pixel of the patch's tile and 8 channels.
template <typename TOut>
__device__ __forceinline__ void stem_store(const ConvS8Args& a,
                                          const int32_t* acc_s, int n,
                           int py0, int px0, int cy0, int cx0, int tpr,
                           int tpc, int nc) {
  // max commutes with the epilogue where it is non-decreasing in the sum
  const bool mono_act = sizeof(TOut) == 1 && a.out_scale > 0.0f &&
                        (a.act == kLinear || a.act == kLeaky ||
                         a.act == kRelu || a.act == kRamp);
  const int groups8 = min(32, a.co - nc) / 8;
  TOut* out = static_cast<TOut*>(a.out);
  for (int it = threadIdx.x; it < tpr * tpc * groups8; it += kStemThreads) {
    const int g8 = it % groups8, q = it / groups8;
    const int qy = q / tpc, qx = q - qy * tpc;
    const int oy = py0 + qy, ox = px0 + qx;
    if (oy >= a.ph || ox >= a.pw) continue;
    const int wy = oy * a.pstride - a.plead, wx = ox * a.pstride - a.plead;
    const int ylo = max(wy, 0), yhi = min(wy + a.psize, a.ho);
    const int xlo = max(wx, 0), xhi = min(wx + a.psize, a.wo);
    const int oc0 = nc + g8 * 8;
    float sc[8], bi[8];
    bool mono = mono_act;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j] = __ldg(a.scale + oc0 + j);
      bi[j] = __ldg(a.bias + oc0 + j);
      mono = mono && sc[j] >= 0.0f;
    }
    int32_t best_acc[8];
    TOut best[8];
    bool first = true;
    for (int y = ylo; y < yhi; ++y) {
      for (int x = xlo; x < xhi; ++x) {
        const int4* p = reinterpret_cast<const int4*>(
            acc_s + ((y - cy0) * kStemCols + (x - cx0)) * kStemLd + g8 * 8);
        const int4 v0 = p[0], v1 = p[1];
        const int32_t v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
        if (mono) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            best_acc[j] = first ? v[j] : max(best_acc[j], v[j]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const TOut o =
                to_out(dequant_act(v[j], sc[j], bi[j], a.act), a, out);
            best[j] = first ? o : pool_max(best[j], o);
          }
        }
        first = false;
      }
    }
    if (mono) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        best[j] = to_out(dequant_act<true>(best_acc[j], sc[j], bi[j], a.act),
                         a, out);
    }
    store8(out + ((static_cast<long long>(n) * a.ph + oy) * a.pw + ox) *
                     a.co + oc0,
           best);
  }
}

// The direct epilogue of one pixel row of an m16 tile: c[nt][0..1] the
// sums of channels nc + nt*8 + 2*tig (+1) at conv output (y, x).
template <typename TOut>
__device__ __forceinline__ void stem_direct(const ConvS8Args& a,
                                            const int32_t (&c)[4][2],
                                            const float (&sc)[4][2],
                                            const float (&bi)[4][2], int n,
                                            int y, int x, int nc, int lane,
                                            int tig) {
  const bool live = y >= 0 && y < a.ho && x >= 0 && x < a.wo;
  TOut* out = static_cast<TOut*>(a.out) +
              ((static_cast<long long>(n) * a.ho + y) * a.wo + x) * a.co + nc;
  auto value = [&](int nt, int e) {
    return to_out(dequant_act<true>(c[nt][e], sc[nt][e], bi[nt][e], a.act),
                  a, out);
  };
  if constexpr (sizeof(TOut) == 1) {
    // codes as 16-bit pairs; lane tig gathers the pairs of n-tile tig
    // from the 4 lanes of its row: channels tig*8 .. tig*8 + 7
    uint32_t w[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t pair[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int nt = 2 * h + k;
        pair[k] = static_cast<uint32_t>(static_cast<uint8_t>(value(nt, 0))) |
                  (static_cast<uint32_t>(static_cast<uint8_t>(value(nt, 1)))
                   << 8);
      }
      w[h] = pair[0] | (pair[1] << 16);
    }
    uint32_t got_lo = 0, got_hi = 0;  // channels tig*8 + 0-3, + 4-7
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int want = (tig - r) & 3;  // the pair the receiver asks for
      const uint32_t send = ((want < 2 ? w[0] : w[1]) >> ((want & 1) * 16)) &
                            0xffffu;
      const int from = (tig + r) & 3;
      const uint32_t recv =
          __shfl_sync(0xffffffffu, send, (lane & ~3) | from) <<
          ((from & 1) * 16);
      if (from < 2)
        got_lo |= recv;
      else
        got_hi |= recv;
    }
    if (live && nc + tig * 8 < a.co)
      *reinterpret_cast<uint2*>(out + tig * 8) = make_uint2(got_lo, got_hi);
  } else {
    if (!live) return;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nc + nt * 8 >= a.co) break;
      const TOut v[2] = {value(nt, 0), value(nt, 1)};
      TOut* dst = out + nt * 8 + 2 * tig;
      if constexpr (sizeof(TOut) == 2) {
        *reinterpret_cast<uint32_t*>(dst) = bits16(v[0]) | (bits16(v[1]) << 16);
      } else {
        *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
      }
    }
  }
}

template <typename TIn, int PATH>
__global__ void __launch_bounds__(kStemThreads, PATH == kStemStaged ? 1 : 2)
    conv_s8_stem_kernel(const __grid_constant__ ConvS8Args a, int tiles_x,
                        int tiles_y,
                        int patches) {
  extern __shared__ __align__(16) uint8_t stem_smem[];
  __shared__ float s_scale[32], s_bias[32];
  const int ir = (kStemRows - 1) * a.stride + a.ks;
  const int ic = (kStemCols - 1) * a.stride + a.ks;
  const int row = ic * a.cin, tile_n = ir * row;
  const int tile_bytes = (tile_n + 15) / 16 * 16;
  int8_t* tiles = reinterpret_cast<int8_t*>(stem_smem);  // two buffers
  int32_t* acc_s = reinterpret_cast<int32_t*>(stem_smem + 2 * tile_bytes);
  const float inv_row = 1.0f / static_cast<float>(row);
  const float inv_cin = 1.0f / static_cast<float>(a.cin);

  // the block's tile of (pooled) outputs and the conv patch it needs
  const int tpr = (kStemRows - a.psize) / a.pstride + 1;
  const int tpc = (kStemCols - a.psize) / a.pstride + 1;
  struct Patch {
    int n, py0, px0, cy0, cx0, iy0, ix0;
  };
  auto patch_of = [&](int p) {
    Patch q;
    q.n = p / (tiles_x * tiles_y);
    const int rem = p - q.n * tiles_x * tiles_y;
    const int by = rem / tiles_x;
    q.py0 = by * tpr;
    q.px0 = (rem - by * tiles_x) * tpc;
    q.cy0 = q.py0 * a.pstride - a.plead;
    q.cx0 = q.px0 * a.pstride - a.plead;
    q.iy0 = q.cy0 * a.stride - a.pad;
    q.ix0 = q.cx0 * a.stride - a.pad;
    return q;
  };
  const TIn* xin = static_cast<const TIn*>(a.xin);
  // tile element i: its row, column and offset from the tile's corner in
  // the image (the same for every patch)
  struct Slot {
    int r, c, off;
  };
  auto slot_of = [&](int i) {
    Slot t;
    t.r = small_div(i, inv_row);
    const int e = i - t.r * row;
    t.c = small_div(e, inv_cin);
    t.off = (t.r * a.w_ + t.c) * a.cin + (e - t.c * a.cin);
    return t;
  };
  // its input value in the patch whose tile starts at (iy0, ix0) of
  // image n (zero outside the image)
  auto fetch_at = [&](const Slot& t, int n, int iy0, int ix0) -> TIn {
    const int iy = iy0 + t.r, ix = ix0 + t.c;
    if (iy < 0 || iy >= a.h || ix < 0 || ix >= a.w_) return TIn(0);
    return xin[(static_cast<long long>(n) * a.h + iy0) * a.w_ * a.cin +
               static_cast<long long>(ix0) * a.cin + t.off];
  };
  auto fetch = [&](int n, int iy0, int ix0, int i) -> TIn {
    return fetch_at(slot_of(i), n, iy0, ix0);
  };

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // this thread's 8 k of a window (A fragment bytes k = h*16 + tig*4 + e)
  // as offsets into the tile from the window's corner; k >= K reads the
  // corner (any code: the weights there are zero)
  int koff[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int k = (e >> 2) * 16 + tig * 4 + (e & 3);
    int off = 0;
    if (k < a.k) {
      const int tap = k / a.cin, ci = k - tap * a.cin;
      const int ky = tap / a.ks, kx = tap - ky * a.ks;
      off = (ky * ic + kx) * a.cin + ci;
    }
    koff[e] = off;
  }
  auto corner = [&](int pr, int pc) {
    return (pr * a.stride * ic + pc * a.stride) * a.cin;
  };

  // the weights of a 32-channel chunk (B fragments: k = h*16 + tig*4 + e
  // of channel nc + nt*8 + gid) in registers, its scales and biases in
  // shared memory
  uint32_t bfrag[4][2];
  auto load_chunk = [&](int nc) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int oc = nc + nt * 8 + gid;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t word = 0;
        if (oc < a.co) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = h * 16 + tig * 4 + e;
            if (k < a.k)
              word |= static_cast<uint32_t>(static_cast<uint8_t>(
                          a.w[static_cast<long long>(oc) * a.k + k]))
                      << (8 * e);
          }
        }
        bfrag[nt][h] = word;
      }
    }
    if (tid < 32) {
      const int oc = min(nc + tid, a.co - 1);
      s_scale[tid] = __ldg(a.scale + oc);
      s_bias[tid] = __ldg(a.bias + oc);
    }
  };
  const int chunks = (a.co + 31) / 32;
  if (chunks == 1) load_chunk(0);
  Slot slots[kStemPre];
#pragma unroll
  for (int j = 0; j < kStemPre; ++j) slots[j] = slot_of(tid + j * kStemThreads);

  int p = blockIdx.x;
  if (p >= patches) return;
  {
    const Patch q = patch_of(p);
    for (int i = tid; i < tile_n; i += kStemThreads)
      tiles[i] = to_code(fetch(q.n, q.iy0, q.ix0, i), a.x_inv);
  }
  __syncthreads();
  int buf = 0;
  for (; p < patches; p += gridDim.x, buf ^= 1) {
    const Patch q = patch_of(p);
    // the next patch's first codes, loaded before this patch's compute
    const int pn = p + gridDim.x;
    TIn pre[kStemPre];
    if (pn < patches) {
      const Patch qn = patch_of(pn);
#pragma unroll
      for (int j = 0; j < kStemPre; ++j)
        pre[j] = tid + j * kStemThreads < tile_n
                     ? fetch_at(slots[j], qn.n, qn.iy0, qn.ix0)
                     : TIn(0);
    }
    const int8_t* tile = tiles + buf * tile_bytes;
    auto gather = [&](int base, int half) {
      const int8_t* at = tile + base;
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        word |= static_cast<uint32_t>(
                    static_cast<uint8_t>(at[koff[half * 4 + e]]))
                << (8 * e);
      return word;
    };
    for (int nc = 0; nc < a.co; nc += 32) {
      if (chunks > 1) {
        __syncthreads();  // the last chunk's scales and sums were read
        load_chunk(nc);
        __syncthreads();
      }
      // this lane's epilogue channels' scales and biases in registers:
      // direct, channels nc + nt*8 + 2*tig + e; pool2, the n-tiles it
      // keeps (0-1 at even gid, 2-3 at odd), and the signs of all 8 (a
      // negative scale makes the epilogue non-increasing: min pools)
      float esc[4][2], ebi[4][2];
      uint32_t down = 0;
      const bool odd = gid & 1;
      // the patch's conv outputs all inside the image
      const bool inside = q.cy0 >= 0 && q.cx0 >= 0 &&
                          q.cy0 + kStemRows <= a.ho &&
                          q.cx0 + kStemCols <= a.wo;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = nt * 8 + 2 * tig + e;
          if constexpr (PATH == kStemDirect) {
            esc[nt][e] = s_scale[j];
            ebi[nt][e] = s_bias[j];
          } else if constexpr (PATH == kStemPool2) {
            if (!(s_scale[j] >= 0.0f)) down |= 1u << (nt * 2 + e);
            if (nt < 2) {
              const int jk = (odd ? 2 + nt : nt) * 8 + 2 * tig + e;
              esc[nt][e] = s_scale[jk];
              ebi[nt][e] = s_bias[jk];
            }
          }
        }
      }
#pragma unroll 1
      const bool plain =
          inside && __all_sync(0xffffffffu, down == 0);  // warp-uniform
      for (int mt = warp; mt < kStemPix / 16; mt += kStemThreads / 32) {
        const int pr = 2 * (mt >> 2), pc = 8 * (mt & 3) + gid;  // rows pr, pr+1
        const int b0 = corner(pr, pc), b1 = corner(pr + 1, pc);
        const uint32_t af[4] = {gather(b0, 0), gather(b1, 0), gather(b0, 1),
                                gather(b1, 1)};
        int32_t c[2][4][2];  // [row][n-tile][channel of the pair]
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          int32_t d[4] = {0, 0, 0, 0};
          if (nc + nt * 8 < a.co) mma_s8(d, af, bfrag[nt]);
          c[0][nt][0] = d[0];
          c[0][nt][1] = d[1];
          c[1][nt][0] = d[2];
          c[1][nt][1] = d[3];
        }
        if constexpr (PATH == kStemDirect) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int y = q.cy0 + pr + h, x = q.cx0 + pc;
            if (a.out_kind == kOutS8)
              stem_direct<int8_t>(a, c[h], esc, ebi, q.n, y, x, nc, lane,
                                  tig);
            else if (a.out_kind == kOutBf16)
              stem_direct<__nv_bfloat16>(a, c[h], esc, ebi, q.n, y, x, nc,
                                         lane, tig);
            else
              stem_direct<float>(a, c[h], esc, ebi, q.n, y, x, nc, lane,
                                 tig);
          }
        } else if constexpr (PATH == kStemPool2) {
          // the 2x2 window: rows pr, pr + 1 in this lane, columns pc and
          // pc ^ 1 in the lane 4 away; conv outputs outside the image
          // take no part (INT_MIN after the sign of the scale is folded
          // in: min pools as max of the negated sums)
          const int y = q.cy0 + pr, x = q.cx0 + pc;
          const bool top = inside || (x < a.wo && y < a.ho);
          const bool bottom = inside || (x < a.wo && y + 1 < a.ho);
          // the sum negated where the scale is negative, or INT_MIN
          // outside the image (neither, where the patch lies inside and
          // every scale is positive: the usual case)
          auto fold = [&](int32_t sum, int bit, bool in) {
            if (plain) return sum;
            const int32_t neg = -static_cast<int32_t>((down >> bit) & 1u);
            return in ? (sum ^ neg) - neg : INT32_MIN;
          };
          // even-gid lanes keep n-tiles 0-1, odd ones 2-3: each sends
          // what its neighbour keeps
          int32_t v[2][2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int lo = k * 2 + e, hi = (2 + k) * 2 + e;
              const int32_t m_lo = max(fold(c[0][k][e], lo, top),
                                       fold(c[1][k][e], lo, bottom));
              const int32_t m_hi = max(fold(c[0][2 + k][e], hi, top),
                                       fold(c[1][2 + k][e], hi, bottom));
              const int32_t mine = odd ? m_hi : m_lo;
              const int32_t other = odd ? m_lo : m_hi;
              const int32_t best =
                  max(mine, __shfl_xor_sync(0xffffffffu, other, 4));
              v[k][e] = plain || esc[k][e] >= 0.0f ? best : -best;
            }
          }
          const int oy = q.py0 + (pr >> 1), ox = q.px0 + (pc >> 1);
          if (oy < a.ph && ox < a.pw) {
            int8_t* out = static_cast<int8_t*>(a.out) +
                          ((static_cast<long long>(q.n) * a.ph + oy) * a.pw +
                           ox) * a.co + nc;
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const int nt = odd ? 2 + k : k;
              if (nc + nt * 8 >= a.co) continue;
              const int8_t o0 = to_out(
                  dequant_act<true>(v[k][0], esc[k][0], ebi[k][0], a.act), a,
                  static_cast<int8_t*>(nullptr));
              const int8_t o1 = to_out(
                  dequant_act<true>(v[k][1], esc[k][1], ebi[k][1], a.act), a,
                  static_cast<int8_t*>(nullptr));
              *reinterpret_cast<uint16_t*>(out + nt * 8 + 2 * tig) =
                  static_cast<uint16_t>(bits8(o0) | (bits8(o1) << 8));
            }
          }
        } else {
          const int p0 = pr * kStemCols + pc, p1 = p0 + kStemCols;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            *reinterpret_cast<int2*>(acc_s + p0 * kStemLd + nt * 8 + 2 * tig) =
                make_int2(c[0][nt][0], c[0][nt][1]);
            *reinterpret_cast<int2*>(acc_s + p1 * kStemLd + nt * 8 + 2 * tig) =
                make_int2(c[1][nt][0], c[1][nt][1]);
          }
        }
      }
      if constexpr (PATH == kStemStaged) {
        __syncthreads();
        if (a.out_kind == kOutS8)
          stem_store<int8_t>(a, acc_s, q.n, q.py0, q.px0, q.cy0, q.cx0, tpr,
                             tpc, nc);
        else if (a.out_kind == kOutBf16)
          stem_store<__nv_bfloat16>(a, acc_s, q.n, q.py0, q.px0, q.cy0, q.cx0,
                                    tpr, tpc, nc);
        else
          stem_store<float>(a, acc_s, q.n, q.py0, q.px0, q.cy0, q.cx0, tpr,
                            tpc, nc);
      }
    }
    if (pn < patches) {
      // the next patch's tile into the other buffer: the codes loaded
      // ahead, then the rest
      const Patch qn = patch_of(pn);
      int8_t* next = tiles + (buf ^ 1) * tile_bytes;
#pragma unroll
      for (int j = 0; j < kStemPre; ++j) {
        const int i = tid + j * kStemThreads;
        if (i < tile_n) next[i] = to_code(pre[j], a.x_inv);
      }
      for (int i = tid + kStemPre * kStemThreads; i < tile_n;
           i += kStemThreads)
        next[i] = to_code(fetch(qn.n, qn.iy0, qn.ix0, i), a.x_inv);
    }
    __syncthreads();
  }
}

// ---- wgmma body -----------------------------------------------------------
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
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
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
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
        : "l"(a), "l"(b), "r"(1));
  }
};

#undef ACC8

// a barrier of the `count` threads that name it (ids 1.. : 0 is
// __syncthreads')
__device__ __forceinline__ void named_bar(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// two consumer warpgroups (warps 0-7) and one producer warp (warp 8): a
// producer warpgroup would hold registers the consumers can use (at 384
// threads a block gets 168 a thread; setmaxnreg moves registers at run
// time, but ptxas allocated the consumers within 168 all the same)
constexpr int kWgThreads = 288;
constexpr int kStageK = 128;     // K bytes a stage: four k32 slices
constexpr int kSmPerBlock = 232448;   // the most a block may ask for
constexpr int kSmPerSm = 233472;      // an SM's, 1 KB of it per block kept

// The shapes of one instantiation: 128 x BN tiles, A boxes CH bytes wide,
// MINB blocks an SM. The epilogue buffer holds a panel of kPanel bytes of
// each tile row; the ring takes what it and the barriers leave.
template <int BN, int CH, int MINB>
struct WgCfg {
  static constexpr int kA = 128 * kStageK;
  static constexpr int kB = BN * kStageK;
  static constexpr int kPanel = MINB == 1 ? 128 : 64;
  static constexpr int kEpiLd = kPanel + 16;
  static constexpr int kEpi = 128 * kEpiLd;
  static constexpr int kBudget =
      MINB == 1 ? kSmPerBlock : kSmPerSm / MINB - 1024;
  static constexpr int kStages0 = (kBudget - kEpi - 1024 - 16 * 8) / (kA + kB);
  static constexpr int kStages = kStages0 > 8 ? 8 : kStages0;
  static constexpr int kSmem = kStages * (kA + kB) + kEpi + 16 * kStages + 1024;
  static_assert(kStages >= 3, "a ring of three stages at least");
  static_assert(kSmem <= kBudget, "shared memory");
};

// The epilogue of one consumer warpgroup's 64 x BN accumulators: panel by
// panel (kPanel bytes of each row) through its half of the epilogue
// buffer, then whole rows 16 bytes at a time.
template <int BN, int kPanel, typename TOut>
__device__ __forceinline__ void wgmma_epilogue(const ConvS8Args& a,
                                               const int32_t (&acc)[BN / 2],
                                               uint8_t* epi, int cw, int t,
                                               int m0, int n0) {
  constexpr int kEpiLd = kPanel + 16;
  constexpr int kEl = static_cast<int>(sizeof(TOut));
  constexpr int PN = kPanel / kEl < BN ? kPanel / kEl : BN;  // panel columns
  constexpr int kRowChunks = PN * kEl / 16;
  const int warp = t >> 5, lane = t & 31;
  const int row = warp * 16 + (lane >> 2);  // in this warpgroup's 64
  const int col = 2 * (lane & 3);
  uint8_t* mine = epi + cw * 64 * kEpiLd;
  uint8_t* out = static_cast<uint8_t*>(a.out);
#pragma unroll
  for (int p = 0; p < BN / PN; ++p) {
    named_bar(1 + cw, 128);  // the last panel's rows were stored
#pragma unroll
    for (int j = p * PN / 8; j < (p + 1) * PN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * j + col + e;
        const float sc = __ldg(a.scale + n0 + n), bi = __ldg(a.bias + n0 + n);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          TOut* dst = reinterpret_cast<TOut*>(mine + (row + 8 * half) * kEpiLd) +
                      (n - p * PN);
          *dst = to_out(dequant_act<true>(acc[4 * j + 2 * half + e], sc,
                                          bi, a.act),
                        a, dst);
        }
      }
    }
    named_bar(1 + cw, 128);
    for (int c = t; c < 64 * kRowChunks; c += 128) {
      const int r = c / kRowChunks, q = c - r * kRowChunks;
      const int m = m0 + cw * 64 + r;
      if (m < a.m)
        *reinterpret_cast<uint4*>(
            out + (static_cast<long long>(m) * a.co + n0 + p * PN) * kEl +
            q * 16) =
            *reinterpret_cast<const uint4*>(mine + r * kEpiLd + q * 16);
    }
  }
}

template <int BN, int CH, int MINB>
__global__ void __launch_bounds__(kWgThreads, MINB)
    conv_s8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap,
                         const __grid_constant__ ConvS8Args a, int32_t* ws,
                         int splits) {
  using C = WgCfg<BN, CH, MINB>;
  constexpr int STAGES = C::kStages;
  constexpr int kBoxes = kStageK / CH;   // activation boxes a stage
  constexpr int kBoxBytes = 128 * CH;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_a = base, s_b = base + STAGES * C::kA;
  const uint32_t s_epi = s_b + STAGES * C::kB;
  const uint32_t s_full = s_epi + C::kEpi, s_empty = s_full + 8 * STAGES;
  uint8_t* epi = smem_raw + (s_epi - smem_addr(smem_raw));

  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;  // warpgroup, thread in it
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(s_full + 8 * s, 1);
      mbar_init(s_empty + 8 * s, 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_t = a.wg_ntiles, n_u = a.wg_units, n_s = a.wg_steps;

  if (wg == 2) {
    // the producer warp: one thread keeps every stage of the ring in
    // flight
    if (t != 0) return;
    const int hw = a.ho * a.wo;
    int it = 0, slot = 0, phase = 0;
    for (int u = blockIdx.x; u < n_u; u += gridDim.x) {
      const int tile = u / splits, sp = u - tile * splits;
      const int mt = tile / n_t;
      const int m0 = mt * 128, n0 = (tile - mt * n_t) * BN;
      const int s0 = sp * n_s / splits, s1 = (sp + 1) * n_s / splits;
      // the tile's first pixel's window corner: im2col runs on in NHW
      // order from there, zeros outside the image and past the batch
      const int pn = m0 / hw, rem = m0 - pn * hw;
      const int py = rem / a.wo - a.pad, px = rem % a.wo - a.pad;
      // the activation box's channel and tap at stage s0, walked on by
      // CH bytes a box (no division in the loop)
      int kc = s0 * kStageK;
      int tap = kc / a.cin, c0 = kc - tap * a.cin;
      int ky = tap / a.ks, kx = tap - ky * a.ks;
      for (int s = s0; s < s1; ++s, ++it) {
        if (it >= STAGES) mbar_wait(s_empty + 8 * slot, phase ^ 1);
        const int k0 = s * kStageK;
        const int boxes = min(kBoxes, (a.k - k0) / CH);
        const uint32_t bar = s_full + 8 * slot;
        mbar_expect_tx(bar, boxes * kBoxBytes + C::kB);
        for (int j = 0; j < boxes; ++j) {
          tma_load_im2col(s_a + slot * C::kA + j * kBoxBytes, &xmap, bar,
                          c0, px, py, pn, kx, ky);
          c0 += CH;
          if (c0 == a.cin) {
            c0 = 0;
            if (++kx == a.ks) {
              kx = 0;
              ++ky;
            }
          }
        }
        tma_load_2d(s_b + slot * C::kB, &wmap, bar, k0, n0);
        if (++slot == STAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup cw takes rows cw*64.. of each tile
  const int cw = wg;
  int it = 0;
  int32_t acc[BN / 2];
  for (int u = blockIdx.x; u < n_u; u += gridDim.x) {
    const int tile = u / splits, sp = u - tile * splits;
    const int mt = tile / n_t;
    const int m0 = mt * 128, n0 = (tile - mt * n_t) * BN;
    const int s0 = sp * n_s / splits, s1 = (sp + 1) * n_s / splits;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    fence_acc(acc);
    for (int s = s0; s < s1; ++s, ++it) {
      const int slot = it % STAGES;
      mbar_wait(s_full + 8 * slot, (it / STAGES) & 1);  // both tiles landed
      const uint32_t sa = s_a + slot * C::kA + cw * 64 * CH;
      const uint64_t db = wgmma_desc_of<kStageK>(s_b + slot * C::kB);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStageK / 32; ++kk) {  // k32 slices: +32 bytes
        const uint64_t da =
            wgmma_desc_of<CH>(sa + (kk / (CH / 32)) * kBoxBytes) +
            2 * (kk % (CH / 32));
        WgmmaS8<BN>::mma(acc, da, db + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait<1>();  // stage s may still run; stage s - 1 has finished
      if (s > s0 && (t & 31) == 0)
        mbar_arrive(s_empty + 8 * ((it - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if ((t & 31) == 0) mbar_arrive(s_empty + 8 * ((it - 1) % STAGES));

    if (ws != nullptr) {
      // the int32 partial tile (a K split, or the sums of a conv whose
      // activation is not one of activate_simple's: the reduction runs
      // its epilogue): rows 16q + lane/4 (+8), columns 8j + 2*(lane%4)
      // (+1) in acc[4j ..]
      const int warp = t >> 5, lane = t & 31;
      const int r0 = m0 + cw * 64 + warp * 16 + (lane >> 2);
      int32_t* part = ws + static_cast<long long>(sp) * a.m * a.co + n0 +
                      2 * (lane & 3);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = r0 + 8 * half;
        if (m < a.m) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
            *reinterpret_cast<int2*>(
                part + static_cast<long long>(m) * a.co + 8 * j) =
                make_int2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
        }
      }
    } else if (a.out_kind == kOutS8) {
      wgmma_epilogue<BN, C::kPanel, int8_t>(a, acc, epi, cw, t, m0, n0);
    } else if (a.out_kind == kOutBf16) {
      wgmma_epilogue<BN, C::kPanel, __nv_bfloat16>(a, acc, epi, cw, t, m0,
                                                   n0);
    } else {
      wgmma_epilogue<BN, C::kPanel, float>(a, acc, epi, cw, t, m0, n0);
    }
  }
}

// The sum of a split conv's int32 partials (splits x M x CO; one split
// for a sum that waits for an epilogue with a transcendental activation),
// then the epilogue: VEC outputs a thread (4 where CO % 4 == 0).
template <int VEC>
__global__ void __launch_bounds__(256)
    conv_s8_splitk_reduce_kernel(const int32_t* __restrict__ ws,
                                 const __grid_constant__ ConvS8Args a,
                                 int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long plane = a.m * a.co / VEC;
  if (i >= plane) return;
  int32_t v[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) v[e] = 0;
  for (int sp = 0; sp < splits; ++sp) {
    int32_t p[VEC];
    memcpy(p, ws + (sp * plane + i) * VEC, sizeof(p));
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] += p[e];
  }
  // the outputs packed into one word (int8, bf16 at VEC 1-2) or two
  // (bf16 at VEC 4), or stored as floats
  const int oc = static_cast<int>((i * VEC) % a.co);
  if (a.out_kind == kOutS8) {
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      word |= static_cast<uint32_t>(static_cast<uint8_t>(to_out(
                  dequant_act(a, oc + e, v[e]), a, static_cast<int8_t*>(
                      nullptr))))
              << (8 * e);
    if constexpr (VEC == 4)
      reinterpret_cast<uint32_t*>(a.out)[i] = word;
    else
      static_cast<uint8_t*>(a.out)[i] = static_cast<uint8_t>(word);
  } else if (a.out_kind == kOutBf16) {
    uint32_t words[2] = {0, 0};
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      words[e >> 1] |=
          static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(
              dequant_act(a, oc + e, v[e]))))
          << (16 * (e & 1));
    if constexpr (VEC == 4)
      reinterpret_cast<uint2*>(a.out)[i] = make_uint2(words[0], words[1]);
    else
      static_cast<uint16_t*>(a.out)[i] = static_cast<uint16_t>(words[0]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      static_cast<float*>(a.out)[i * VEC + e] = dequant_act(a, oc + e, v[e]);
  }
}

int launch_reduce(const int32_t* ws, const ConvS8Args& a, int splits,
                  cudaStream_t st) {
  if (a.co % 4 == 0)
    conv_s8_splitk_reduce_kernel<4>
        <<<ceil_div(a.m * a.co / 4, 256), 256, 0, st>>>(ws, a, splits);
  else
    conv_s8_splitk_reduce_kernel<1>
        <<<ceil_div(a.m * a.co, 256), 256, 0, st>>>(ws, a, splits);
  return static_cast<int>(cudaGetLastError());
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
      vals[i] = to_out(dequant_act(a, oc0 + n, acc[n]), a, dst);
    }
    reinterpret_cast<uint4*>(dst)[v] = packed;
  }
}

template <int NPT>
__global__ void __launch_bounds__(kDp4aThreads)
    conv_s8_dp4a_kernel(const __grid_constant__ ConvS8Args a) {
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


// Dynamic shared memory above 48 KB only on request, once per device and
// kernel: bit dev of *allowed.
template <typename K>
int allow_smem(K kernel, int bytes, std::atomic<unsigned long long>* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return kErrPlan;
  if (!((allowed->load() >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed->fetch_or(1ull << dev);
  }
  return 0;
}

template <int BM, int BN, int WM, int WN>
int launch_mma(const ConvS8Args& a, int32_t* ws, cudaStream_t st) {
  const dim3 grid(ceil_div(a.m, BM), ceil_div(a.co_g, BN), a.groups);
  conv_s8_mma_kernel<BM, BN, WM, WN>
      <<<grid, kMmaThreads, mma_smem_bytes<BM, BN>(), st>>>(a, ws);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ws == nullptr) return static_cast<int>(err);
  return launch_reduce(ws, a, 1, st);
}

template <typename TIn, int PATH>
int launch_stem_path(const ConvS8Args& a, int smem, cudaStream_t st) {
  const auto kernel = conv_s8_stem_kernel<TIn, PATH>;
  static std::atomic<unsigned long long> allowed{0};
  int bad = allow_smem(kernel, kStemMaxSmem, &allowed);
  if (bad != 0) return bad;
  const int tpr = (kStemRows - a.psize) / a.pstride + 1;
  const int tpc = (kStemCols - a.psize) / a.pstride + 1;
  const int tiles_x = static_cast<int>(ceil_div(a.pw, tpc));
  const int tiles_y = static_cast<int>(ceil_div(a.ph, tpr));
  const long long patches = static_cast<long long>(tiles_x) * tiles_y *
                            a.batch;
  if (patches >= (1ll << 31)) return kErrPlan;
  // a persistent grid: as many blocks as are resident at once
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kStemThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = static_cast<long long>(sms) * max(per_sm, 1);
  const unsigned grid =
      static_cast<unsigned>(patches < resident ? patches : resident);
  kernel<<<grid, kStemThreads, smem, st>>>(a, tiles_x, tiles_y,
                                           static_cast<int>(patches));
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn>
int launch_stem(const ConvS8Args& a, cudaStream_t st) {
  const int tile = ((kStemRows - 1) * a.stride + a.ks) *
                   ((kStemCols - 1) * a.stride + a.ks) * a.cin;
  const bool simple = a.act == kLinear || a.act == kLeaky ||
                      a.act == kRelu || a.act == kRamp;
  // the direct epilogue for a simple activation without a pool; the
  // pool in registers for int8 codes of a 2x2/2 pool (max commutes with
  // the epilogue: out_scale > 0); else the staged epilogue
  const int path =
      a.psize == 1 && simple ? kStemDirect
      : (simple && a.out_kind == kOutS8 && a.out_scale > 0.0f &&
         a.psize == 2 && a.pstride == 2)
          ? kStemPool2
          : kStemStaged;
  const int smem = 2 * ((tile + 15) / 16 * 16) +
                   (path == kStemStaged ? kStemAccBytes : 0);
  if (smem > kStemMaxSmem) return kErrPlan;
  if (path == kStemDirect)
    return launch_stem_path<TIn, kStemDirect>(a, smem, st);
  if (path == kStemPool2)
    return launch_stem_path<TIn, kStemPool2>(a, smem, st);
  return launch_stem_path<TIn, kStemStaged>(a, smem, st);
}

template <int BN, int CH, int MINB>
int launch_wgmma(const ConvS8Args& a, const void* x, const void* w,
                 int splits, int32_t* ws, cudaStream_t st) {
  using C = WgCfg<BN, CH, MINB>;
  const auto kernel = conv_s8_wgmma_kernel<BN, CH, MINB>;
  static std::atomic<unsigned long long> allowed{0};
  int bad = allow_smem(kernel, C::kSmem, &allowed);
  if (bad != 0) return bad;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the activations in boxes of CH channels (the A operand), the weights
  // in 128-byte boxes (the B operand); each call encodes both maps of a
  // conv and keeps one
  CUtensorMap xmap, wmap, unused;
  bad = encode_conv_maps(&xmap, &unused, x, w, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                         1, 128, BN, a.batch, a.h, a.w_, a.cin, a.co, a.ks,
                         CH);
  if (bad == 0)
    bad = encode_conv_maps(&unused, &wmap, x, w,
                           CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 128, BN,
                           a.batch, a.h, a.w_, a.cin, a.co, a.ks, kStageK);
  if (bad != 0) return bad;
  const long long units =
      static_cast<long long>(ceil_div(a.m, 128)) * (a.co / BN) * splits;
  if (units >= (1ll << 31) || a.m >= (1ll << 31)) return kErrPlan;
  ConvS8Args p = a;
  p.wg_units = static_cast<int>(units);
  p.wg_ntiles = a.co / BN;
  p.wg_steps = (a.k + kStageK - 1) / kStageK;
  const long long grid = units < static_cast<long long>(sms) * MINB
                             ? units
                             : static_cast<long long>(sms) * MINB;
  kernel<<<static_cast<unsigned>(grid), kWgThreads, C::kSmem, st>>>(
      xmap, wmap, p, ws, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || ws == nullptr) return static_cast<int>(err);
  return launch_reduce(ws, a, splits, st);
}

template <int NPT>
int launch_dp4a(const ConvS8Args& a, cudaStream_t st) {
  const dim3 grid(ceil_div(a.m, kDp4aThreads), ceil_div(a.co_g, NPT),
                  a.groups);
  conv_s8_dp4a_kernel<NPT><<<grid, kDp4aThreads,
                             NPT * kWordsPerChunk * sizeof(int32_t), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_wgmma_plan(const ConvS8Args& a, const void* x, const void* w,
                      int bn, int chunk, int splits, int32_t* ws,
                      cudaStream_t st) {
  if (bn == 64 && chunk == 128)
    return launch_wgmma<64, 128, 2>(a, x, w, splits, ws, st);
  if (bn == 64 && chunk == 64)
    return launch_wgmma<64, 64, 2>(a, x, w, splits, ws, st);
  if (bn == 64 && chunk == 32)
    return launch_wgmma<64, 32, 2>(a, x, w, splits, ws, st);
  if (bn == 128 && chunk == 128)
    return launch_wgmma<128, 128, 1>(a, x, w, splits, ws, st);
  if (bn == 128 && chunk == 64)
    return launch_wgmma<128, 64, 1>(a, x, w, splits, ws, st);
  if (bn == 128 && chunk == 32)
    return launch_wgmma<128, 32, 1>(a, x, w, splits, ws, st);
  return kErrPlan;
}

// ---- input quantization -------------------------------------------------
// A float input of the wgmma, mma and dp4a bodies (a conv whose producer
// is not chained to it: a route's or a pool's bf16 output), quantized in
// one pass as the stem quantizes on load: 8 values a thread, 16- or
// 32-byte loads, 8-byte stores (the plain quantize_input takes five
// elementwise passes).
template <typename TIn>
__global__ void __launch_bounds__(256)
    quantize_s8_kernel(const TIn* __restrict__ x, int8_t* __restrict__ q,
                       long long n, float x_inv) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) * 8;
  if (i >= n) return;
  if (i + 8 <= n) {
    // the 8 values as one (bf16) or two (fp32) 16-byte loads
    constexpr int kWords = sizeof(TIn) * 8 / 16;
    uint4 raw[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k)
      raw[k] = reinterpret_cast<const uint4*>(x + i)[k];
    const TIn* v = reinterpret_cast<const TIn*>(raw);
    uint32_t w[2] = {0, 0};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      w[e >> 2] |= bits8(to_code(v[e], x_inv)) << (8 * (e & 3));
    *reinterpret_cast<uint2*>(q + i) = make_uint2(w[0], w[1]);
  } else {
    for (long long j = i; j < n; ++j) q[j] = to_code(x[j], x_inv);
  }
}

}  // namespace

// Quantizes n values of x (x_kind 1 bf16, 2 fp32; 16-byte aligned) into
// the int8 codes q (8-byte aligned): rintf(x * x_inv) clipped to
// [-127, 127]. Returns cudaGetLastError(), or kErrPlan.
extern "C" int yolo_quantize_s8(const void* x, int x_kind, float x_inv,
                                void* q, long long n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || (x_kind != kInBf16 && x_kind != kInF32)) return kErrPlan;
  const unsigned blocks = ceil_div(ceil_div(n, 8), 256);
  if (x_kind == kInBf16)
    quantize_s8_kernel<<<blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q), n,
        x_inv);
  else
    quantize_s8_kernel<<<blocks, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q), n, x_inv);
  return static_cast<int>(cudaGetLastError());
}

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// a negative code of its own (kErrPlan for a plan this file was not built
// for, kErrEntryPoint, kErrTensorMap). The caller checks the
// shapes, dtypes, layouts and 16-byte alignment, quantizes a float input
// for every body but the stem, allocates `out` and the workspace `ws`
// (splits x M x CO int32: for a K split, for the wgmma and mma bodies'
// mish, logistic and swish, and for the mma body's int8 codes) and picks
// the plan:
//   body 0 = mma with (bm, bn) (128, 64) or (64, 64), which needs
//     (cin / groups) % 32 == 0;
//   body 1 = dp4a with aux = 32, 8 or 1 channels a thread;
//   body 2 = wgmma with bn 64 or 128 and aux = the activation boxes'
//     width 128, 64 or 32, in `splits` K splits,
//     which needs groups 1, stride 1, dilation 1, an odd kernel,
//     cin % aux == 0 and co % bn == 0;
//   body 3 = stem, which needs groups 1, dilation 1, stride 1 or 2,
//     ks * ks * cin <= 32 and co % 8 == 0; it alone reads a float input
//     (x_kind 1 bf16, 2 fp32; 0 int8), quantized at x_inv, and fuses a
//     maxpool (psize <= 16, pstride; ph x pw its output; psize 1 for none).
// act: linear, leaky, mish, logistic, swish, relu, ramp (0-6); out_kind:
// int8 at out_scale, bf16, fp32 (0-2). The mma and dp4a bodies stay within
// the default 48 KB of shared memory; the stem and wgmma bodies ask for
// theirs.
extern "C" int yolo_conv_s8_bias_act(
    const void* x, int x_kind, float x_inv, const void* w, const void* scale,
    const void* bias, void* out, float out_scale, int batch, int h,
    int width, int cin, int co, int ks, int stride, int dil, int groups,
    int pad, int ho, int wo, int act, int out_kind, int body, int bm, int bn,
    int aux, int splits, void* ws, int psize, int pstride, int ph, int pw,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (groups < 1 || cin % groups != 0 || co % groups != 0 || act < 0 ||
      act > kRamp || out_kind < 0 || out_kind > kOutF32 || x_kind < 0 ||
      x_kind > kInF32 || (x_kind != kInS8 && body != 3) || splits < 1 ||
      psize < 1 || pstride < 1 || (psize > 1 && body != 3))
    return kErrPlan;
  ConvS8Args a;
  a.x = static_cast<const int8_t*>(x);
  a.xin = x;
  a.w = static_cast<const int8_t*>(w);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.out_scale = out_scale;
  a.out_inv = 1.0f / out_scale;
  a.x_inv = x_inv;
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
  a.x_kind = x_kind;
  a.psize = psize;
  a.pstride = pstride;
  a.plead = (psize - 1) / 2;
  a.ph = ph;
  a.pw = pw;
  // a tensor-core body's sums go through the workspace where the
  // activation is not one of activate_simple's (mish, logistic, swish)
  const bool simple = act == kLinear || act == kLeaky || act == kRelu ||
                      act == kRamp;
  // (and the mma body's int8 codes)
  const bool mma_raw = !simple || out_kind == kOutS8;
  if (((body == 2 && (splits > 1 || !simple)) || (body == 0 && mma_raw)) &&
      ws == nullptr)
    return kErrPlan;
  if (body == 0) {
    if (a.cin_g % kChunk != 0 || splits != 1 || a.m >= (1ll << 31))
      return kErrPlan;
    int32_t* raw = mma_raw ? static_cast<int32_t*>(ws) : nullptr;
    if (bm == 128 && bn == 64) return launch_mma<128, 64, 4, 2>(a, raw, st);
    if (bm == 64 && bn == 64) return launch_mma<64, 64, 2, 4>(a, raw, st);
    return kErrPlan;
  }
  if (body == 2) {
    // the TMA maps' geometry: stride 1, dilation 1, darknet padding; aux
    // is the activation boxes' K chunk, CIN a multiple of it
    if (groups != 1 || stride != 1 || dil != 1 || bm != 128 ||
        co % bn != 0 || ks % 2 != 1 || ho != h || wo != width ||
        aux <= 0 || cin % aux != 0 ||
        splits > (a.k + kStageK - 1) / kStageK)  // a split of no stage
      return kErrPlan;
    return launch_wgmma_plan(
        a, x, w, bn, aux, splits,
        splits > 1 || !simple ? static_cast<int32_t*>(ws) : nullptr, st);
  }
  if (body == 3) {
    if (groups != 1 || dil != 1 || stride < 1 || stride > 2 ||
        a.k > 32 || co % 8 != 0 || splits != 1 || psize > kStemRows)
      return kErrPlan;
    if (x_kind == kInS8) return launch_stem<int8_t>(a, st);
    if (x_kind == kInBf16) return launch_stem<__nv_bfloat16>(a, st);
    return launch_stem<float>(a, st);
  }
  if (body == 1 && splits == 1) {
    if (aux == 32) return launch_dp4a<32>(a, st);
    if (aux == 8) return launch_dp4a<8>(a, st);
    if (aux == 1) return launch_dp4a<1>(a, st);
  }
  return kErrPlan;
}
