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
// values, the column-major B operand of the product, and a K chunk of 32
// (bf16) or 16 (fp32) lies inside one tap because CIN % 128 == 0. The A
// tile gathers, for each output pixel, the 32 input channels of that tap;
// a tap outside the image (the SAME halo) is zero-filled while it is
// copied, so the input is never padded in memory.
//
// What bounds it: at YOLOv2's shapes the product is 0.2-2.4 GFLOP per
// image and layer against a few MB of activations, far above the card's
// ridge point, so the tensor cores bound it. Design of this first version:
//   * bf16: 128x128 output tile per block, 8 warps of 64x32, K in steps of
//     32 through a two-stage cp.async ring in shared memory (rows padded to
//     80 bytes, so the fragment loads hit 32 distinct banks), mma.sync
//     m16n8k16 bf16 -> fp32. wgmma and TMA are later work.
//   * fp32: true fp32 products (no TF32, as JAX's Precision.HIGHEST), a
//     64x64 tile per block, each thread a 4x4 block of FFMAs.
//   * the epilogue (+ bias, leaky, cast) is applied to the fp32 sums in
//     registers and stored once: the fp32 conv output never reaches memory.
//
// The library is built with -fmad=false (the NMS kernel needs its IoU
// uncontracted). The fp32 path therefore spells its multiply-adds as
// __fmaf_rn; the epilogue's add and multiply stay separate roundings, as
// in the plain version. bf16 products are exact in fp32, so the flag
// changes nothing on the mma path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// ---- bf16: mma.sync ----------------------------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLd = kBK + 8;  // smem row: 40 bf16 = 80 bytes
constexpr int kStages = 2;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float act_fn(float v, int leaky) {
  return (leaky && !(v > 0.0f)) ? 0.1f * v : v;
}

__global__ void __launch_bounds__(kThreads)
conv_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ wt,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int batch, int h, int w,
                 int cin, int co, int ks, int leaky) {
  __shared__ __align__(16) __nv_bfloat16 s_a[kStages][kBM * kLd];
  __shared__ __align__(16) __nv_bfloat16 s_b[kStages][kBN * kLd];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2;  // 2 x 64 rows
  const int warp_n = warp & 3;   // 4 x 32 columns
  const long long m_total = (long long)batch * h * w;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int pad = ks >> 1;
  const int k_total = ks * ks * cin;
  const int kt_count = k_total / kBK;

  // this thread copies 16-byte chunk `chunk` of tile rows r and r + 64
  const int chunk = tid & 3;
  const int row0 = tid >> 2;
  int a_b[2], a_y[2], a_x[2];
  bool a_ok[2];
  const __nv_bfloat16* b_src[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + row0 + 64 * i;
    a_ok[i] = m < m_total;
    const long long mm = a_ok[i] ? m : 0;
    a_x[i] = static_cast<int>(mm % w);
    const long long t = mm / w;
    a_y[i] = static_cast<int>(t % h);
    a_b[i] = static_cast<int>(t / h);
    b_src[i] = wt + (size_t)(n0 + row0 + 64 * i) * k_total + chunk * 8;
  }

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    const int tap = k0 / cin;
    const int ci0 = k0 - tap * cin;
    const int dy = tap / ks - pad, dx = tap % ks - pad;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 64 * i;
      const int iy = a_y[i] + dy, ix = a_x[i] + dx;
      const bool ok = a_ok[i] && iy >= 0 && iy < h && ix >= 0 && ix < w;
      const __nv_bfloat16* src =
          ok ? x + (((size_t)a_b[i] * h + iy) * w + ix) * cin + ci0 + chunk * 8
             : x;
      cp_async16(&s_a[stage][row * kLd + chunk * 8], src, ok);
      cp_async16(&s_b[stage][row * kLd + chunk * 8], b_src[i] + k0, true);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0f;

  const int g = lane >> 2, t4 = lane & 3;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_count; ++kt) {
    if (kt + 1 < kt_count) load_stage((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait_1();  // stage kt has landed; kt + 1 may be in flight
    __syncthreads();
    const __nv_bfloat16* sa = s_a[kt & 1];
    const __nv_bfloat16* sb = s_b[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const __nv_bfloat16* p =
            sa + (warp_m * 64 + mi * 16 + g) * kLd + kk + t4 * 2;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* p =
            sb + (warp_n * 32 + ni * 8 + g) * kLd + kk + t4 * 2;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();  // the next iteration overwrites this stage
  }

  // epilogue: + bias, activation, cast; two adjacent channels per store
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = n0 + warp_n * 32 + ni * 8 + t4 * 2;
    const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + warp_m * 64 + mi * 16 + g + half * 8;
        if (m < m_total) {
          const float v0 = act_fn(acc[mi][ni][half * 2] + b0, leaky);
          const float v1 = act_fn(acc[mi][ni][half * 2 + 1] + b1, leaky);
          *reinterpret_cast<__nv_bfloat162*>(out + m * co + n) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
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

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller checks the shapes (CIN % 128 == 0, CO % 128 == 0, ks in {1, 3},
// batch * h * w >= 1), the dtypes, the layouts and 16-byte alignment, and
// allocates `out`. bf16 != 0: x, w and out are bf16; else fp32.
extern "C" int yolo_conv_bias_act(const void* x, const void* w,
                                  const void* bias, void* out, int batch,
                                  int h, int width, int cin, int co, int ks,
                                  int leaky, int bf16, void* stream) {
  const long long m_total = (long long)batch * h * width;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const dim3 grid(static_cast<unsigned>((m_total + kBM - 1) / kBM),
                    co / kBN);
    conv_bf16_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(out), batch, h, width, cin, co, ks, leaky);
  } else {
    const dim3 grid(static_cast<unsigned>((m_total + kFM - 1) / kFM),
                    co / kFN);
    conv_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), batch, h,
        width, cin, co, ks, leaky);
  }
  return static_cast<int>(cudaGetLastError());
}
