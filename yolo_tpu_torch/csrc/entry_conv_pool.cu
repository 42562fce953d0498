// Fused entry layer for Hopper (sm_90a): conv1 3x3 (3 -> cout) + bias +
// leaky(0.1) + maxpool 2x2/2 in one pass.
//
// Replaces the Pallas TPU kernel
// yolo_tpu/ops/pallas/entry_kernel.py::fused_entry_from_planes (body
// _kernel). Same math: an exact fp32 3x3 conv of the fp32 letterboxed
// image, + fp32 bias, leaky(0.1), max over each 2x2 window, cast to the
// output dtype. The bias is the same for the four pool phases and leaky is
// monotone, so the max is taken on the raw sums first:
// out = leaky(max_phase(acc) + b), bit for bit what pooling after the
// epilogue gives on the same sums. Plain version:
// yolo_tpu_torch/ops/entry.py::fused_entry.
//
// Layouts:
//   xpad (B, H+2, W+2, 3) fp32: the letterboxed image with the conv's zero
//        border already in place (ops/entry.py::letterbox_padded emits it)
//   w    (cout, 3, 3, 3) fp32 OIHW, conv1's unrounded fp32 kernel
//   bias (cout,) fp32
//   out  (B, H/2, W/2, cout) bf16 or fp32: NHWC bytes, the channels_last
//        layout the next conv reads
//
// The TPU kernel packed the image into six column-parity planes and put the
// 48 im2col taps on sublanes to satisfy Mosaic's lane rules; none of that
// is needed here. One thread computes the 16 channels of one channel group
// for one pooled pixel: it reads the 4x4x3 input window once into
// registers, runs four 27-tap fp32 dot products per channel (one per pool
// phase), keeps their max, adds the bias, applies leaky and stores the 16
// channels contiguously. The full-resolution conv1 activation (208x208x32
// per image at 416) is never written.
//
// What bounds it: per pooled pixel 4 * 27 * 16 FMAs against 48 input loads
// (mostly L1 hits: neighbouring threads share window rows) and 32 or 64
// output bytes. At 416 that is ~0.3 GFLOP and ~4.8 MB (bf16 out) per image,
// so the FP32 pipes, not memory, set the pace. The weights of a channel
// group (16 x 27 floats) sit in shared memory and are read as broadcasts.
//
// Built with -fmad=false (see conv_bias_act.cu): the dot products are
// spelled as __fmaf_rn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 16;  // output channels per thread
constexpr int kThreads = 128;

__device__ __forceinline__ void store16(float* dst, const float* v) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    d[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* v) {
  uint32_t packed[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    packed[q] = *reinterpret_cast<const uint32_t*>(&p);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  d[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
entry_conv_pool_kernel(const float* __restrict__ xpad,
                       const float* __restrict__ wt,
                       const float* __restrict__ bias,
                       OutT* __restrict__ out, int batch, int h, int w,
                       int cout) {
  __shared__ float s_w[kGroup][27];  // [o][(ky*3 + kx)*3 + c]
  __shared__ float s_bias[kGroup];
  const int o0 = blockIdx.y * kGroup;
  for (int e = threadIdx.x; e < kGroup * 27; e += kThreads) {
    const int o = e / 27, r = e % 27;
    const int tap = r / 3, c = r % 3;  // OIHW source: [o][c][ky][kx]
    s_w[o][r] = wt[((size_t)(o0 + o) * 3 + c) * 9 + tap];
  }
  if (threadIdx.x < kGroup) s_bias[threadIdx.x] = bias[o0 + threadIdx.x];
  __syncthreads();

  const int ho = h >> 1, wo = w >> 1;
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= (long long)batch * ho * wo) return;
  const int j = static_cast<int>(p % wo);
  const long long t = p / wo;
  const int i = static_cast<int>(t % ho);
  const int b = static_cast<int>(t / ho);

  // the 4x4 window of the padded image that the four phases read
  const int wp = w + 2;
  float win[4][4][3];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* src = xpad + (((size_t)b * (h + 2) + 2 * i + r) * wp + 2 * j) * 3;
#pragma unroll
    for (int q = 0; q < 12; ++q) win[r][q / 3][q % 3] = src[q];
  }

  float y[kGroup];
#pragma unroll
  for (int o = 0; o < kGroup; ++o) {
    float best = 0.0f;
#pragma unroll
    for (int phase = 0; phase < 4; ++phase) {
      const int di = phase >> 1, dj = phase & 1;
      float acc = 0.0f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            acc = __fmaf_rn(s_w[o][(ky * 3 + kx) * 3 + c],
                            win[di + ky][dj + kx][c], acc);
      best = phase == 0 ? acc : fmaxf(best, acc);
    }
    const float v = best + s_bias[o];
    y[o] = v > 0.0f ? v : 0.1f * v;
  }
  store16(out + (size_t)p * cout + o0, y);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller checks even h and w, cout % 16 == 0, batch >= 1, the dtypes
// and contiguity, and allocates `out`. out_bf16 != 0: out is bf16; else
// fp32.
extern "C" int yolo_entry_conv_pool(const void* xpad, const void* w,
                                    const void* bias, void* out, int batch,
                                    int h, int width, int cout, int out_bf16,
                                    void* stream) {
  const long long pixels = (long long)batch * (h / 2) * (width / 2);
  const dim3 grid(static_cast<unsigned>((pixels + kThreads - 1) / kThreads),
                  cout / kGroup);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    entry_conv_pool_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(xpad), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
        batch, h, width, cout);
  } else {
    entry_conv_pool_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(xpad), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), batch, h,
        width, cout);
  }
  return static_cast<int>(cudaGetLastError());
}
