// Darknet maxpool of int8 codes (NHWC), for Hopper (sm_90a).
//
// No Pallas original: the JAX package pools in XLA (yolo_tpu/ops/pool.py,
// lax.reduce_window with the int8 minimum as the fill), also on its
// chained-int8 serving path. Plain version: yolo_tpu_torch/ops/pool.py::
// maxpool_s8_plain, a running torch.maximum of the size x size strided
// views.
//
// Darknet pads size - 1 with the window origin shifted by -(size - 1) / 2
// (lead rows and columns before, the rest after), filled with -128, the
// identity of max. Every window holds at least one tap inside the image,
// so the kernel takes the max over the taps inside and reads no fill.
//
// What bounds it on an H100 (3.35 TB/s): bytes, each input byte read once
// and each output byte written once (YOLOv2-COCO's pools 3-17 read 5.2 MB
// and write 1.3 MB an image: 0.06 ms at batch 32); it does no arithmetic
// to speak of. So one thread takes one output pixel and VEC channels: 16
// when CIN % 16 == 0 (one 16-byte load per window tap, four __vmaxs4, one
// 16-byte store), else 4 or 1; neighbouring threads take neighbouring
// channel groups and pixels, so each warp's loads and stores are
// contiguous, and a 2x2/2 pool reads every input byte once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int VEC>
struct Codes;

template <>
struct Codes<16> {
  uint4 v;
  __device__ __forceinline__ void load(const int8_t* p) {
    v = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void max_with(const Codes& o) {
    v.x = __vmaxs4(v.x, o.v.x);
    v.y = __vmaxs4(v.y, o.v.y);
    v.z = __vmaxs4(v.z, o.v.z);
    v.w = __vmaxs4(v.w, o.v.w);
  }
  __device__ __forceinline__ void store(int8_t* p) const {
    *reinterpret_cast<uint4*>(p) = v;
  }
};

template <>
struct Codes<4> {
  uint32_t v;
  __device__ __forceinline__ void load(const int8_t* p) {
    v = *reinterpret_cast<const uint32_t*>(p);
  }
  __device__ __forceinline__ void max_with(const Codes& o) {
    v = __vmaxs4(v, o.v);
  }
  __device__ __forceinline__ void store(int8_t* p) const {
    *reinterpret_cast<uint32_t*>(p) = v;
  }
};

template <>
struct Codes<1> {
  int8_t v;
  __device__ __forceinline__ void load(const int8_t* p) { v = *p; }
  __device__ __forceinline__ void max_with(const Codes& o) {
    v = o.v > v ? o.v : v;
  }
  __device__ __forceinline__ void store(int8_t* p) const { *p = v; }
};

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    maxpool_s8_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                      int h, int w, int c, int size, int stride, int lead,
                      int ho, int wo, long long total) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int groups = c / VEC;
  const int g = static_cast<int>(i % groups);
  long long t = i / groups;
  const int ox = static_cast<int>(t % wo);
  t /= wo;
  const int oy = static_cast<int>(t % ho);
  const long long n = t / ho;
  const int y0 = oy * stride - lead, x0 = ox * stride - lead;
  const int ylo = max(y0, 0), yhi = min(y0 + size, h);
  const int xlo = max(x0, 0), xhi = min(x0 + size, w);
  const int8_t* src = x + n * h * w * c + g * VEC;
  Codes<VEC> m;
  m.load(src + (static_cast<long long>(ylo) * w + xlo) * c);
  for (int y = ylo; y < yhi; ++y) {
    for (int xx = xlo; xx < xhi; ++xx) {
      if (y == ylo && xx == xlo) continue;
      Codes<VEC> v;
      v.load(src + (static_cast<long long>(y) * w + xx) * c);
      m.max_with(v);
    }
  }
  // out is (n, oy, ox, c): thread i's VEC channels start at i * VEC
  m.store(out + i * VEC);
}

template <int VEC>
int launch(const int8_t* x, int8_t* out, int b, int h, int w, int c,
           int size, int stride, int ho, int wo, cudaStream_t st) {
  const long long total = static_cast<long long>(b) * ho * wo * (c / VEC);
  const long long blocks = (total + kThreads - 1) / kThreads;
  maxpool_s8_kernel<VEC><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      x, out, h, w, c, size, stride, (size - 1) / 2, ho, wo, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or -1
// for arguments the kernel does not take. x (b, h, w, c) and out (b, ho,
// wo, c) int8 NHWC, 16-byte aligned; ho = (h + size - 1 - size) / stride
// + 1, wo alike (the caller computes them); vec = 16 (c % 16 == 0), 4
// (c % 4 == 0) or 1 channels a thread.
extern "C" int yolo_maxpool_s8(const void* x, void* out, int b, int h, int w,
                               int c, int size, int stride, int ho, int wo,
                               int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || h < 1 || w < 1 || c < 1 || size < 1 || stride < 1 ||
      ho < 1 || wo < 1 || c % vec != 0)
    return -1;
  const int8_t* xi = static_cast<const int8_t*>(x);
  int8_t* o = static_cast<int8_t*>(out);
  if (vec == 16) return launch<16>(xi, o, b, h, w, c, size, stride, ho, wo, st);
  if (vec == 4) return launch<4>(xi, o, b, h, w, c, size, stride, ho, wo, st);
  if (vec == 1) return launch<1>(xi, o, b, h, w, c, size, stride, ho, wo, st);
  return -1;
}
