// The TMA ring and wgmma helpers of the port's Hopper conv kernels
// (conv_bias_act.cu's bf16 and fp32 bodies, conv_s8_bias_act.cu's int8
// wgmma body): mbarrier waits and arrivals, TMA copies of a tiled weight
// box and of an im2col activation box, the wgmma descriptor of a K-major
// tile in the 128B swizzle, and the host encoders of the two tensor maps
// of a conv. Each source that includes it gets its own copy (internal
// linkage).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowBytes = 128;   // a tile row of one chunk in shared memory

// Errors of the conv launchers besides CUDA's own codes.
constexpr int kErrPlan = -1;        // a plan the kernels were not built for
constexpr int kErrEntryPoint = -2;  // no tensor-map encoder in the driver
constexpr int kErrTensorMap = -3;   // the driver refused a tensor map

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

// The two tensor maps of a stride-1 conv with K chunks of one row of
// row_bytes (128, 64 or 32: row_bytes / elem_bytes channels) in the
// swizzle of that width: the weights as a row-major (CO, K) matrix, a
// (bn x chunk) box each; the activations, NHWC, in im2col mode, bm pixels
// x chunk channels each, zeros outside the image.
inline int encode_conv_maps(CUtensorMap* xmap, CUtensorMap* wmap,
                            const void* x, const void* w,
                            CUtensorMapDataType dtype, int elem_bytes, int bm,
                            int bn, int batch, int h, int width, int cin,
                            int co, int ks, int row_bytes = kRowBytes) {
  const EncodeTiledFn tiled = encode_tiled();
  const EncodeIm2colFn im2col = encode_im2col();
  if (tiled == nullptr || im2col == nullptr) return kErrEntryPoint;
  const CUtensorMapSwizzle swizzle =
      row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t kElem = static_cast<cuuint64_t>(elem_bytes);
  const cuuint32_t kChunk = static_cast<cuuint32_t>(row_bytes / elem_bytes);
  const int k_total = ks * ks * cin;
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(k_total),
                               static_cast<cuuint64_t>(co)};
  const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(k_total) * kElem};
  const cuuint32_t wbox[2] = {kChunk, static_cast<cuuint32_t>(bn)};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (tiled(wmap, dtype, 2, const_cast<void*>(w), wdims, wstrides, wbox,
            ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return kErrTensorMap;
  const cuuint64_t xdims[4] = {
      static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(width),
      static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(batch)};
  const cuuint64_t xstrides[3] = {
      static_cast<cuuint64_t>(cin) * kElem,
      static_cast<cuuint64_t>(cin) * kElem * width,
      static_cast<cuuint64_t>(cin) * kElem * width * h};
  const int pad = ks / 2;
  const int lower[2] = {-pad, -pad};
  const int upper[2] = {pad - (ks - 1), pad - (ks - 1)};
  if (im2col(xmap, dtype, 4, const_cast<void*>(x), xdims, xstrides, lower,
             upper, kChunk, static_cast<cuuint32_t>(bm), ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return kErrTensorMap;
  return 0;
}

}  // namespace
