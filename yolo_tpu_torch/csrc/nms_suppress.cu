// Greedy same-class NMS suppression pass for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel yolo_tpu/ops/pallas/nms_kernel.py::suppress
// (body _suppress_kernel). Same contract:
//   geom    (G, 5, K) f32 rows [x1, y1, x2, y2, area]
//   scores  (G, K)    f32, sorted descending within each row
//   classes (G, K)    f32 class ids (-1 = off)
//   keep    (G, K)    f32 in {0, 1}
// Box i suppresses a lower-ranked box j of the same class with
// IoU(i, j) > iou_t only while i is itself kept and score_i >= conf;
// finally keep &= score >= conf. K <= 256.
//
// What bounds it: at K <= 256 the work is tiny (K^2 IoUs, a few KB per row)
// and the greedy pass is K dependent steps, so a row is latency-bound, not
// bandwidth- or FLOP-bound. The design keeps every step on chip:
//   * one block per row g, one thread per candidate i (blockDim = K rounded
//     up to 32);
//   * thread i builds row i of the suppression bitmask (K/32 uint32 words
//     per row, K*K/8 bytes per block) in shared memory;
//   * one warp then runs the K greedy steps on a removal bitmask held in
//     registers, lane w owning word w: each step is one shuffle and one
//     shared-memory load, with no block-wide barrier;
//   * the block writes keep once.
//
// The IoU must match the plain version (yolo_tpu_torch/ops/nms.py
// _suppress_torch) bit for bit, or a keep bit can flip at the threshold:
// the same operation order as nms_kernel.py:48-59, IEEE division, and the
// build passes -fmad=false so no multiply-add is contracted into an FMA.
// min/max propagate NaN as jnp.minimum/jnp.maximum and torch.minimum do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 256;
constexpr int kMaxWords = kMaxK / 32;

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__global__ void nms_suppress_kernel(const float* __restrict__ geom,
                                    const float* __restrict__ scores,
                                    const float* __restrict__ classes,
                                    float* __restrict__ keep, int k,
                                    float conf_threshold,
                                    float iou_threshold) {
  __shared__ float s_x1[kMaxK], s_y1[kMaxK], s_x2[kMaxK], s_y2[kMaxK];
  __shared__ float s_area[kMaxK], s_cls[kMaxK], s_score[kMaxK];
  __shared__ uint32_t s_sup[kMaxK][kMaxWords];
  __shared__ uint32_t s_removed[kMaxWords];

  const int g = blockIdx.x;
  const int i = threadIdx.x;
  const int words = (k + 31) >> 5;
  const float* row = geom + (size_t)g * 5 * k;

  if (i < k) {
    s_x1[i] = row[i];
    s_y1[i] = row[k + i];
    s_x2[i] = row[2 * k + i];
    s_y2[i] = row[3 * k + i];
    s_area[i] = row[4 * k + i];
    s_cls[i] = classes[(size_t)g * k + i];
    s_score[i] = scores[(size_t)g * k + i];
  }
  __syncthreads();

  // row i of the suppressability matrix: bit j set iff j ranks below i,
  // j has i's class and IoU(i, j) > iou_threshold
  if (i < k) {
    const float x1 = s_x1[i], y1 = s_y1[i], x2 = s_x2[i], y2 = s_y2[i];
    const float area = s_area[i], cls = s_cls[i];
    for (int w = 0; w < words; ++w) {
      uint32_t bits = 0;
      const int j_end = min(k, (w + 1) * 32);
      for (int j = max(w * 32, i + 1); j < j_end; ++j) {
        const float iw = max_nan(0.0f, min_nan(x2, s_x2[j]) - max_nan(x1, s_x1[j]));
        const float ih = max_nan(0.0f, min_nan(y2, s_y2[j]) - max_nan(y1, s_y1[j]));
        const float inter = iw * ih;
        const float uni = area + s_area[j] - inter;
        const float iou = uni > 0.0f ? inter / uni : 0.0f;
        if (cls == s_cls[j] && iou > iou_threshold) bits |= 1u << (j & 31);
      }
      s_sup[i][w] = bits;
    }
  }
  __syncthreads();

  // sequential greedy pass in warp 0; lane w holds removal word w
  if (i < 32) {
    uint32_t removed = 0;
    for (int step = 0; step < k; ++step) {
      const uint32_t word = __shfl_sync(0xffffffffu, removed, step >> 5);
      const bool kept = ((word >> (step & 31)) & 1u) == 0u;
      if (kept && s_score[step] >= conf_threshold && i < words)
        removed |= s_sup[step][i];
    }
    if (i < words) s_removed[i] = removed;
  }
  __syncthreads();

  if (i < k) {
    const bool kept = ((s_removed[i >> 5] >> (i & 31)) & 1u) == 0u;
    keep[(size_t)g * k + i] =
        (kept && s_score[i] >= conf_threshold) ? 1.0f : 0.0f;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller checks g >= 1 and 1 <= k <= 256 and allocates `keep`.
extern "C" int yolo_nms_suppress(const void* geom, const void* scores,
                                 const void* classes, void* keep, int g,
                                 int k, float conf_threshold,
                                 float iou_threshold, void* stream) {
  const int threads = ((k + 31) / 32) * 32;
  nms_suppress_kernel<<<g, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(geom), static_cast<const float*>(scores),
      static_cast<const float*>(classes), static_cast<float*>(keep), k,
      conf_threshold, iou_threshold);
  return static_cast<int>(cudaGetLastError());
}
