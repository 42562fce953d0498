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
// What bounds it: at K <= 256 the work is tiny (at most K^2/2 IoUs, a few
// KB per row) and the greedy pass is a chain of dependent steps, so a row
// is latency-bound, not bandwidth- or FLOP-bound. The design keeps every
// step on chip and short:
//   * one block per row g; the row's boxes and scores in shared memory;
//   * the stop: the first candidate whose score is below conf (s < conf).
//     The scores are sorted, so no candidate from there on can suppress
//     or be kept: only pairs i < j < stop are computed, and the greedy
//     pass ends there. (torch.topk ranks NaN scores first, and a NaN
//     compares false both ways: a NaN is no stop, and the candidates at
//     or above conf after it still suppress.) Past the stop, keep is the
//     score >= conf test alone, as in the plain version;
//   * the suppression bitmask, balanced: each warp takes rows i in turn,
//     and for each 32-column word of the row lane j computes IoU(i, 32w+j)
//     for i < 32w+j < stop only; __ballot_sync gives the word in one step.
//     No thread holds a serial chain of divisions;
//   * the greedy pass in one warp, a word of 32 candidates at a time, with
//     no memory access in its serial chain: the word's active candidates
//     (before the stop, score >= conf: a ballot) less those removed by
//     earlier words; the 32 in-word bitmask words in registers, resolved
//     in order by 32 predicated ANDs; then every lane holding a kept
//     candidate of the word ORs its row into the later words' removal
//     masks at once (__reduce_or_sync);
//   * the block writes keep once.
// Blocks of 16 warps, whatever G: the served path has one row per image,
// and a row's latency falls with the warps that share its IoUs; only the
// exact per-class grid (G = B * 80) would run a little faster on smaller
// blocks.
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
constexpr int kWords = kMaxK / 32;  // a bitmask row: 8 words, two uint4
constexpr int kThreads = 512;       // 16 warps share a row's IoUs

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// dynamic shared memory: the bitmask [k][kWords] uint32, then x1, y1, x2,
// y2, area, class and score, k floats each
__global__ void nms_suppress_kernel(const float* __restrict__ geom,
                                    const float* __restrict__ scores,
                                    const float* __restrict__ classes,
                                    float* __restrict__ keep, int k,
                                    float conf_threshold,
                                    float iou_threshold) {
  extern __shared__ uint4 smem[];
  uint32_t* s_sup = reinterpret_cast<uint32_t*>(smem);
  float* s_x1 = reinterpret_cast<float*>(s_sup + kWords * k);
  float* s_y1 = s_x1 + k;
  float* s_x2 = s_y1 + k;
  float* s_y2 = s_x2 + k;
  float* s_area = s_y2 + k;
  float* s_cls = s_area + k;
  float* s_score = s_cls + k;
  __shared__ uint32_t s_kept[kWords];
  __shared__ int s_stop;

  const int g = blockIdx.x;
  const int tid = threadIdx.x, threads = blockDim.x;
  const float* row = geom + (size_t)g * 5 * k;

  if (tid == 0) s_stop = k;
  __syncthreads();
  for (int i = tid; i < k; i += threads) {
    s_x1[i] = row[i];
    s_y1[i] = row[k + i];
    s_x2[i] = row[2 * k + i];
    s_y2[i] = row[3 * k + i];
    s_area[i] = row[4 * k + i];
    s_cls[i] = classes[(size_t)g * k + i];
    const float s = scores[(size_t)g * k + i];
    s_score[i] = s;
    if (s < conf_threshold) atomicMin(&s_stop, i);
  }
  __syncthreads();
  const int stop = s_stop;
  const int words = (stop + 31) >> 5;  // the words holding columns < stop

  // rows i < stop of the suppressability matrix: bit j set iff
  // i < j < stop, j has i's class and IoU(i, j) > iou_threshold
  const int warp = tid >> 5, lane = tid & 31;
  for (int i = warp; i < stop; i += threads >> 5) {
    const float x1 = s_x1[i], y1 = s_y1[i], x2 = s_x2[i], y2 = s_y2[i];
    const float area = s_area[i], cls = s_cls[i];
    uint32_t mine = 0;  // word `lane` of row i
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      if (w >= words) break;
      if (32 * w + 31 <= i) continue;  // every column ranks at or above i
      const int j = 32 * w + lane;
      bool hit = false;
      if (j > i && j < stop && s_cls[j] == cls) {
        const float iw =
            max_nan(0.0f, min_nan(x2, s_x2[j]) - max_nan(x1, s_x1[j]));
        const float ih =
            max_nan(0.0f, min_nan(y2, s_y2[j]) - max_nan(y1, s_y1[j]));
        const float inter = iw * ih;
        const float uni = area + s_area[j] - inter;
        const float iou = uni > 0.0f ? inter / uni : 0.0f;
        hit = iou > iou_threshold;
      }
      const uint32_t bits = __ballot_sync(0xffffffffu, hit);
      if (lane == w) mine = bits;
    }
    if (lane < kWords) s_sup[i * kWords + lane] = mine;
  }
  __syncthreads();

  // the greedy pass over the candidates before the stop, in warp 0, every
  // lane alike: a candidate is kept when it is active and no kept
  // candidate before it suppresses it; a kept candidate suppresses
  if (warp == 0) {
    uint32_t removed[kWords];  // by kept candidates of earlier words
#pragma unroll
    for (int w = 0; w < kWords; ++w) removed[w] = 0u;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const int j = 32 * w + lane;
      uint32_t kept = 0u;
      if (w < words) {
        kept = __ballot_sync(0xffffffffu,
                             j < stop && s_score[j] >= conf_threshold) &
               ~removed[w];
        // in-word rows: bit b of row[c] says 32w + c suppresses 32w + b
        uint32_t row[32];
#pragma unroll
        for (int c = 0; c < 32; ++c)
          row[c] = 32 * w + c < stop ? s_sup[(32 * w + c) * kWords + w] : 0u;
#pragma unroll
        for (int c = 0; c < 32; ++c)
          if ((kept >> c) & 1u) kept &= ~row[c];
        // the kept candidates' rows into the later words' masks
        uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
        if ((kept >> lane) & 1u) {
          lo = smem[2 * j];
          hi = smem[2 * j + 1];
        }
        const uint32_t mine[kWords] = {lo.x, lo.y, lo.z, lo.w,
                                       hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int v = w + 1; v < kWords; ++v)
          removed[v] |= __reduce_or_sync(0xffffffffu, mine[v]);
      }
      if (lane == 0) s_kept[w] = kept;
    }
  }
  __syncthreads();

  // before the stop: kept as the greedy pass found; from the stop on, the
  // score >= conf test alone (no row before the stop marks a column there)
  for (int i = tid; i < k; i += threads) {
    const bool kept = i < stop ? ((s_kept[i >> 5] >> (i & 31)) & 1u) != 0u
                               : s_score[i] >= conf_threshold;
    keep[(size_t)g * k + i] = kept ? 1.0f : 0.0f;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller checks g >= 1 and 1 <= k <= 256 and allocates `keep`.
extern "C" int yolo_nms_suppress(const void* geom, const void* scores,
                                 const void* classes, void* keep, int g,
                                 int k, float conf_threshold,
                                 float iou_threshold, void* stream) {
  const size_t smem = (size_t)k * (kWords * 4 + 7 * 4);  // <= 15 KB
  nms_suppress_kernel<<<g, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(geom), static_cast<const float*>(scores),
      static_cast<const float*>(classes), static_cast<float*>(keep), k,
      conf_threshold, iou_threshold);
  return static_cast<int>(cudaGetLastError());
}
