// Batched greedy non-maximum suppression -> keep mask, for the detector's
// RPN levels and its per-class region selection.
//
// Replaces no Pallas kernel: the JAX package computes this with XLA, as a
// lax.fori_loop over an IoU matrix vmapped over groups
// (vilbert_multitask_tpu/ops/nms.py:nms_mask, :37, reached from
// detect/model.py:268 for the RPN and from select_top_regions, :62, for the
// per-class selection). The reference ran maskrcnn_benchmark's CUDA NMS.
//
// What it computes, for each group g of G: visit the group's first valid[g]
// boxes in descending score order (ties in index order) and keep a box iff no
// box kept before it has IoU > thresh with it. The Python wrapper
// (ops/nms.py) sorts the scores with torch.sort(stable=True), and hands the
// order in; boxes are read through it, with strides, so one box set shared
// by every group (the per-class selection) is passed with a group stride of
// 0 and never copied. The mask is written in the original box order.
//
// Two kernels, launched back to back by vmt_nms:
//   1. nms_mask_kernel: IoU > thresh as bits, mask[g][i][w] holding the bits
//      of boxes 64w..64w+63 (sorted positions) against box i. One block of
//      64 threads per (64 rows, 64 columns, group): the column boxes go to
//      shared memory, each thread owns one row.
//   2. nms_scan_kernel: one warp per group walks the sorted boxes in order.
//      The "removed" bitset lives in registers, word w in lane w % 32; at box
//      i the owner lane's bit is broadcast with one shuffle, and a kept box
//      ORs its mask row into the bitset. Rows are loaded 8 at a time ahead of
//      the walk (they do not depend on it), so the walk waits on memory once
//      per 8 boxes, not once per kept box.
//
// The IoU is computed with __fmul_rn / __fsub_rn / __fadd_rn / __fdiv_rn, in
// the order of the plain version (box_iou): w = max(min(x2) - max(x1), 0),
// inter = w * h, union = (area_a + area_b) - inter, iou = inter / union where
// union > 0, else 0. No product is contracted into an FMA, so every bit
// equals the plain version's and the keep masks compare exactly.
//
// What bounds it on the H100 (3.35 TB/s, 67 TFLOP/s f32): the function reads
// boxes and scores and writes one byte per box (RPN: 5 x 1000 boxes, 0.1 MB;
// selection: 1600 x 300 scores and 300 shared boxes, 2.4 MB), and the greedy
// walk needs one IoU (13 f32 operations) per box and box kept before it, a
// count that depends on the data: chip_smoke.py computes both bounds from
// each run's keep masks, and bytes bound both shapes. This kernel computes
// every pair's IoU instead (5 x 1000^2 and 1600 x 300^2) and keeps the
// bitmask in device memory (0.6 MB and 19 MB), and its walk is a chain of N
// dependent steps per group: a latency bound, far above either.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBits = 64;   // boxes per mask word, threads per mask block
constexpr int kAhead = 8;   // mask rows loaded per step of the walk
constexpr int kMaxWordsPerLane = 4;  // N <= 32 * 4 * 64 = 8192

struct Box {
  float x1, y1, x2, y2;
};

__device__ __forceinline__ Box load_box(const float* boxes, long long sn,
                                        long long sc, long long idx) {
  const float* p = boxes + idx * sn;
  return Box{p[0], p[sc], p[2 * sc], p[3 * sc]};
}

__device__ __forceinline__ float area_of(const Box& b) {
  return __fmul_rn(__fsub_rn(b.x2, b.x1), __fsub_rn(b.y2, b.y1));
}

__device__ __forceinline__ bool overlaps(const Box& a, float area_a,
                                         const Box& b, float area_b,
                                         float thresh) {
  const float w = fmaxf(__fsub_rn(fminf(a.x2, b.x2), fmaxf(a.x1, b.x1)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.y2, b.y2), fmaxf(a.y1, b.y1)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float iou = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
  return iou > thresh;
}

__global__ void __launch_bounds__(kBits) nms_mask_kernel(
    const float* __restrict__ boxes, long long sg, long long sn, long long sc,
    const long long* __restrict__ order, const int* __restrict__ valid,
    int N, int W, float thresh, unsigned long long* __restrict__ mask) {
  const int g = blockIdx.z;
  const int n_valid = valid[g];
  const int row0 = blockIdx.y * kBits, col0 = blockIdx.x * kBits;
  if (row0 >= n_valid || col0 >= n_valid) return;  // never read by the walk
  const float* gb = boxes + (long long)g * sg;
  const long long* go = order + (long long)g * N;
  __shared__ Box cols[kBits];
  __shared__ float col_area[kBits];
  const int t = threadIdx.x;
  const int n_cols = min(kBits, n_valid - col0);
  if (t < n_cols) {
    const Box b = load_box(gb, sn, sc, go[col0 + t]);
    cols[t] = b;
    col_area[t] = area_of(b);
  }
  __syncthreads();
  const int i = row0 + t;
  if (i >= n_valid) return;
  const Box a = load_box(gb, sn, sc, go[i]);
  const float area_a = area_of(a);
  unsigned long long bits = 0;
  for (int j = 0; j < n_cols; ++j) {
    if (overlaps(a, area_a, cols[j], col_area[j], thresh)) bits |= 1ull << j;
  }
  mask[((long long)g * N + i) * W + blockIdx.x] = bits;
}

template <int WPL>
__global__ void __launch_bounds__(32) nms_scan_kernel(
    const unsigned long long* __restrict__ mask,
    const long long* __restrict__ order, const int* __restrict__ valid,
    int N, int W, unsigned char* __restrict__ keep) {
  const int g = blockIdx.x, lane = threadIdx.x;
  const int n_valid = valid[g];
  const int n_words = (n_valid + kBits - 1) / kBits;  // words of valid boxes
  const unsigned long long* gm = mask + (long long)g * N * W;
  const long long* go = order + (long long)g * N;
  unsigned char* gk = keep + (long long)g * N;
  unsigned long long removed[WPL];
#pragma unroll
  for (int k = 0; k < WPL; ++k) removed[k] = 0;
  for (int base = 0; base < n_valid; base += kAhead) {
    unsigned long long rows[kAhead][WPL];
#pragma unroll
    for (int r = 0; r < kAhead; ++r) {
#pragma unroll
      for (int k = 0; k < WPL; ++k) {
        const int w = lane + 32 * k;
        rows[r][k] = (base + r < n_valid && w < n_words)
                         ? gm[(long long)(base + r) * W + w] : 0ull;
      }
    }
#pragma unroll
    for (int r = 0; r < kAhead; ++r) {
      const int i = base + r;
      if (i >= n_valid) break;
      const int word = i / kBits, slot = word / 32;
      unsigned long long mine = 0;
#pragma unroll
      for (int k = 0; k < WPL; ++k) {
        if (k == slot) mine = removed[k];
      }
      const unsigned long long owner = __shfl_sync(0xffffffffu, mine,
                                                   word % 32);
      const bool kept = !((owner >> (i % kBits)) & 1ull);
      if (lane == 0) gk[go[i]] = kept ? 1 : 0;
      if (kept) {
#pragma unroll
        for (int k = 0; k < WPL; ++k) removed[k] |= rows[r][k];
      }
    }
  }
  // Positions past the group's valid count (padding) are never kept.
  for (int i = n_valid + lane; i < N; i += 32) gk[go[i]] = 0;
}

}  // namespace

// boxes: float32, box (g, i) at boxes + g*sg + i*sn, its 4 coordinates sc
// apart (sg may be 0); order: (G, N) int64 contiguous, the descending-score
// order of each group; valid: (G,) int32, boxes counted per group (the
// order puts the others last); mask: (G, N, ceil(N/64)) uint64 scratch;
// keep: (G, N) bytes, 0 or 1, in the original order. Returns the CUDA error
// of the launches (0 when both were accepted).
extern "C" int vmt_nms(const float* boxes, long long sg, long long sn,
                       long long sc, const long long* order, const int* valid,
                       int G, int N, float thresh, void* mask, void* keep,
                       void* stream) {
  const int W = (N + kBits - 1) / kBits;
  if (G < 1 || G > 65535 || N < 1 || W > 32 * kMaxWordsPerLane ||
      W > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* m = static_cast<unsigned long long*>(mask);
  auto* k = static_cast<unsigned char*>(keep);
  nms_mask_kernel<<<dim3(W, W, G), kBits, 0, st>>>(
      boxes, sg, sn, sc, order, valid, N, W, thresh, m);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  if (W <= 32) {
    nms_scan_kernel<1><<<G, 32, 0, st>>>(m, order, valid, N, W, k);
  } else {
    nms_scan_kernel<kMaxWordsPerLane><<<G, 32, 0, st>>>(m, order, valid, N,
                                                        W, k);
  }
  return (int)cudaGetLastError();
}

extern "C" int vmt_nms_max_boxes() { return 32 * kMaxWordsPerLane * kBits; }
