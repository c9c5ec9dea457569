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
// box kept before it has IoU > thresh with it. The mask is written in the
// original box order. Boxes and scores are read where they lie, through
// their strides: the selection's 1600 class groups share one set of 300
// boxes (a group stride of 0) and its scores are a transposed view of the
// (300, 1601) softmax (neighbouring groups are neighbouring floats).
//
// The order is made here, not by the caller: each group's keys
// (descending-score rank << 32 | index; -0 equals +0, NaN first as
// torch.sort puts it, positions past valid[g] after every score) are sorted
// ascending by a bitonic sort, a power of two (sort_len, >= 32) long. That
// is torch.sort(descending=True, stable=True) on the scores with the
// padding set to -inf: ops/nms.py:_order, the plain order.
//
// Three routes, chosen from the shape by ops/nms.py:plan_launch:
//
// Shared box set (group stride 0; the selection, 1600 x 300): the N x N
// "IoU > thresh" bitmask is made ONCE, in the original order, ceil(N/64)
// words a row (12 KB at N = 300), 4 threads a row, 16 columns each. For
// N <= 512:
//   - nms_sort_kernel: its first blocks make the bitmask (16 rows by 64
//     columns each). In the others a warp per group sorts its keys in
//     registers (16 a lane at N = 300; partners in other lanes meet
//     through shuffles) and writes the group's order, the orders of 32
//     neighbouring groups side by side. Blocks of 2 groups spread the
//     sort's warps evenly over the SMs; a block loads its groups' scores
//     together, neighbouring threads on neighbouring groups (the
//     selection's scores are a transposed view: neighbouring floats).
//   - nms_walk_segments_kernel: a block of 256 threads serves 32 groups,
//     8 lanes each, lane w holding word w of the group's "removed" and
//     "kept" bitsets. The mask rows and the 32 orders are staged in shared
//     memory once per block. At sorted position i the owner lane's word is
//     broadcast within the 8 lanes by one shuffle; a kept box ORs its mask
//     row in, one word a lane. The walk runs in the original index space.
// and for N > 512 nms_pairs_kernel makes the bitmask (64 x 64 tiles),
// then
// nms_walk_shared_kernel: a warp per group sorts its keys
// in shared memory and walks them the same way with 32 lanes, staging the
// mask once per block when it fits beside the keys (N <= ~1280), else
// reading it from L2.
// Own boxes per group (the RPN, 5 levels x 1000):
//   1. nms_order_kernel: one block per group sorts its keys in shared
//      memory and writes the order.
//   2. nms_sorted_pairs_kernel: each group's bitmask in its sorted order,
//      only the tiles on and above the diagonal (the walk reads no other).
//   3. nms_walk_own_kernel: one block per group resolves 64 boxes at a
//      time. One warp resolves the diagonal 64 x 64 block: lane j's
//      diagonal word is also column j (the IoU is symmetric), so the kept
//      set is iterated to its fixed point with two ballots a round (as many
//      rounds as the longest chain of suppressions, not 64 dependent
//      steps). The block then ORs the kept boxes' rows into the later words
//      in parallel, a warp per word (OR reductions, no atomics), their
//      loads issued before the diagonal is resolved.
//
// The IoU is computed with __fmul_rn / __fsub_rn / __fadd_rn / __fdiv_rn, in
// the order of the plain version (box_iou): w = max(min(x2) - max(x1), 0),
// inter = w * h, union = (area_a + area_b) - inter, iou = inter / union where
// union > 0, else 0; a pair with no intersection has IoU 0 whatever its
// union and skips the division. No product is contracted into an FMA, so
// every bit equals the plain version's and the keep masks compare exactly.
// The IoU is symmetric bit for bit, so one mask row serves a box as either
// operand.
//
// What bounds it on the H100 (3.35 TB/s, 67 TFLOP/s f32): the function reads
// boxes and scores and writes one byte per box (RPN: 5 x 1000 boxes, 0.1 MB;
// selection: 1600 x 300 scores and 300 shared boxes, 2.4 MB), and needs one
// IoU (13 f32 operations) per box and box kept before it, counted once per
// distinct pair for a shared set; chip_smoke.py computes the bound from each
// run's data (RPN ~0.45 us, selection ~0.7 us). This design is bound by
// instruction issue and latency instead: the sort (a bitonic network,
// log2(P)(log2(P)+1)/2 stages) and the walk (a chain of dependent steps per
// group: N shuffles, or ceil(N/64) diagonal rounds for own boxes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kBits = 64;            // boxes per mask word
constexpr int kQuarters = 4;         // threads sharing a mask word's row
constexpr int kPairThreads = kBits * kQuarters;
// The sort kernel's blocks: 2 groups (warps) each, so its ~1600 warps
// spread evenly over the SMs; its bitmask tiles are 16 rows by 64 columns.
constexpr int kSortThreads = kBits;
constexpr int kTileRows = kSortThreads / kQuarters;  // its tiles' rows
constexpr int kMaxWords = 128;       // N <= 128 * 64 = 8192
constexpr int kMaxWordsPerLane = kMaxWords / 32;
constexpr int kMaxWarps = 8;         // groups per block of the shared walk
constexpr int kSegmentMaxBoxes = 512;  // shared sets walked 8 lanes a group
constexpr int kSegLanes = 8;         // lanes a group, one mask word each
constexpr int kSegThreads = 32 * kSegLanes;  // 32 groups a block
constexpr int kAhead = 8;            // positions read ahead by the walk
constexpr int kOwnThreads = 256;     // threads of the own-box walk
constexpr int kOwnWarps = kOwnThreads / 32;
constexpr int kPrefetch = 2;         // mask words a warp loads early
constexpr int kSmemLimit = 232448;   // an H100 block's dynamic shared memory
constexpr u64 kFill = ~0ull;         // sort keys past N

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
  // No intersection: the IoU is 0 whatever the union (0 / union, or the
  // guard's 0), so most pairs skip the division.
  if (inter == 0.f) return 0.f > thresh;
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float iou = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
  return iou > thresh;
}

// The "IoU > thresh" word of one row against 64 columns, by the Q threads
// (neighbouring lanes) that share the row, 64 / Q columns each; returned
// on all Q. Row and column boxes are (group base + index * sn), each index
// taken through `order` when it is given (sorted positions) and as itself
// when it is null.
template <int Q>
__device__ __forceinline__ u64 pair_word(const float* gb, long long sn,
                                         long long sc, const int* order,
                                         int row, int col0, int n_cols,
                                         float thresh, Box* cols,
                                         float* col_area) {
  const int t = threadIdx.x, q = t % Q;
  if (t < n_cols) {
    const Box b = load_box(gb, sn, sc, order ? order[col0 + t] : col0 + t);
    cols[t] = b;
    col_area[t] = area_of(b);
  }
  __syncthreads();
  u64 bits = 0;
  if (row >= 0) {
    const Box a = load_box(gb, sn, sc, order ? order[row] : row);
    const float area_a = area_of(a);
    const int j1 = min(n_cols, (q + 1) * (kBits / Q));
    for (int j = q * (kBits / Q); j < j1; ++j) {
      if (overlaps(a, area_a, cols[j], col_area[j], thresh)) bits |= 1ull << j;
    }
  }
#pragma unroll
  for (int m = 1; m < Q; m <<= 1) bits |= __shfl_xor_sync(0xffffffffu, bits, m);
  return bits;
}

__device__ __forceinline__ int group_valid(const long long* valid, int g,
                                           int N) {
  if (valid == nullptr) return N;
  const long long v = valid[g];
  return v < 0 ? 0 : (v > N ? N : (int)v);
}

// Bits j (lane j) and j + 32 (lane j, second flag) of a warp's 64 flags.
__device__ __forceinline__ u64 ballot64(bool lo, bool hi) {
  return (u64)__ballot_sync(0xffffffffu, lo) |
         ((u64)__ballot_sync(0xffffffffu, hi) << 32);
}

// Ascending rank of a score in torch.sort(descending=True)'s order.
__device__ __forceinline__ unsigned desc_rank(float s) {
  if (s != s) return 0u;  // NaN sorts first
  const unsigned b = __float_as_uint(s == 0.f ? 0.f : s);  // -0 == +0
  const unsigned ascending = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ~ascending;
}

__device__ __forceinline__ u64 sort_key(const float* scores, long long ssg,
                                        long long ssn, int g, int n, int N,
                                        int n_valid) {
  if (n >= N) return kFill;
  if (n >= n_valid) return (0xffffffffull << 32) | (unsigned)n;
  const float s = scores[(long long)g * ssg + (long long)n * ssn];
  return ((u64)desc_rank(s) << 32) | (unsigned)n;
}

// Ascending bitonic sort of n (a power of two) keys by `threads` threads;
// WARP: the threads are one warp (else the whole block).
template <bool WARP>
__device__ void bitonic_sort(u64* keys, int n, int t, int threads) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = t; i < n / 2; i += threads) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const u64 a = keys[lo], b = keys[hi];
        if ((a > b) == ((lo & k) == 0)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      if (WARP) {
        __syncwarp();
      } else {
        __syncthreads();
      }
    }
  }
}

// Ascending bitonic sort of 32 K keys held by one warp in registers, key
// lane * K + r in v[r]: partners within a lane swap registers, partners in
// other lanes meet through one shuffle.
template <int K>
__device__ __forceinline__ void warp_sort(u64 (&v)[K], int lane) {
#pragma unroll
  for (int k = 2; k <= 32 * K; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= K) {
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const int e = lane * K + r;
          const u64 o = __shfl_xor_sync(0xffffffffu, v[r], j / K);
          const bool take_min = ((e & j) == 0) == ((e & k) == 0);
          v[r] = take_min ? (o < v[r] ? o : v[r]) : (o > v[r] ? o : v[r]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < K; ++r) {
          if ((r & j) == 0) {
            const u64 a = v[r], b = v[r | j];
            const bool swap = (a > b) == (((lane * K + r) & k) == 0);
            v[r] = swap ? b : a;
            v[r | j] = swap ? a : b;
          }
        }
      }
    }
  }
}

// ------------------------------------------------------- shared box set
__global__ void __launch_bounds__(kPairThreads) nms_pairs_kernel(
    const float* __restrict__ boxes, long long sn, long long sc, int N,
    int W, float thresh, u64* __restrict__ mask) {
  __shared__ Box cols[kBits];
  __shared__ float col_area[kBits];
  const int col0 = blockIdx.x * kBits;
  const int row = blockIdx.y * kBits + threadIdx.x / kQuarters;
  const u64 bits = pair_word<kQuarters>(boxes, sn, sc, nullptr,
                                        row < N ? row : -1, col0,
                                        min(kBits, N - col0), thresh, cols,
                                        col_area);
  if (row < N && threadIdx.x % kQuarters == 0) {
    mask[(long long)row * W + blockIdx.x] = bits;
  }
}

// The sort keys of a block's `warps` groups g0.. into shared memory, group
// gl's key n at keys[gl * stride + slot(n)]. Neighbouring threads take
// neighbouring groups: the selection's scores are (300, 1600) class
// columns, so they read neighbouring floats.
template <typename Slot>
__device__ __forceinline__ void load_keys(u64* keys, int stride, Slot slot,
                                          const float* scores, long long ssg,
                                          long long ssn,
                                          const long long* valid, int G,
                                          int N, int P, int g0, int warps) {
  for (int i = threadIdx.x; i < warps * P; i += blockDim.x) {
    const int gl = i % warps, n = i / warps, g = g0 + gl;
    keys[gl * stride + slot(n)] =
        g < G ? sort_key(scores, ssg, ssn, g, n, N, group_valid(valid, g, N))
              : kFill;
  }
}

// Shared box set, N <= 512: each warp sorts one group's 32 K keys in
// registers and writes its order (sorted position -> box), group g's
// position i at orders[((g / 32) * N + i) * 32 + g % 32]: the 32 groups of
// one walk block lie together.
// Key n sits at slot (n % K) * 32 + n / K, so lane l reads and writes its K
// keys l * K .. l * K + K - 1 without bank conflicts.
// (Compiled for blocks of up to kPairThreads: for a bound of 64 threads
// ptxas spills a few bytes; it launches with kSortThreads.)
template <int K>
__global__ void __launch_bounds__(kPairThreads) nms_sort_kernel(
    const float* __restrict__ scores, long long ssg, long long ssn,
    const long long* __restrict__ valid, int G, int N,
    unsigned short* __restrict__ orders, const float* __restrict__ boxes,
    long long sn, long long sc, int W, float thresh, u64* __restrict__ mask) {
  extern __shared__ u64 smem[];
  const int tiles = W * ((N + kTileRows - 1) / kTileRows);
  if (blockIdx.x < tiles) {  // 16 rows x 64 columns of the shared bitmask
    __shared__ Box cols[kBits];
    __shared__ float col_area[kBits];
    const int col0 = blockIdx.x % W * kBits;
    const int row = blockIdx.x / W * kTileRows + threadIdx.x / kQuarters;
    const u64 bits = pair_word<kQuarters>(boxes, sn, sc, nullptr,
                                          row < N ? row : -1, col0,
                                          min(kBits, N - col0), thresh, cols,
                                          col_area);
    if (row < N && threadIdx.x % kQuarters == 0) {
      mask[(long long)row * W + blockIdx.x % W] = bits;
    }
    return;
  }
  constexpr int P = 32 * K, kStride = P + 1;  // +1: groups on other banks
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32, g0 = (blockIdx.x - tiles) * warps;
  load_keys(smem, kStride, [](int n) { return (n % K) * 32 + n / K; },
            scores, ssg, ssn, valid, G, N, P, g0, warps);
  __syncthreads();
  const int g = g0 + warp;
  if (g >= G) return;
  const u64* keys = smem + warp * kStride;
  u64 v[K];
#pragma unroll
  for (int r = 0; r < K; ++r) v[r] = keys[r * 32 + lane];
  warp_sort<K>(v, lane);
  unsigned short* go = orders + (long long)(g / 32) * N * 32 + g % 32;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int i = lane * K + r;
    if (i < N) go[i * 32] = (unsigned short)v[r];
  }
}

// Shared box set, N <= 512: each group is walked by 8 lanes of a warp, lane
// w holding word w of the group's "removed" and "kept" bitsets (W <= 8).
// A block of 8 warps serves the 32 groups whose orders lie together,
// staging those orders and the mask rows in shared memory once. At each
// position the owner lane's word is broadcast within the 8 lanes by one
// shuffle, and a kept box ORs its row (one word a lane) in.
__global__ void __launch_bounds__(kSegThreads) nms_walk_segments_kernel(
    const u64* __restrict__ mask, const unsigned short* __restrict__ orders,
    const long long* __restrict__ valid, int G, int N, int W,
    unsigned char* __restrict__ keep) {
  extern __shared__ u64 smem[];
  u64* rows = smem;                   // [N][W]
  u64* kept_s = rows + N * W;         // [32][W]
  auto* ord = reinterpret_cast<unsigned short*>(kept_s + 32 * W);  // [N][32]
  const int t = threadIdx.x, g0 = blockIdx.x * 32;
#pragma unroll 8
  for (int i = t; i < N * W; i += kSegThreads) rows[i] = mask[i];
  // The block's 32 orders, 64 bytes a position, in 16-byte pieces.
  const uint4* src = reinterpret_cast<const uint4*>(orders +
                                                    (long long)g0 * N);
  uint4* dst = reinterpret_cast<uint4*>(ord);
#pragma unroll 8
  for (int i = t; i < N * 4; i += kSegThreads) dst[i] = src[i];
  __syncthreads();
  const int gl = t / kSegLanes, w = t % kSegLanes, g = g0 + gl;
  const int n_valid = g < G ? group_valid(valid, g, N) : 0;
  u64 removed = 0, kept = 0;
  for (int base = 0; base < N; base += kAhead) {
    int box[kAhead];
    u64 row[kAhead];
#pragma unroll
    for (int r = 0; r < kAhead; ++r) {
      const int i = min(base + r, N - 1);
      box[r] = g < G ? ord[i * 32 + gl] : 0;  // no sort wrote past G
      row[r] = w < W ? rows[box[r] * W + w] : 0ull;
    }
#pragma unroll
    for (int r = 0; r < kAhead; ++r) {
      const unsigned word = (unsigned)box[r] / kBits;
      const unsigned shift = (unsigned)box[r] % kBits;
      const u64 owner = __shfl_sync(0xffffffffu, removed, word, kSegLanes);
      const bool take = base + r < n_valid && !((owner >> shift) & 1ull);
      removed |= take ? row[r] : 0ull;  // no branch: the shuffles stay converged
      kept |= take && w == word ? 1ull << shift : 0ull;
    }
  }
  if (w < W) kept_s[gl * W + w] = kept;
  __syncthreads();
  // The block's keep rows lie together: each warp writes its 4 groups'.
  const int lane = t % 32, warp = t / 32;
  for (int q = warp * 4; q < warp * 4 + 4 && g0 + q < G; ++q) {
    unsigned char* gk = keep + (long long)(g0 + q) * N;
    const u64* kq = kept_s + q * W;
#pragma unroll 4
    for (int n = lane; n < N; n += 32) gk[n] = (kq[n / kBits] >> (n % kBits)) & 1;
  }
}

// Shared box set, N > 512: one warp per group sorts its keys in shared
// memory and walks them: the "removed" bitset is word w in lane w % 32; at
// sorted position i the owner lane's bit of box order[i] is broadcast with
// one shuffle, and a kept box ORs its mask row in.
template <int WPL>
__global__ void __launch_bounds__(32 * kMaxWarps) nms_walk_shared_kernel(
    const u64* __restrict__ mask, int staged, const float* __restrict__ scores,
    long long ssg, long long ssn, const long long* __restrict__ valid, int G,
    int N, int W, int P, unsigned char* __restrict__ keep) {
  extern __shared__ u64 smem[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g0 = blockIdx.x * warps;
  const int stride = P + 1;  // groups on other banks
  u64* keys_all = smem + (staged ? N * W : 0);
  u64* kept_all = keys_all + warps * stride;
  if (staged) {
    for (int i = threadIdx.x; i < N * W; i += blockDim.x) smem[i] = mask[i];
  }
  load_keys(keys_all, stride, [](int n) { return n; }, scores, ssg, ssn,
            valid, G, N, P, g0, warps);
  __syncthreads();
  const int g = g0 + warp;
  if (g >= G) return;  // no block-wide barrier below
  u64* keys = keys_all + warp * stride;
  bitonic_sort<true>(keys, P, lane, 32);
  const u64* rows = staged ? smem : mask;
  const int n_valid = group_valid(valid, g, N);
  u64 removed[WPL], kept[WPL];
#pragma unroll
  for (int k = 0; k < WPL; ++k) removed[k] = kept[k] = 0;
  for (int base = 0; base < n_valid; base += kAhead) {
    int box[kAhead];
    u64 row[kAhead][WPL];
#pragma unroll
    for (int r = 0; r < kAhead; ++r) {
      const int i = base + r;
      box[r] = i < n_valid ? (int)(unsigned)keys[i] : 0;
#pragma unroll
      for (int k = 0; k < WPL; ++k) {
        const int w = lane + 32 * k;
        row[r][k] = (i < n_valid && w < W) ? rows[box[r] * W + w] : 0ull;
      }
    }
#pragma unroll
    for (int r = 0; r < kAhead; ++r) {
      if (base + r >= n_valid) break;
      const int word = box[r] / kBits, slot = word / 32;
      u64 mine = 0;
#pragma unroll
      for (int k = 0; k < WPL; ++k) {
        if (k == slot) mine = removed[k];
      }
      const u64 owner = __shfl_sync(0xffffffffu, mine, word % 32);
      const u64 bit = 1ull << (box[r] % kBits);
      if (!(owner & bit)) {
#pragma unroll
        for (int k = 0; k < WPL; ++k) {
          removed[k] |= row[r][k];
          if (k == slot && lane == word % 32) kept[k] |= bit;
        }
      }
    }
  }
  u64* kw = kept_all + warp * W;
#pragma unroll
  for (int k = 0; k < WPL; ++k) {
    const int w = lane + 32 * k;
    if (w < W) kw[w] = kept[k];
  }
  __syncwarp();
  unsigned char* gk = keep + (long long)g * N;
  for (int n = lane; n < N; n += 32) gk[n] = (kw[n / kBits] >> (n % kBits)) & 1;
}

// ------------------------------------------------------ own boxes per group
__global__ void nms_order_kernel(const float* __restrict__ scores,
                                 long long ssg, long long ssn,
                                 const long long* __restrict__ valid, int N,
                                 int P, int* __restrict__ order) {
  extern __shared__ u64 keys[];
  const int g = blockIdx.x, t = threadIdx.x;
  const int n_valid = group_valid(valid, g, N);
  for (int n = t; n < P; n += blockDim.x) {
    keys[n] = sort_key(scores, ssg, ssn, g, n, N, n_valid);
  }
  __syncthreads();
  bitonic_sort<false>(keys, P, t, blockDim.x);
  int* go = order + (long long)g * N;
  for (int i = t; i < N; i += blockDim.x) go[i] = (int)(unsigned)keys[i];
}

__global__ void __launch_bounds__(kPairThreads) nms_sorted_pairs_kernel(
    const float* __restrict__ boxes, long long sg, long long sn, long long sc,
    const int* __restrict__ order, const long long* __restrict__ valid,
    int N, int W, float thresh, u64* __restrict__ mask) {
  const int g = blockIdx.z;
  const int n_valid = group_valid(valid, g, N);
  const int row0 = blockIdx.y * kBits, col0 = blockIdx.x * kBits;
  // The walk reads the diagonal block and the words after it, of valid rows.
  if (blockIdx.x < blockIdx.y || row0 >= n_valid || col0 >= n_valid) return;
  __shared__ Box cols[kBits];
  __shared__ float col_area[kBits];
  const int row = row0 + threadIdx.x / kQuarters;
  const u64 bits = pair_word<kQuarters>(boxes + (long long)g * sg, sn, sc,
                             order + (long long)g * N,
                             row < n_valid ? row : -1, col0,
                             min(kBits, n_valid - col0), thresh, cols,
                             col_area);
  if (row < n_valid && threadIdx.x % kQuarters == 0) {
    mask[((long long)g * N + row) * W + blockIdx.x] = bits;
  }
}

// The boxes kept among 64 consecutive sorted positions, by one warp: box j
// (lane j % 32) is a candidate unless `removed` has it or j >= lim, and is
// kept iff no kept box i < j overlaps it. Row j's diagonal word d[j] is also
// column j (the IoU is symmetric), so lane j tests kept & d[j] & (bits below
// j). Iterating kept = {candidates no kept earlier box overlaps} from all
// candidates reaches the greedy set (the only fixed point: bit j is right
// once the bits below it are, so after at most 64 rounds), and stops when a
// round changes nothing: as many rounds as the longest chain of
// suppressions, not 64 dependent steps.
__device__ __forceinline__ u64 resolve_diagonal(const u64* d, u64 removed,
                                                int lim, int lane) {
  const int j0 = lane, j1 = lane + 32;
  const u64 c0 = d[j0] & ((1ull << j0) - 1), c1 = d[j1] & ((1ull << j1) - 1);
  const bool cand0 = j0 < lim && !((removed >> j0) & 1ull);
  const bool cand1 = j1 < lim && !((removed >> j1) & 1ull);
  u64 k = ballot64(cand0, cand1);
  for (;;) {
    const u64 next = ballot64(cand0 && !(c0 & k), cand1 && !(c1 & k));
    if (next == k) return k;
    k = next;
  }
}

// One warp ORs its lanes' words (two each) into *word; lane 0 writes it.
__device__ __forceinline__ void or_kept_rows(u64* word, u64 v0, u64 v1,
                                             int lane) {
  const u64 v = v0 | v1;
  const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)v);
  const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(v >> 32));
  if (lane == 0) *word |= ((u64)hi << 32) | lo;
}

__global__ void __launch_bounds__(kOwnThreads) nms_walk_own_kernel(
    const u64* __restrict__ mask, const int* __restrict__ order,
    const long long* __restrict__ valid, int N, int W,
    unsigned char* __restrict__ keep) {
  extern __shared__ u64 smem[];
  u64* diag = smem;              // [64 W] each row's diagonal word
  u64* removed = smem + kBits * W;  // [W] sorted positions suppressed
  u64* kept = removed + W;       // [W] sorted positions kept
  const int g = blockIdx.x, t = threadIdx.x;
  const int n_valid = group_valid(valid, g, N);
  const int n_words = (n_valid + kBits - 1) / kBits;
  const u64* gm = mask + (long long)g * N * W;
  for (int p = t; p < kBits * W; p += kOwnThreads) {
    diag[p] = p < n_valid ? gm[(long long)p * W + p / kBits] : 0ull;
  }
  for (int w = t; w < W; w += kOwnThreads) removed[w] = kept[w] = 0;
  __syncthreads();
  const int warp = t / 32, lane = t % 32;
  for (int b = 0; b < n_words; ++b) {
    // The rows of this block's boxes past their diagonal word: warp wp ORs
    // word b + 1 + wp + kOwnWarps * m of the kept rows, lane l holding rows
    // l and l + 32. The first kPrefetch words of each warp are loaded
    // before the diagonal is resolved (they do not depend on it).
    const int lim = min(kBits, n_valid - b * kBits);
    const int rest = n_words - b - 1;
    const u64* rows = gm + (long long)b * kBits * W + b + 1;
    u64 pre[kPrefetch][2];
#pragma unroll
    for (int m = 0; m < kPrefetch; ++m) {
      const int w = warp + kOwnWarps * m;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        pre[m][h] = (w < rest && j < lim) ? rows[(long long)j * W + w] : 0ull;
      }
    }
    if (warp == 0) {
      const u64 k = resolve_diagonal(diag + b * kBits, removed[b], lim, lane);
      if (lane == 0) kept[b] = k;
    }
    __syncthreads();
    const u64 k = kept[b];
    if (k != 0) {
      const bool k0 = (k >> lane) & 1ull, k1 = (k >> (lane + 32)) & 1ull;
#pragma unroll
      for (int m = 0; m < kPrefetch; ++m) {
        const int w = warp + kOwnWarps * m;
        if (w < rest) {
          or_kept_rows(removed + b + 1 + w, k0 ? pre[m][0] : 0ull,
                       k1 ? pre[m][1] : 0ull, lane);
        }
      }
      for (int w = warp + kOwnWarps * kPrefetch; w < rest; w += kOwnWarps) {
        const u64 v0 = k0 && lane < lim ? rows[(long long)lane * W + w] : 0ull;
        const u64 v1 = k1 && lane + 32 < lim
                           ? rows[(long long)(lane + 32) * W + w] : 0ull;
        or_kept_rows(removed + b + 1 + w, v0, v1, lane);
      }
    }
    __syncthreads();
  }
  const int* go = order + (long long)g * N;
  unsigned char* gk = keep + (long long)g * N;
  for (int p = t; p < N; p += kOwnThreads) {
    gk[go[p]] = p < n_valid ? (unsigned char)((kept[p / kBits] >> (p % kBits))
                                              & 1ull)
                            : 0;
  }
}

long long aligned(long long bytes) { return (bytes + 255) / 256 * 256; }

// Let `kernel` take `smem` bytes of dynamic shared memory: the attribute
// is raised to the largest size asked for so far (*allowed, per kernel and
// process; a size above the block's limit is refused).
template <typename Kernel>
cudaError_t fits_smem(Kernel kernel, long long* allowed, long long smem) {
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem <= *allowed) return cudaSuccess;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc == cudaSuccess) *allowed = smem;
  return rc;
}

// The sort kernel for 32 K keys a group, 2 groups a block, after the
// bitmask's tiles as its first blocks.
template <int K>
int sort_shared(const float* scores, long long ssg, long long ssn,
                const long long* valid, int G, int N, const float* boxes,
                long long sn, long long sc, int W, float thresh, u64* mask,
                unsigned short* orders, cudaStream_t st) {
  static long long allowed = -1;
  constexpr int warps = kSortThreads / 32;
  const long long smem = 8LL * warps * (32 * K + 1);
  const cudaError_t rc = fits_smem(nms_sort_kernel<K>, &allowed, smem);
  if (rc != cudaSuccess) return (int)rc;
  const int blocks = W * ((N + kTileRows - 1) / kTileRows) +
                     (G + warps - 1) / warps;
  nms_sort_kernel<K><<<blocks, kSortThreads, smem, st>>>(
      scores, ssg, ssn, valid, G, N, orders, boxes, sn, sc, W, thresh, mask);
  return (int)cudaGetLastError();
}

int walk_segments(const u64* mask, const unsigned short* orders,
                  const long long* valid, int G, int N, int W,
                  unsigned char* keep, cudaStream_t st) {
  static long long allowed = -1;
  const long long smem = 8LL * (N * W + 32 * W) + 2LL * 32 * N;
  const cudaError_t rc = fits_smem(nms_walk_segments_kernel, &allowed, smem);
  if (rc != cudaSuccess) return (int)rc;
  nms_walk_segments_kernel<<<(G + 31) / 32, kSegThreads, smem, st>>>(
      mask, orders, valid, G, N, W, keep);
  return (int)cudaGetLastError();
}

int launch_shared(const float* boxes, long long sn, long long sc,
                  const float* scores, long long ssg, long long ssn,
                  const long long* valid, int G, int N, int W, int P,
                  int warps, int staged, float thresh, u64* mask,
                  unsigned short* orders, unsigned char* keep,
                  cudaStream_t st) {
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  if (P <= kSegmentMaxBoxes) {  // sort and mask in one launch, then walk
    int err;
#define VMT_SORT(K)                                                       \
  sort_shared<K>(scores, ssg, ssn, valid, G, N, boxes, sn, sc, W, thresh, \
                 mask, orders, st)
    switch (P) {
      case 32: err = VMT_SORT(1); break;
      case 64: err = VMT_SORT(2); break;
      case 128: err = VMT_SORT(4); break;
      case 256: err = VMT_SORT(8); break;
      case 512: err = VMT_SORT(16); break;
      default: return (int)cudaErrorInvalidValue;
    }
#undef VMT_SORT
    if (err != 0) return err;
    return walk_segments(mask, orders, valid, G, N, W, keep, st);
  }
  nms_pairs_kernel<<<dim3(W, W), kPairThreads, 0, st>>>(boxes, sn, sc, N, W,
                                                        thresh, mask);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  static long long allowed[2] = {-1, -1};
  const long long smem =
      8LL * ((staged ? (long long)N * W : 0) + (long long)warps * (P + 1 + W));
  const int blocks = (G + warps - 1) / warps;
  if (W <= 32) {
    rc = fits_smem(nms_walk_shared_kernel<1>, &allowed[0], smem);
    if (rc != cudaSuccess) return (int)rc;
    nms_walk_shared_kernel<1><<<blocks, 32 * warps, smem, st>>>(
        mask, staged, scores, ssg, ssn, valid, G, N, W, P, keep);
  } else {
    rc = fits_smem(nms_walk_shared_kernel<kMaxWordsPerLane>, &allowed[1],
                   smem);
    if (rc != cudaSuccess) return (int)rc;
    nms_walk_shared_kernel<kMaxWordsPerLane><<<blocks, 32 * warps, smem,
                                               st>>>(
        mask, staged, scores, ssg, ssn, valid, G, N, W, P, keep);
  }
  return (int)cudaGetLastError();
}

int launch_own(const float* boxes, long long sg, long long sn, long long sc,
               const float* scores, long long ssg, long long ssn,
               const long long* valid, int G, int N, int W, int P,
               float thresh, int* order, u64* mask, unsigned char* keep,
               cudaStream_t st) {
  static long long allowed[2] = {-1, -1};
  const long long sort_smem = 8LL * P;
  const long long walk_smem = 8LL * (kBits + 2) * W;
  if (G > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t rc = fits_smem(nms_order_kernel, &allowed[0], sort_smem);
  if (rc == cudaSuccess) {
    rc = fits_smem(nms_walk_own_kernel, &allowed[1], walk_smem);
  }
  if (rc != cudaSuccess) return (int)rc;
  const int sort_threads = P / 2 < 32 ? 32 : (P / 2 > 1024 ? 1024 : P / 2);
  nms_order_kernel<<<G, sort_threads, sort_smem, st>>>(scores, ssg, ssn,
                                                       valid, N, P, order);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  nms_sorted_pairs_kernel<<<dim3(W, W, G), kPairThreads, 0, st>>>(
      boxes, sg, sn, sc, order, valid, N, W, thresh, mask);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  nms_walk_own_kernel<<<G, kOwnThreads, walk_smem, st>>>(mask, order, valid,
                                                         N, W, keep);
  return (int)cudaGetLastError();
}

}  // namespace

// boxes: float32, box (g, i) at boxes + g*sg + i*sn, its 4 coordinates sc
// apart; sg == 0 takes the shared-set route. scores: float32, (g, i) at
// scores + g*ssg + i*ssn. valid: (G,) int64 boxes counted per group (the
// first ones), or null for all N. sort_len, warps, staged: the launch plan
// of ops/nms.py:plan_launch (a power of two >= max(N, 32); the sort's or
// the shared walk's groups per block; whether that walk stages the mask in
// shared memory). scratch: the plan's scratch bytes, each part 256-byte
// aligned (shared: the N x ceil(N/64) mask, then for N <= 512 the
// (ceil(G/32), N, 32) uint16 orders; own: the (G, N) int32 orders, then the (G, N, ceil(N/64))
// masks). keep: (G, N) bytes, 0 or 1, in the original order. Returns the
// CUDA error of the launches (0 when every one was accepted).
extern "C" int vmt_nms(const float* boxes, long long sg, long long sn,
                       long long sc, const float* scores, long long ssg,
                       long long ssn, const long long* valid, int G, int N,
                       float thresh, int sort_len, int warps, int staged,
                       void* scratch, void* keep, void* stream) {
  const int W = (N + kBits - 1) / kBits;
  if (G < 1 || N < 1 || W > kMaxWords || sort_len < N || sort_len < 32 ||
      (sort_len & (sort_len - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* k = static_cast<unsigned char*>(keep);
  char* base = static_cast<char*>(scratch);
  if (sg == 0) {
    auto* mask = reinterpret_cast<u64*>(base);
    auto* orders = reinterpret_cast<unsigned short*>(
        base + aligned(8LL * N * W));
    return launch_shared(boxes, sn, sc, scores, ssg, ssn, valid, G, N, W,
                         sort_len, warps, staged, thresh, mask, orders, k,
                         st);
  }
  auto* order = reinterpret_cast<int*>(base);
  auto* mask = reinterpret_cast<u64*>(base + aligned(4LL * G * N));
  return launch_own(boxes, sg, sn, sc, scores, ssg, ssn, valid, G, N, W,
                    sort_len, thresh, order, mask, k, st);
}
