// Residual add + LayerNorm in one pass: y = LayerNorm(h + r) per row, with
// flax nn.LayerNorm(dtype=compute)'s numerics (use_fast_variance=True):
//   s    = round_out(h + r)            (r optional; the sum in the output type)
//   mean = E[s],  var = max(0, E[s^2] - mean^2)   (f32)
//   mul  = rsqrt(var + eps) * gamma               (f32)
//   y    = (s - mean) * mul + beta, written in the output type.
//
// Replaces no Pallas kernel. It stands for the fusion XLA makes of every
// post-LayerNorm of the JAX forward: the residual add, the f32 statistics,
// the affine step and the casts of nn.LayerNorm(x + residual) at
// vilbert_multitask_tpu/models/layers.py:44-50 (AttentionOutput), :68-76
// (FeedForward), the bridges' outputs (:185-215), the embeddings
// (models/embeddings.py:63, :98) and the heads' fused_layer_norm
// (models/heads.py:134). Eager PyTorch ran each site as four launches (the
// add, a cast to f32, F.layer_norm, a cast back), six under int8 (the
// parameters' casts).
//
// Types (the wrapper, ops/layer_norm.py, checks them):
//   (h, r) = (bf16, bf16) -> bf16 out, the sum rounded to bf16 first (the JAX
//   code adds two bf16 arrays); (bf16, f32) -> f32 (the trainer's autocast
//   forward: a bf16 Linear output onto an f32 residual); (f32, f32) -> f32;
//   no r: out in h's type. gamma and beta are f32, or bf16 (the int8 mode's
//   rounded parameters), promoted in registers. They are (W,) or (G, W): row
//   i takes group i % G (the fused label head's (B, 2, W)).
//
// What bounds it on the H100 (3.35 TB/s HBM): every byte is read or written
// once, 2 or 3 rows of W elements per row and 4 FLOP an element, so bytes
// bound it: a bucket-1 text site (38 x 768 bf16, residual) moves ~176 KB,
// 0.05 us at the HBM rate. At batch 1 what it waits on is latency: the
// launch, and one row's chain of loads, reductions and stores.
//
// Design, for that latency (the first design gave a row one warp, 4 rows to
// a block: 10 blocks at a bucket-1 text site, 3-4 dependent 16-byte loads a
// lane, and gamma and beta loaded only after the statistics):
//   - a row is spread over whole warps, one 8-element chunk (16 bytes of
//     bf16) a thread: 3 warps at W = 768, 4 at 1024, 8 at 2048. A block
//     holds one row (up to 4 rows of a one-warp width; 2 of a two-warp
//     one), so a bucket-1 text site runs 38 blocks and a visual one 101;
//   - each thread issues all its loads, h, r, gamma and beta, before any
//     arithmetic: no load waits behind the reductions;
//   - sum and sum of squares go through the warp's shuffles as one pair,
//     then one exchange through shared memory across the row's warps, added
//     in warp order. The order is fixed, so two launches on the same inputs
//     give identical bits;
//   - rows wider than 8 warps of one chunk (W > 2048) take the CH = 0
//     instance: 8 warps loop over the chunks and read the row twice. No
//     served width needs it; it keeps every width a multiple of 8 launchable.
//
// C interface (bound with ctypes): vmt_add_layer_norm launches on the given
// stream, allocates nothing, and returns a cudaError_t as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 8;        // elements a thread reads at once
constexpr int kMaxWarps = 8;     // warps a row, at most (256 threads)
constexpr int kWarpsPerBlock = 4;  // rows of narrow widths share a block

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(b[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The output type of an (h, r) pair: bf16 only when both are bf16.
template <typename TH, typename TR>
using OutT = std::conditional_t<std::is_same_v<TH, bf16> &&
                                    std::is_same_v<TR, bf16>,
                                bf16, float>;

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same_v<T, bf16>) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// s = round_out(h + r) for one chunk (r may be null: s = h).
template <typename TH, typename TR, typename TO>
__device__ __forceinline__ void load_sum(const TH* h, const TR* r,
                                         long long at, float* s) {
  load8(h + at, s);
  if (r != nullptr) {
    float rv[kChunk];
    load8(r + at, rv);
#pragma unroll
    for (int e = 0; e < kChunk; ++e) s[e] = round_to<TO>(s[e] + rv[e]);
  }
}

__device__ __forceinline__ void add_chunk(const float* s, float2& p) {
#pragma unroll
  for (int e = 0; e < kChunk; ++e) {
    p.x += s[e];
    p.y += s[e] * s[e];
  }
}

// The row's (sum, sum of squares): the warp's shuffles, then the row's
// warps added in order through shared memory. Every thread of the block
// calls it (it holds a barrier when a row has more than one warp).
__device__ __forceinline__ float2 row_sums(float2 p, int warps,
                                           float2 (*red)[kMaxWarps]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    p.x += __shfl_xor_sync(0xffffffffu, p.x, o);
    p.y += __shfl_xor_sync(0xffffffffu, p.y, o);
  }
  if (warps == 1) return p;
  if ((threadIdx.x & 31) == 0) red[threadIdx.y][threadIdx.x >> 5] = p;
  __syncthreads();
  float2 t = red[threadIdx.y][0];
  for (int w = 1; w < warps; ++w) {
    t.x += red[threadIdx.y][w].x;
    t.y += red[threadIdx.y][w].y;
  }
  return t;
}

// Block (32 * warps, rows_per_block): threadIdx.y is the row in the block,
// threadIdx.x the thread in the row. CH == 1: one chunk a thread, the row
// in registers (W <= 8 * 32 * warps); CH == 0: any width, the row read
// twice.
template <typename TH, typename TR, typename TP, int CH>
__global__ void __launch_bounds__(kMaxWarps * 32)
add_layer_norm_kernel(const TH* __restrict__ h, const TR* __restrict__ r,
                      const TP* __restrict__ gamma,
                      const TP* __restrict__ beta,
                      OutT<TH, TR>* __restrict__ out, long long rows,
                      int width, int groups, float eps) {
  using TO = OutT<TH, TR>;
  __shared__ float2 red[kWarpsPerBlock][kMaxWarps];
  const int warps = blockDim.x >> 5;
  const int tid = threadIdx.x;
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool real = row < rows;  // no early exit: row_sums holds a barrier
  const long long base = row * width;
  const long long pbase = (long long)(row % groups) * width;
  const int chunks = width / kChunk;
  const float w = (float)width;
  float2 p = make_float2(0.f, 0.f);
  if constexpr (CH == 1) {
    const bool mine = real && tid < chunks;
    const long long at = (long long)tid * kChunk;
    float s[kChunk], g[kChunk], b[kChunk];
    if (mine) {
      load_sum<TH, TR, TO>(h, r, base + at, s);
      load8(gamma + pbase + at, g);
      load8(beta + pbase + at, b);
      add_chunk(s, p);
    }
    const float2 t = row_sums(p, warps, red);
    const float mean = t.x / w;
    const float rs = rsqrtf(fmaxf(0.f, t.y / w - mean * mean) + eps);
    if (mine) {
      float y[kChunk];
#pragma unroll
      for (int e = 0; e < kChunk; ++e) y[e] = (s[e] - mean) * (rs * g[e]) + b[e];
      store8(out + base + at, y);
    }
  } else {
    const int step = blockDim.x;
    if (real) {
      for (int c = tid; c < chunks; c += step) {
        float s[kChunk];
        load_sum<TH, TR, TO>(h, r, base + (long long)c * kChunk, s);
        add_chunk(s, p);
      }
    }
    const float2 t = row_sums(p, warps, red);
    const float mean = t.x / w;
    const float rs = rsqrtf(fmaxf(0.f, t.y / w - mean * mean) + eps);
    if (real) {
      for (int c = tid; c < chunks; c += step) {
        const long long at = (long long)c * kChunk;
        float s[kChunk], g[kChunk], b[kChunk], y[kChunk];
        load_sum<TH, TR, TO>(h, r, base + at, s);
        load8(gamma + pbase + at, g);
        load8(beta + pbase + at, b);
#pragma unroll
        for (int e = 0; e < kChunk; ++e) y[e] = (s[e] - mean) * (rs * g[e]) + b[e];
        store8(out + base + at, y);
      }
    }
  }
}

// A row of `warps` warps: 4 rows a block at one warp, 2 at two, else 1.
template <typename TH, typename TR, typename TP, int CH>
void run(long long rows, int warps, const void* h, const void* r,
         const void* gamma, const void* beta, void* out, int width,
         int groups, float eps, cudaStream_t st) {
  const int per_block = warps < kWarpsPerBlock ? kWarpsPerBlock / warps : 1;
  const dim3 block(32 * warps, per_block);
  const dim3 grid((unsigned)((rows + per_block - 1) / per_block));
  add_layer_norm_kernel<TH, TR, TP, CH><<<grid, block, 0, st>>>(
      static_cast<const TH*>(h), static_cast<const TR*>(r),
      static_cast<const TP*>(gamma), static_cast<const TP*>(beta),
      static_cast<OutT<TH, TR>*>(out), rows, width, groups, eps);
}

template <typename TH, typename TR, typename TP>
int launch(const void* h, const void* r, const void* gamma, const void* beta,
           void* out, long long rows, int width, int groups, float eps,
           cudaStream_t st) {
  const int warps = (width / kChunk + 31) / 32;  // one chunk a thread
  if (warps <= kMaxWarps) {
    run<TH, TR, TP, 1>(rows, warps, h, r, gamma, beta, out, width, groups,
                       eps, st);
  } else {
    run<TH, TR, TP, 0>(rows, kMaxWarps, h, r, gamma, beta, out, width,
                       groups, eps, st);
  }
  return (int)cudaGetLastError();
}

template <typename TH, typename TR>
int launch_params(int p_dtype, const void* h, const void* r,
                  const void* gamma, const void* beta, void* out,
                  long long rows, int width, int groups, float eps,
                  cudaStream_t st) {
  if (p_dtype == 0) {
    return launch<TH, TR, float>(h, r, gamma, beta, out, rows, width, groups,
                                 eps, st);
  }
  return launch<TH, TR, bf16>(h, r, gamma, beta, out, rows, width, groups,
                              eps, st);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype codes: 0 f32, 1 bf16; r_dtype -1 when there is no residual (r null).
extern "C" int vmt_add_layer_norm(int h_dtype, int r_dtype, int p_dtype,
                                  const void* h, const void* r,
                                  const void* gamma, const void* beta,
                                  void* out, long long rows, int width,
                                  int groups, float eps, void* stream) {
  const bool no_r = r_dtype == -1;
  if (rows < 1 || width < kChunk || width % kChunk != 0 || groups < 1 ||
      rows > 0x7fffffffLL ||
      (h_dtype != 0 && h_dtype != 1) || (p_dtype != 0 && p_dtype != 1) ||
      (no_r != (r == nullptr)) || (!no_r && r_dtype != 0 && r_dtype != 1) ||
      (h_dtype == 0 && r_dtype == 1) || !aligned16(h) || !aligned16(gamma) ||
      !aligned16(beta) || !aligned16(out) || (!no_r && !aligned16(r))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h_dtype == 0) {  // f32 h, f32 or no r
    return launch_params<float, float>(p_dtype, h, r, gamma, beta, out, rows,
                                       width, groups, eps, st);
  }
  if (r_dtype == 0) {  // the autocast pair: bf16 h, f32 r -> f32
    return launch_params<bf16, float>(p_dtype, h, r, gamma, beta, out, rows,
                                      width, groups, eps, st);
  }
  return launch_params<bf16, bf16>(p_dtype, h, r, gamma, beta, out, rows,
                                   width, groups, eps, st);
}
