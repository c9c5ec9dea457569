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
// 0.05 us at the HBM rate; at batch 1 the launch and one row's dependent
// chain (load, two shuffle reductions, store) are what it waits on.
//
// Design (a simple one that is right): one warp per row, 4 rows per block.
// Each lane owns 8-element chunks c = lane, lane + 32, ... and reads them as
// 16-byte loads (one for bf16, two for f32): 3 chunks a lane at W = 768, 4 at
// 1024, 8 at 2048. Up to 8 chunks a lane the row stays in registers between
// the statistics and the output (instances of 1, 4 and 8 chunks; one of 2
// made ptxas spill at one type combination); a wider row is read a second
// time (the CH = 0 instance). Sum and sum of squares go through the warp's shuffles.
// Every row's sum is taken in the same order on every launch: two launches
// on the same inputs give identical bits.
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

constexpr int kRowsPerBlock = 4;  // one warp a row
constexpr int kChunk = 8;         // elements a lane reads at once

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// CH > 0: the row's chunks stay in registers (W <= 256 * CH); CH == 0: any
// width, the row read twice.
template <typename TH, typename TR, typename TP, int CH>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
add_layer_norm_kernel(const TH* __restrict__ h, const TR* __restrict__ r,
                      const TP* __restrict__ gamma,
                      const TP* __restrict__ beta,
                      OutT<TH, TR>* __restrict__ out, long long rows,
                      int width, int groups, float eps) {
  using TO = OutT<TH, TR>;
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long base = row * width;
  const long long pbase = (long long)(row % groups) * width;
  const int chunks = width / kChunk;
  const float w = (float)width;
  float sum = 0.f, sq = 0.f;
  if constexpr (CH > 0) {
    float v[CH][kChunk];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        load_sum<TH, TR, TO>(h, r, base + (long long)c * kChunk, v[i]);
#pragma unroll
        for (int e = 0; e < kChunk; ++e) {
          sum += v[i][e];
          sq += v[i][e] * v[i][e];
        }
      }
    }
    const float mean = warp_sum(sum) / w;
    const float var = fmaxf(0.f, warp_sum(sq) / w - mean * mean);
    const float rs = rsqrtf(var + eps);
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        float g[kChunk], b[kChunk], y[kChunk];
        load8(gamma + pbase + c * kChunk, g);
        load8(beta + pbase + c * kChunk, b);
#pragma unroll
        for (int e = 0; e < kChunk; ++e) {
          y[e] = (v[i][e] - mean) * (rs * g[e]) + b[e];
        }
        store8(out + base + (long long)c * kChunk, y);
      }
    }
  } else {
    for (int c = lane; c < chunks; c += 32) {
      float s[kChunk];
      load_sum<TH, TR, TO>(h, r, base + (long long)c * kChunk, s);
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        sum += s[e];
        sq += s[e] * s[e];
      }
    }
    const float mean = warp_sum(sum) / w;
    const float var = fmaxf(0.f, warp_sum(sq) / w - mean * mean);
    const float rs = rsqrtf(var + eps);
    for (int c = lane; c < chunks; c += 32) {
      float s[kChunk], g[kChunk], b[kChunk], y[kChunk];
      load_sum<TH, TR, TO>(h, r, base + (long long)c * kChunk, s);
      load8(gamma + pbase + c * kChunk, g);
      load8(beta + pbase + c * kChunk, b);
#pragma unroll
      for (int e = 0; e < kChunk; ++e) y[e] = (s[e] - mean) * (rs * g[e]) + b[e];
      store8(out + base + (long long)c * kChunk, y);
    }
  }
}

template <typename TH, typename TR, typename TP, int CH>
void run(long long rows, const void* h, const void* r, const void* gamma,
         const void* beta, void* out, int width, int groups, float eps,
         cudaStream_t st) {
  const dim3 grid((unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock));
  add_layer_norm_kernel<TH, TR, TP, CH><<<grid, kRowsPerBlock * 32, 0, st>>>(
      static_cast<const TH*>(h), static_cast<const TR*>(r),
      static_cast<const TP*>(gamma), static_cast<const TP*>(beta),
      static_cast<OutT<TH, TR>*>(out), rows, width, groups, eps);
}

template <typename TH, typename TR, typename TP>
int launch(const void* h, const void* r, const void* gamma, const void* beta,
           void* out, long long rows, int width, int groups, float eps,
           cudaStream_t st) {
  const int per_lane = (width / kChunk + 31) / 32;
  if (per_lane <= 1) {
    run<TH, TR, TP, 1>(rows, h, r, gamma, beta, out, width, groups, eps, st);
  } else if (per_lane <= 4) {
    run<TH, TR, TP, 4>(rows, h, r, gamma, beta, out, width, groups, eps, st);
  } else if (per_lane <= 8) {
    run<TH, TR, TP, 8>(rows, h, r, gamma, beta, out, width, groups, eps, st);
  } else {
    run<TH, TR, TP, 0>(rows, h, r, gamma, beta, out, width, groups, eps, st);
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
      (rows + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffffLL ||
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
