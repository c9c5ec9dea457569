// The dense attention's scaled, masked softmax in one pass, per score row:
//   p = round_c(softmax_f32(round_c(round_c(s * c) + round_c(b))))
// with s the (B, H, Nq, Nk) scores in the compute type c (bf16 or f32), c the
// scale 1 / sqrt(head_dim) in that type, and b the (B, 1, 1, Nk) additive
// mask bias broadcast over heads and queries (optional).
//
// Replaces no Pallas kernel. It stands for the fusion XLA makes of
// vilbert_multitask_tpu/ops/attention.py:49-59 (multi_head_attention: the
// scale, `scores + bias.astype(dtype)`, the f32 softmax and the cast back),
// which runs in the 12 text self-attention layers of every forward: their
// head_dim of 64 fails the flash kernel's % 128 gate (:114). Eager PyTorch
// ran it as six launches (the scale, the bias cast, the add, a cast to f32,
// softmax, a cast back). The probabilities stay the output, as in the JAX
// function: the bridges' attention maps are read from them.
//
// Both roundings in the compute type are the reference's (`scores * scale`,
// then `+ bias.astype(dtype)`); the max, the exponentials, their sum and the
// division are f32, and p is rounded once to the compute type.
//
// What bounds it on the H100 (3.35 TB/s HBM): each score is read once and
// each probability written once (4 bytes an element in bf16, 8 in f32; the
// bias row adds B * Nk elements), against ~6 FLOP an element: bytes bound
// it. A bucket-1 text layer (12 x 38 x 38 bf16) moves ~70 KB, 0.02 us at
// the HBM rate; the launch is what it waits on.
//
// Design (a simple one that is right): one warp per (b, h, q) row, 4 rows
// per block. Lane j holds keys j, j + 32, ... in registers (the served rows
// have 38 or 101 keys: 2 or 4 a lane); rows of up to 512 keys stay in
// registers, longer ones are read three times (the PER = 0 instance). The
// row max and the sum go through the warp's shuffles, in the same order on
// every launch: two launches on the same inputs give identical bits. The
// scores are read through their (B, H, Nq) strides (the key axis
// contiguous); the output is contiguous (B, H, Nq, Nk).
//
// C interface (bound with ctypes): vmt_scaled_masked_softmax launches on the
// given stream, allocates nothing, and returns a cudaError_t as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRowsPerBlock = 4;  // one warp a row

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same_v<T, bf16>) {
    return __float2bfloat16_rn(x);
  } else {
    return x;
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The scaled, biased score of key k, rounded as the reference rounds it.
template <typename TS, typename TB>
__device__ __forceinline__ float logit(const TS* s, const TB* b, int k,
                                       float scale) {
  float x = round_to<TS>(to_f32(s[k]) * scale);
  if (b != nullptr) x = round_to<TS>(x + round_to<TS>(to_f32(b[k])));
  return x;
}

// PER > 0: keys lane, lane + 32, ... held in registers (Nk <= 32 * PER);
// PER == 0: any Nk, the row read three times.
template <typename TS, typename TB, int PER>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
scaled_masked_softmax_kernel(const TS* __restrict__ scores,
                             const TB* __restrict__ bias,
                             TS* __restrict__ out, long long rows, int H,
                             int Nq, int Nk, long long s_sb, long long s_sh,
                             long long s_sq, long long b_sb, float scale) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int q = (int)(row % Nq);
  const long long bh = row / Nq;
  const int h = (int)(bh % H);
  const long long b = bh / H;
  const TS* s = scores + b * s_sb + h * s_sh + q * s_sq;
  const TB* brow = bias != nullptr ? bias + b * b_sb : nullptr;
  TS* o = out + row * Nk;
  if constexpr (PER > 0) {
    float v[PER];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int k = lane + 32 * i;
      v[i] = k < Nk ? logit(s, brow, k, scale) : -INFINITY;
      m = fmaxf(m, v[i]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int k = lane + 32 * i;
      v[i] = k < Nk ? expf(v[i] - m) : 0.f;
      sum += v[i];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int k = lane + 32 * i;
      if (k < Nk) o[k] = from_f32<TS>(v[i] / sum);
    }
  } else {
    float m = -INFINITY;
    for (int k = lane; k < Nk; k += 32) m = fmaxf(m, logit(s, brow, k, scale));
    m = warp_max(m);
    float sum = 0.f;
    for (int k = lane; k < Nk; k += 32) sum += expf(logit(s, brow, k, scale) - m);
    sum = warp_sum(sum);
    for (int k = lane; k < Nk; k += 32) {
      o[k] = from_f32<TS>(expf(logit(s, brow, k, scale) - m) / sum);
    }
  }
}

template <typename TS, typename TB, int PER>
void run(const void* s, const void* b, void* out, long long rows, int H,
         int Nq, int Nk, long long s_sb, long long s_sh, long long s_sq,
         long long b_sb, float scale, cudaStream_t st) {
  const dim3 grid((unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock));
  scaled_masked_softmax_kernel<TS, TB, PER><<<grid, kRowsPerBlock * 32, 0,
                                              st>>>(
      static_cast<const TS*>(s), static_cast<const TB*>(b),
      static_cast<TS*>(out), rows, H, Nq, Nk, s_sb, s_sh, s_sq, b_sb, scale);
}

template <typename TS, typename TB>
int launch(const void* s, const void* b, void* out, long long rows, int H,
           int Nq, int Nk, long long s_sb, long long s_sh, long long s_sq,
           long long b_sb, float scale, cudaStream_t st) {
  if (Nk <= 32 * 4) {
    run<TS, TB, 4>(s, b, out, rows, H, Nq, Nk, s_sb, s_sh, s_sq, b_sb, scale,
                   st);
  } else if (Nk <= 32 * 16) {
    run<TS, TB, 16>(s, b, out, rows, H, Nq, Nk, s_sb, s_sh, s_sq, b_sb,
                    scale, st);
  } else {
    run<TS, TB, 0>(s, b, out, rows, H, Nq, Nk, s_sb, s_sh, s_sq, b_sb, scale,
                   st);
  }
  return (int)cudaGetLastError();
}

template <typename TS>
int launch_bias(int b_dtype, const void* s, const void* b, void* out,
                long long rows, int H, int Nq, int Nk, long long s_sb,
                long long s_sh, long long s_sq, long long b_sb, float scale,
                cudaStream_t st) {
  if (b_dtype == 0) {
    return launch<TS, float>(s, b, out, rows, H, Nq, Nk, s_sb, s_sh, s_sq,
                             b_sb, scale, st);
  }
  // bf16 bias, or none (b null: the bias type is then unused)
  return launch<TS, bf16>(s, b, out, rows, H, Nq, Nk, s_sb, s_sh, s_sq, b_sb,
                          scale, st);
}

}  // namespace

// dtype codes: 0 f32, 1 bf16; b_dtype -1 when there is no bias (b null).
extern "C" int vmt_scaled_masked_softmax(int s_dtype, int b_dtype,
                                         const void* s, const void* b,
                                         void* out, int B, int H, int Nq,
                                         int Nk, long long s_sb,
                                         long long s_sh, long long s_sq,
                                         long long b_sb, float scale,
                                         void* stream) {
  const long long rows = (long long)B * H * Nq;
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 ||
      (rows + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffffLL ||
      (s_dtype != 0 && s_dtype != 1) ||
      (b_dtype != -1 && b_dtype != 0 && b_dtype != 1) ||
      ((b_dtype == -1) != (b == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_dtype == 0) {
    return launch_bias<float>(b_dtype, s, b, out, rows, H, Nq, Nk, s_sb, s_sh,
                              s_sq, b_sb, scale, st);
  }
  return launch_bias<bf16>(b_dtype, s, b, out, rows, H, Nq, Nk, s_sb, s_sh,
                           s_sq, b_sb, scale, st);
}
