// Flash attention for ViLBERT's co-attention bridges and its 128-wide visual
// self-attention: out = softmax(q . k^T * scale + bias) . v, per (batch, head).
//
// Replaces the TPU kernel vilbert_multitask_tpu/ops/coattention.py:_flash_kernel
// (a Pallas kernel reached through flash_cross_attention, pallas_call at
// ops/coattention.py:125). Same function, not a block-by-block copy of it:
// the running max, the running sum and the accumulator are f32 whatever the
// input type, and the output is acc / max(l, 1e-30) written in q's type.
//
// What bounds it on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16 dense), sized
// from the serving shapes, per batch row in bf16 with 8 heads x 128:
//   38 x 101 and 101 x 38: q + k + v + o ~ 570 KB -> 0.17 us of memory time,
//     against 4 * 38 * 101 * 1024 ~ 15.7 MFLOP -> 0.016 us of tensor-core time;
//   101 x 101: ~ 827 KB -> 0.25 us, against 41.8 MFLOP.
// So it is memory-bound, and at batch 1 the launch overhead (a few us) is
// larger than the bound itself. The 18 launches of one forward have a bound
// of about 3.5 us at batch 1 and about 113 us at batch 32.
//
// What this design does about it (the simplest design that is right):
//   - it reads q, k, v in place from the model's (B, N, H, D) layout through
//     the strides it is given, and masks the ragged Nq and Nk edges itself:
//     no transposed or padded copies, which would each cost a pass over the
//     tensors (the TPU wrapper pads N to the tile and D to 128);
//   - scores and probabilities live in shared memory only: the (Nq, Nk)
//     matrix never reaches device memory;
//   - one block per (query tile of 16 rows, head, batch row); K and V stream
//     through shared memory in tiles of 32 keys with the online-softmax
//     recurrence, so a block reads each key once. The 3 or 7 query tiles of
//     one (batch, head) read the same K and V, mostly from L2;
//   - products are f32 FMAs on CUDA cores. wgmma, TMA and a persistent
//     schedule that would also hide the launch overhead are later work.
// Static shared memory: 16x128 (q) + 32x129 (k, padded against bank
// conflicts) + 32x128 (v) + 16x33 (scores) floats = 43,200 bytes, under the
// 48 KB static limit.
//
// C interface (bound with ctypes): vmt_flash_attn launches on the given
// stream, allocates nothing, and returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 16;            // query rows per block
constexpr int BK = 32;            // keys per shared-memory tile
constexpr int DMAX = 128;         // largest head_dim
constexpr int NT = 128;           // threads per block
constexpr int TPR = NT / BQ;      // threads per query row (8)
constexpr int CPT = DMAX / TPR;   // output columns per thread (16)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {  // element strides of the batch, sequence and head axes
  long long b, n, h;
};

template <typename T>
__global__ void __launch_bounds__(NT) flash_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ bias, T* __restrict__ out, int Nq, int Nk, int D,
    Strides qs, Strides ks, Strides vs, long long bias_sb, long long bias_sn,
    Strides os, float scale) {
  __shared__ float q_s[BQ][DMAX];
  __shared__ float k_s[BK][DMAX + 1];
  __shared__ float v_s[BK][DMAX];
  __shared__ float s_s[BQ][BK + 1];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* bb = bias + b * bias_sb;

  for (int i = tid; i < BQ * DMAX; i += NT) {
    const int r = i / DMAX, d = i % DMAX;
    float x = 0.f;
    if (q0 + r < Nq && d < D) x = to_f32(qb[(long long)(q0 + r) * qs.n + d]);
    q_s[r][d] = x;
  }

  const int row = tid / TPR;
  const int sub = tid % TPR;
  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += BK) {
    __syncthreads();  // q is loaded; the previous tile's readers are done
    for (int i = tid; i < BK * DMAX; i += NT) {
      const int c = i / DMAX, d = i % DMAX;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < Nk && d < D) {
        kx = to_f32(kb[(long long)(k0 + c) * ks.n + d]);
        vx = to_f32(vb[(long long)(k0 + c) * vs.n + d]);
      }
      k_s[c][d] = kx;
      v_s[c][d] = vx;
    }
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      float s = -INFINITY;  // keys past Nk contribute nothing
      if (k0 + c < Nk) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(q_s[r][d], k_s[c][d], dot);
        s = dot * scale + to_f32(bb[(long long)(k0 + c) * bias_sn]);
      }
      s_s[r][c] = s;
    }
    __syncthreads();
    // Every tile holds at least one key below Nk, and the bias is finite,
    // so m_new is finite and exp(-inf - m_new) is an exact 0.
    float mt = -INFINITY;
    for (int c = 0; c < BK; ++c) mt = fmaxf(mt, s_s[row][c]);
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);  // 0 on the first tile
    l *= alpha;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float p = expf(s_s[row][c] - m_new);
      l += p;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[j] = fmaf(p, v_s[c][sub + TPR * j], acc[j]);
    }
    m = m_new;
  }

  if (q0 + row < Nq) {
    const float denom = fmaxf(l, 1e-30f);
    T* ob = out + b * os.b + h * os.h + (long long)(q0 + row) * os.n;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = sub + TPR * j;
      if (d < D) ob[d] = from_f32<T>(acc[j] / denom);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head_dim
// axis must be contiguous (stride 1), which the Python wrapper checks.
extern "C" int vmt_flash_attn(
    int dtype, const void* q, const void* k, const void* v, const void* bias,
    void* out, int B, int Nq, int Nk, int H, int D, long long q_sb,
    long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    long long bias_sb, long long bias_sn, long long o_sb, long long o_sn,
    long long o_sh, float scale, void* stream) {
  if (B < 1 || Nq < 1 || Nk < 1 || H < 1 || D < 1 || D > DMAX ||
      H > 65535 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((Nq + BQ - 1) / BQ, H, B);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh},
      vs{v_sb, v_sn, v_sh}, os{o_sb, o_sn, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    flash_attn_kernel<float><<<grid, NT, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(bias),
        static_cast<float*>(out), Nq, Nk, D, qs, ks, vs, bias_sb, bias_sn,
        os, scale);
  } else if (dtype == 1) {
    flash_attn_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(bias),
        static_cast<__nv_bfloat16*>(out), Nq, Nk, D, qs, ks, vs, bias_sb,
        bias_sn, os, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
