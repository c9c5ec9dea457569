// The dense attention's core in one kernel, for the text self-attention:
//   s   = round(q . k^T)                       (f32 sums, rounded to bf16)
//   x   = round(round(s * c) + round(b))       (c the scale in bf16)
//   p   = round(softmax_f32(x))
//   ctx = round(p . v)                         (f32 sums, rounded to bf16)
// per (batch row, head), for q (B, Nq, H, D), k and v (B, Nk, H, D) in bf16,
// the additive mask bias b (B, 1, 1, Nk) in bf16 or f32 (or none), and ctx
// written as (B, Nq, H * D), the layout the output projection reads. These
// are the roundings of the JAX function in bf16 (preferred_element_type =
// the compute dtype in both einsums), and of the port's composition
// (ops/dense_attention.py:dense_attention_plain).
//
// Replaces no Pallas kernel. It stands for the fusion XLA makes of the whole
// of vilbert_multitask_tpu/ops/attention.py:36-66 (multi_head_attention
// without dropout): the two batched products, the scale, the bias, the f32
// softmax and the casts. Every text self-attention of the served forward
// runs it (head_dim 64 fails the flash kernel's % 128 gate): 12 a forward,
// at 12 heads x 38 x 38 (6 heads on a tp = 2 rank). The port ran it as an
// einsum, csrc/softmax.cu and an einsum, with the contiguous copies the
// einsums make of the permuted (B, N, H, D) views.
//
// What bounds it on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16 dense): a
// bucket-1 text layer reads q, k, v (3 x 38 x 768 bf16) and writes ctx, ~234
// KB, 0.07 us; its products are 4 * 12 * 38 * 38 * 64 ~ 4.4 MFLOP, 0.004 us
// at the tensor-core peak. Bytes bound it, and at batch 1 (12 blocks on 132
// SMs) what it waits on is latency: the launch, the loads, one block's
// chain of products and reductions.
//
// Design (its loading and fragment machinery are csrc/flash_attn.cu's):
//   - one block of 4 warps for each (64 queries, head, batch row); each warp
//     owns 16 query rows, and a warp with no query below Nq skips the
//     products;
//   - q, k and v are read in place from the three Linear outputs' (B, N, H,
//     D) views through their strides, with cp.async.cg in 16-byte pieces (D
//     % 16 == 0 and 16-byte-aligned bases and strides, which the wrapper
//     checks): no copy before the kernel. Q and K are one copy group and V a
//     second, so V lands while S is computed. Shared rows are padded to D + 8
//     elements: an odd count of 16-byte units, so the 8 rows of an ldmatrix
//     phase fall in 8 different bank quads. Keys are copied up to Nk rounded
//     to 16; the rows past Nk are zero-filled (src-size 0), never read;
//   - the whole key row in one pass (Nk <= 128): S on mma.sync m16n8k16 bf16
//     into f32 fragments, 16 rows x up to 128 keys a warp; no online
//     recurrence. The roundings happen in registers; keys past Nk get -inf.
//     Row max and row sum go through the quad shuffles of the accumulator
//     layout, in the same order on every launch, so two launches on the same
//     inputs give identical bits. The exponential is expf, as torch's
//     softmax computes it;
//   - P is normalized and rounded to bf16 as it is packed into A fragments
//     of the second product; V comes in through ldmatrix.trans;
//   - ctx is rounded to bf16, staged through the warp's own Q rows in shared
//     memory, and stored 16 bytes at a time into (B, Nq, H * D): no copy
//     after the kernel. No probabilities are written (the self-attention's
//     are never surfaced: models/encoder.py drops them).
// mma.sync and cp.async, not wgmma and TMA: the tensor-core work of a text
// layer is ~4.4 MFLOP, 0.004 us at the peak, and TMA needs a tensor map
// encoded on the host for every new set of strides.
// Instances: one per head_dim / 16 (1 to 8); the bias type (bf16, f32 or
// none) is a branch on the one load a thread makes of it. Dynamic shared
// memory: (64 + 2 * Nk rounded to 16) rows of D + 8 bf16, and 128 bias
// floats: 23.5 KB at the served text shape, 87.5 KB at most (D = 128, Nk =
// 128).
//
// C interface (bound with ctypes): vmt_dense_attention launches on the given
// stream, allocates nothing, and returns a cudaError_t as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;            // queries per block: 16 per warp
constexpr int NT = 128;           // threads per block
constexpr int MAX_KEYS = 128;     // the whole key row in one pass
constexpr int TILES = MAX_KEYS / 8;   // 8-key accumulator tiles of S
constexpr int STEPS = MAX_KEYS / 16;  // 16-key steps of P . V
static_assert(NT == MAX_KEYS, "a thread per key of the bias row");

struct Strides {  // element strides of the batch, sequence and head axes
  long long b, n, h;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until cp_async_wait; src_bytes 0
// writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16x8, f32) += a (16x16, bf16, row-major) . b (16x8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Issue the copies of rows [0, rows) of one (batch, head) slice into dst
// (rows x (D + 8)), starting at sequence row r0: rows at or past n are
// zero-filled. Thread tid copies pieces tid, tid + NT, ... of the tile.
template <int KD, int MAX_ROWS>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          long long sn, int r0, int n,
                                          int rows, int tid) {
  constexpr int CHUNKS = 2 * KD;  // 16-byte pieces of a row
  constexpr int LDS = 16 * KD + 8;
  constexpr int ITERS = (MAX_ROWS * CHUNKS + NT - 1) / NT;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = tid + it * NT;
    const int r = i / CHUNKS, col = (i % CHUNKS) * 8;
    if (r < rows) {
      const bool real = r0 + r < n;
      cp_async16(dst + r * LDS + col,
                 real ? src + (long long)(r0 + r) * sn + col : src,
                 real ? 16 : 0);
    }
  }
}

constexpr size_t smem_bytes(int KD, int kv_rows) {
  return (size_t)(BQ + 2 * kv_rows) * (16 * KD + 8) * sizeof(bf16) +
         MAX_KEYS * sizeof(float);
}

// head_dim = 16 * KD; bias is f32 when bias_f32, else bf16, or null.
template <int KD>
__global__ void __launch_bounds__(NT, 2) dense_attention_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const void* __restrict__ bias, int bias_f32,
    bf16* __restrict__ out, int Nq, int Nk, int H, Strides qs, Strides ks,
    Strides vs, long long bias_sb, float scale) {
  constexpr int D = 16 * KD;
  constexpr int LDS = D + 8;  // shared row stride in bf16
  extern __shared__ __align__(16) unsigned char smem[];
  const int steps = (Nk + 15) >> 4;  // 16-key steps that hold a key
  const int kv_rows = steps * 16;
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [BQ][LDS]
  bf16* k_s = q_s + BQ * LDS;                  // [kv_rows][LDS]
  bf16* v_s = k_s + kv_rows * LDS;             // [kv_rows][LDS]
  float* b_s = reinterpret_cast<float*>(v_s + kv_rows * LDS);  // [MAX_KEYS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator row (and row + 8) of this thread
  const int t = lane & 3;   // accumulator columns 2t, 2t + 1 of each 8
  const int wr = (tid >> 5) * 16;  // this warp's first row in the tile
  // The row and column each lane addresses in an ldmatrix.x4 (lanes 8i to
  // 8i + 7 give the 8 rows of matrix i): Q as the A fragment of 16 rows x 16
  // deep; K as the B fragments of two 8-key tiles x 16 deep; V, transposed,
  // as the B fragments of 16 keys x two 8-column tiles.
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + ((lane >> 4) << 3);
  const int k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_col = (lane >> 4) * 8;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  // Thread tid owns key tid of the bias row: round(b), 0 without a bias,
  // -inf past Nk. Read before the copies are issued, stored after them.
  float bias_r = -INFINITY;
  if (tid < Nk) {
    const long long at = b * bias_sb + tid;
    if (bias == nullptr) {
      bias_r = 0.f;
    } else if (bias_f32) {
      bias_r = round_bf16(static_cast<const float*>(bias)[at]);
    } else {
      bias_r = __bfloat162float(static_cast<const bf16*>(bias)[at]);
    }
  }
  copy_rows<KD, BQ>(q_s, q + b * qs.b + h * qs.h, qs.n, q0, Nq, BQ, tid);
  copy_rows<KD, MAX_KEYS>(k_s, k + b * ks.b + h * ks.h, ks.n, 0, Nk, kv_rows,
                          tid);
  cp_async_commit();
  copy_rows<KD, MAX_KEYS>(v_s, v + b * vs.b + h * vs.h, vs.n, 0, Nk, kv_rows,
                          tid);
  cp_async_commit();
  b_s[tid] = bias_r;
  cp_async_wait<1>();  // Q and K have landed for this thread
  __syncthreads();     // ... and for every thread

  const bool active = q0 + wr < Nq;  // the warp holds a query below Nq
  uint32_t pf[STEPS][4];  // P as A fragments, 16 keys each
  if (active) {
    uint32_t qf[KD][4];  // this warp's Q rows as A fragments
#pragma unroll
    for (int kc = 0; kc < KD; ++kc)
      ldmatrix_x4(qf[kc], q_s + (wr + a_row) * LDS + kc * 16 + a_col);
    // S = Q K^T: 16 rows x 16 keys a step, as two 8-key accumulator tiles.
    float s[TILES][4];
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      if (st < steps) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[2 * st][j] = s[2 * st + 1][j] = 0.f;
#pragma unroll
        for (int kc = 0; kc < KD; ++kc) {
          uint32_t kf[4];
          ldmatrix_x4(kf, k_s + (st * 16 + k_row) * LDS + kc * 16 + k_col);
          mma_bf16(s[2 * st], qf[kc], kf[0], kf[1]);
          mma_bf16(s[2 * st + 1], qf[kc], kf[2], kf[3]);
        }
      }
    }
    // x = round(round(round(s) * c) + round(b)); -inf past Nk. The row max
    // of rows g and g + 8.
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < TILES; ++i) {
      if (i < 2 * steps) {
        const float b0 = b_s[i * 8 + 2 * t], b1 = b_s[i * 8 + 2 * t + 1];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = round_bf16(round_bf16(s[i][j]) * scale);
          s[i][j] = round_bf16(x + (j & 1 ? b1 : b0));
        }
        m[0] = fmaxf(m[0], fmaxf(s[i][0], s[i][1]));
        m[1] = fmaxf(m[1], fmaxf(s[i][2], s[i][3]));
      }
    }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    }
#pragma unroll
    for (int i = 0; i < TILES; ++i) {
      if (i < 2 * steps) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m[j >> 1]);  // 0 past Nk
          l[j >> 1] += s[i][j];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    // p = round(e / l), packed as the A fragments of P . V.
#pragma unroll
    for (int i = 0; i < TILES; ++i) {
      if (i < 2 * steps) {
        pf[i >> 1][(i & 1) * 2] = pack_bf16(s[i][0] / l[0], s[i][1] / l[0]);
        pf[i >> 1][(i & 1) * 2 + 1] =
            pack_bf16(s[i][2] / l[1], s[i][3] / l[1]);
      }
    }
  }
  cp_async_wait<0>();  // V has landed for this thread
  __syncthreads();     // ... and for every thread
  if (!active) return;  // no barrier follows

  // ctx = P V: 16 keys a step, two 8-column tiles per ldmatrix.
  float acc[2 * KD][4];
#pragma unroll
  for (int i = 0; i < 2 * KD; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int st = 0; st < STEPS; ++st) {
    if (st < steps) {
#pragma unroll
      for (int dp = 0; dp < KD; ++dp) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, v_s + (st * 16 + v_row) * LDS + dp * 16 + v_col);
        mma_bf16(acc[2 * dp], pf[st], f[0], f[1]);
        mma_bf16(acc[2 * dp + 1], pf[st], f[2], f[3]);
      }
    }
  }

  // Epilogue: ctx in bf16, staged through this warp's own Q rows, then
  // stored 16 bytes at a time into (B, Nq, H * D).
  bf16* o_s = q_s + wr * LDS;
#pragma unroll
  for (int i = 0; i < 2 * KD; ++i) {
    *reinterpret_cast<uint32_t*>(o_s + g * LDS + i * 8 + 2 * t) =
        pack_bf16(acc[i][0], acc[i][1]);
    *reinterpret_cast<uint32_t*>(o_s + (g + 8) * LDS + i * 8 + 2 * t) =
        pack_bf16(acc[i][2], acc[i][3]);
  }
  __syncwarp();
  constexpr int CHUNKS = 2 * KD;  // 16-byte pieces of an output row
#pragma unroll
  for (int it = 0; it < KD; ++it) {  // 16 rows x CHUNKS pieces, 32 a pass
    const int i = lane + it * 32;
    const int r = i / CHUNKS, col = (i % CHUNKS) * 8;
    const int row = q0 + wr + r;
    if (row < Nq) {
      bf16* o = out + (((long long)b * Nq + row) * H + h) * D + col;
      *reinterpret_cast<uint4*>(o) =
          *reinterpret_cast<const uint4*>(o_s + r * LDS + col);
    }
  }
}

template <int KD>
int launch(const void* q, const void* k, const void* v, const void* bias,
           int bias_f32, void* out, int B, int Nq, int Nk, int H, Strides qs,
           Strides ks, Strides vs, long long bias_sb, float scale,
           cudaStream_t st) {
  constexpr size_t kMaxSmem = smem_bytes(KD, MAX_KEYS);
  static bool smem_limit_set = false;  // once per process and instance
  if (kMaxSmem > 48 * 1024 && !smem_limit_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        dense_attention_kernel<KD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (rc != cudaSuccess) return (int)rc;
    smem_limit_set = true;
  }
  const dim3 grid((Nq + BQ - 1) / BQ, H, B);
  dense_attention_kernel<KD>
      <<<grid, NT, smem_bytes(KD, (Nk + 15) / 16 * 16), st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), bias, bias_f32,
          static_cast<bf16*>(out), Nq, Nk, H, qs, ks, vs, bias_sb, scale);
  return (int)cudaGetLastError();
}

int launch_dim(int D, const void* q, const void* k, const void* v,
               const void* bias, int bias_f32, void* out, int B, int Nq,
               int Nk, int H, Strides qs, Strides ks, Strides vs,
               long long bias_sb, float scale, cudaStream_t st) {
#define VMT_DENSE_CASE(KD)                                                  \
  case KD:                                                                  \
    return launch<KD>(q, k, v, bias, bias_f32, out, B, Nq, Nk, H, qs, ks,   \
                      vs, bias_sb, scale, st);
  switch (D / 16) {
    VMT_DENSE_CASE(1)
    VMT_DENSE_CASE(2)
    VMT_DENSE_CASE(3)
    VMT_DENSE_CASE(4)
    VMT_DENSE_CASE(5)
    VMT_DENSE_CASE(6)
    VMT_DENSE_CASE(7)
    VMT_DENSE_CASE(8)
  }
#undef VMT_DENSE_CASE
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// b_dtype: 0 f32, 1 bf16, -1 no bias (bias null); q, k, v and the output are
// bf16. Strides are in elements (the head_dim axis contiguous); every base
// and stride must be a multiple of 16 bytes.
extern "C" int vmt_dense_attention(
    int b_dtype, const void* q, const void* k, const void* v,
    const void* bias, void* out, int B, int Nq, int Nk, int H, int D,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, long long bias_sb, float scale, void* stream) {
  const long long strides[] = {q_sb, q_sn, q_sh, k_sb, k_sn,
                               k_sh, v_sb, v_sn, v_sh};
  bool ok = B >= 1 && Nq >= 1 && Nk >= 1 && Nk <= MAX_KEYS && H >= 1 &&
            H <= 65535 && B <= 65535 && D >= 16 && D <= 128 && D % 16 == 0 &&
            (b_dtype == -1) == (bias == nullptr) && b_dtype >= -1 &&
            b_dtype <= 1 && aligned16(q) && aligned16(k) && aligned16(v) &&
            aligned16(out);
  for (long long s : strides) ok = ok && s % 8 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh},
      vs{v_sb, v_sn, v_sh};
  return launch_dim(D, q, k, v, bias, b_dtype == 0, out, B, Nq, Nk, H, qs,
                    ks, vs, bias_sb, scale, static_cast<cudaStream_t>(stream));
}
