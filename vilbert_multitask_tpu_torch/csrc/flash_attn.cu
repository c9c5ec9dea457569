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
// So by its bound it is memory-bound, and at batch 1 (8 to 16 blocks on 132
// SMs) what it really waits on is latency: the launch, the first loads, and
// the chain of dependent steps inside one block.
//
// The bf16 kernel (every served request) is built for that:
//   - one block of 4 warps per (64 queries, head, batch row); each warp owns
//     16 query rows, so a block reads K and V once per 64 queries. (Blocks of
//     2 warps and 32 queries were no faster at batch 1 and 1.5x slower at
//     batch 32: PERF.md.)
//   - q, k, v are read in place from the model's (B, N, H, D) layout through
//     their strides, with cp.async.cg in 16-byte pieces of 8 bf16 (so D % 8
//     == 0 and every base and stride is a multiple of 16 bytes, which the
//     Python wrapper checks). Rows at or past Nq / Nk and the columns between
//     D and D rounded up to 16 are zero-filled by the copy (src-size 0), never
//     read. Shared memory keeps bf16 rows padded to 136 elements (272 bytes),
//     so the 8 rows of every ldmatrix phase fall in 8 different bank quads.
//     The bias row is read into registers before the copies are issued and
//     stored to shared memory after, so no thread waits on it while issuing;
//   - K and V move in tiles of 64 keys (BLOCK_K in ops/coattention.py) through
//     two stages: tile j+1's copies are in flight while tile j is multiplied,
//     and at every serving shape (Nk <= 128) both tiles are issued at once;
//   - scores are mma.sync m16n8k16 bf16 x bf16 -> f32 on ldmatrix fragments.
//     bf16 products are exact in f32, so scores differ from the TPU kernel's
//     only in summation order. Keys past Nk get a -inf bias; every tile holds
//     a key below Nk and the bias is finite, so the running max is finite and
//     a masked key adds an exact 0;
//   - the fragments of the next 16-deep step (of K, and of V below) are loaded
//     before this step's products, so an mma never waits on the ldmatrix just
//     before it;
//   - the softmax runs in registers, once per score: row max and row sum go
//     through the quad shuffles of the accumulator layout. It works in base 2:
//     log2(e) is folded into the scale and the bias, and each exponential is
//     one ex2.approx.ftz (relative error ~2^-22, far below bf16's 2^-9);
//   - P goes from the score accumulators straight to bf16 A fragments, and V
//     comes in through ldmatrix.trans. This rounding of P to bf16 is the one
//     rounding the TPU kernel does not make (it multiplies P . V in f32):
//     each weight keeps 8 significant bits, and l sums the unrounded f32 P;
//   - the output acc * (1 / max(l, 1e-30)) (one reciprocal per row, not a
//     division per element) is staged through the warp's own Q rows in shared
//     memory and stored 16 bytes at a time.
// Dynamic shared memory: (64 + 4 * 64) rows x 272 bytes + 2 x 64 bias floats
// = 87,552 bytes, above the 48 KB default, so the launcher raises the
// kernel's limit once.
// mma.sync and cp.async, not wgmma and TMA: the tensor-core work is 0.016 us
// per batch row at peak, and TMA needs a tensor map encoded on the host for
// every new set of strides, host work on a path the host already bounds.
// Where a block's time goes now (ops/flash_phases.py, PERF.md): about 2,300
// SM cycles to issue the prologue's copies, about 3,600 per key tile (most
// of it the 128 mma.sync of one warp, scores and P . V), 1,450 for the
// epilogue; the graph-replayed launch adds about 1.5 us.
//
// The f32 kernel (the f32 parity engine) stays on CUDA cores, as first
// written: one block per (16 queries, head, batch row), 32-key tiles (half of
// BLOCK_K: the same recurrence to f32 rounding) of scalar loads into f32
// shared memory, f32 FMAs, expf.
//
// C interface (bound with ctypes): vmt_flash_attn launches on the given
// stream, allocates nothing, and returns a cudaError_t as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int DMAX = 128;  // largest head_dim

#ifdef VMT_FLASH_PHASES
// Built only by ops/flash_phases.py: thread 0 of block (0, 0, 0) of the bf16
// kernel stamps clock64() at the end of each phase. PHASE is empty otherwise.
__device__ long long g_phase[64];
#define PHASE(n)                                                       \
  do {                                                                 \
    if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&      \
        blockIdx.z == 0 && (n) < 64)                                   \
      g_phase[(n)] = clock64();                                        \
  } while (0)
#else
#define PHASE(n) \
  do {           \
  } while (0)
#endif

struct Strides {  // element strides of the batch, sequence and head axes
  long long b, n, h;
};

// ------------------------------------------------------------- f32 kernel
constexpr int F_BQ = 16;           // query rows per block
constexpr int F_BK = 32;           // keys per shared-memory tile
constexpr int F_NT = 128;          // threads per block
constexpr int F_TPR = F_NT / F_BQ; // threads per query row (8)
constexpr int F_CPT = DMAX / F_TPR;  // output columns per thread (16)

__global__ void __launch_bounds__(F_NT) flash_attn_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    float* __restrict__ out, int Nq, int Nk, int D, Strides qs, Strides ks,
    Strides vs, long long bias_sb, long long bias_sn, Strides os,
    float scale) {
  __shared__ float q_s[F_BQ][DMAX];
  __shared__ float k_s[F_BK][DMAX + 1];
  __shared__ float v_s[F_BK][DMAX];
  __shared__ float s_s[F_BQ][F_BK + 1];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * F_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* bb = bias + b * bias_sb;

  for (int i = tid; i < F_BQ * DMAX; i += F_NT) {
    const int r = i / DMAX, d = i % DMAX;
    float x = 0.f;
    if (q0 + r < Nq && d < D) x = qb[(long long)(q0 + r) * qs.n + d];
    q_s[r][d] = x;
  }

  const int row = tid / F_TPR;
  const int sub = tid % F_TPR;
  float acc[F_CPT];
#pragma unroll
  for (int j = 0; j < F_CPT; ++j) acc[j] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += F_BK) {
    __syncthreads();  // q is loaded; the previous tile's readers are done
    for (int i = tid; i < F_BK * DMAX; i += F_NT) {
      const int c = i / DMAX, d = i % DMAX;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < Nk && d < D) {
        kx = kb[(long long)(k0 + c) * ks.n + d];
        vx = vb[(long long)(k0 + c) * vs.n + d];
      }
      k_s[c][d] = kx;
      v_s[c][d] = vx;
    }
    __syncthreads();
    for (int i = tid; i < F_BQ * F_BK; i += F_NT) {
      const int r = i / F_BK, c = i % F_BK;
      float s = -INFINITY;  // keys past Nk contribute nothing
      if (k0 + c < Nk) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(q_s[r][d], k_s[c][d], dot);
        s = dot * scale + bb[(long long)(k0 + c) * bias_sn];
      }
      s_s[r][c] = s;
    }
    __syncthreads();
    // Every tile holds at least one key below Nk, and the bias is finite,
    // so m_new is finite and exp(-inf - m_new) is an exact 0.
    float mt = -INFINITY;
    for (int c = 0; c < F_BK; ++c) mt = fmaxf(mt, s_s[row][c]);
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);  // 0 on the first tile
    l *= alpha;
#pragma unroll
    for (int j = 0; j < F_CPT; ++j) acc[j] *= alpha;
    for (int c = 0; c < F_BK; ++c) {
      const float p = expf(s_s[row][c] - m_new);
      l += p;
#pragma unroll
      for (int j = 0; j < F_CPT; ++j) acc[j] = fmaf(p, v_s[c][sub + F_TPR * j], acc[j]);
    }
    m = m_new;
  }

  if (q0 + row < Nq) {
    const float denom = fmaxf(l, 1e-30f);
    float* ob = out + b * os.b + h * os.h + (long long)(q0 + row) * os.n;
#pragma unroll
    for (int j = 0; j < F_CPT; ++j) {
      const int d = sub + F_TPR * j;
      if (d < D) ob[d] = acc[j] / denom;
    }
  }
}

// ------------------------------------------------------------ bf16 kernel
constexpr int BLOCK_K = 64;        // keys per tile (BLOCK_K in coattention.py)
constexpr int LDS = DMAX + 8;      // shared row stride in bf16 (272 bytes)
constexpr int CHUNKS = DMAX / 8;   // 16-byte pieces in a row of DMAX
constexpr float LOG2E = 1.4426950408889634f;

constexpr int BQ = 64;             // queries per block: 16 per warp
constexpr int NT = 128;            // threads per block
constexpr size_t BF16_SMEM =       // Q, two stages of K and V, two bias rows
    (size_t)(BQ + 4 * BLOCK_K) * LDS * sizeof(bf16) +
    2 * BLOCK_K * sizeof(float);

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

// 2^x by one MUFU.EX2 (relative error ~2^-22; -inf gives 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Issue the copies of rows [r0, r0 + ROWS) of one (batch, head) slice into
// dst (ROWS x LDS): real rows and columns below D are copied, rows at or past
// n and the columns [D, DP) are zero-filled.
// A thread copies the same 16-byte column of every (NT / CHUNKS)-th row; the
// loop is unrolled so all of a thread's copies issue back to back.
template <int ROWS, int NT>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          long long sn, int r0, int n, int D,
                                          int DP, int tid) {
  constexpr int RSTEP = NT / CHUNKS;
  static_assert(NT % CHUNKS == 0 && ROWS % RSTEP == 0, "bad tile shape");
  const int col = (tid % CHUNKS) * 8;
  if (col >= DP) return;
  int r = tid / CHUNKS;
  const bf16* p = src + (long long)(r0 + r) * sn + col;
  bf16* d = dst + r * LDS + col;
#pragma unroll
  for (; r < ROWS; r += RSTEP, p += RSTEP * sn, d += RSTEP * LDS) {
    const bool real = r0 + r < n && col < D;
    cp_async16(d, real ? p : src, real ? 16 : 0);
  }
}

// Two blocks fill an SM's shared memory; saying so lets ptxas use up to 255
// registers (left to itself it aimed at 168 and spilled).
__global__ void __launch_bounds__(NT, 2) flash_attn_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ bias,
    bf16* __restrict__ out, int Nq, int Nk, int D, Strides qs, Strides ks,
    Strides vs, long long bias_sb, long long bias_sn, Strides os,
    float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [BQ][LDS]
  bf16* k_s = q_s + BQ * LDS;                  // [2][BLOCK_K][LDS]
  bf16* v_s = k_s + 2 * BLOCK_K * LDS;         // [2][BLOCK_K][LDS]
  // [2][BLOCK_K] bias rows, in base 2
  float* b_s = reinterpret_cast<float*>(v_s + 2 * BLOCK_K * LDS);

  PHASE(0);
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
  const int DP = (D + 15) & ~15;  // D padded to the MMA depth
  const int n_tiles = (Nk + BLOCK_K - 1) / BLOCK_K;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const bf16* bb = bias + b * bias_sb;

  // Thread tid < BLOCK_K owns key tid of every tile's bias row, read into a
  // register well before it is stored to shared memory (in base 2; -inf
  // past Nk), so no thread waits on a global load while it issues copies.
  static_assert(NT >= BLOCK_K, "a thread per key of the bias row");
  auto bias_of = [&](int j) {
    const int key = j * BLOCK_K + tid;
    return tid < BLOCK_K && key < Nk
               ? __bfloat162float(bb[(long long)key * bias_sn]) * LOG2E
               : -INFINITY;
  };
  auto copy_kv = [&](int j, int st) {  // K and V of key tile j into stage st
    const int k0 = j * BLOCK_K;
    copy_rows<BLOCK_K, NT>(k_s + st * BLOCK_K * LDS, kb, ks.n, k0, Nk, D, DP,
                           tid);
    copy_rows<BLOCK_K, NT>(v_s + st * BLOCK_K * LDS, vb, vs.n, k0, Nk, D, DP,
                           tid);
  };

  const float bias0 = bias_of(0);
  const float bias1 = bias_of(1);
  copy_rows<BQ, NT>(q_s, qb, qs.n, q0, Nq, D, DP, tid);
  copy_kv(0, 0);
  cp_async_commit();
  if (n_tiles > 1) copy_kv(1, 1);
  cp_async_commit();
  if (tid < BLOCK_K) {
    b_s[tid] = bias0;
    b_s[BLOCK_K + tid] = bias1;
  }
  PHASE(1);  // prologue: every copy of Q and the first two tiles issued

  uint32_t qf[DMAX / 16][4];  // this warp's Q rows as A fragments
  float acc[DMAX / 8][4] = {};  // 16 x DMAX output accumulator, f32
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, base 2
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    const float bias_next = bias_of(j + 2);  // lands while tile j runs
    cp_async_wait<1>();  // tile j (and Q) have landed for this thread
    __syncthreads();     // ... and for every thread
    PHASE(2 + 4 * j);    // tile j waited for
    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < DMAX / 16; ++kc) {
        if (kc * 16 < D)
          ldmatrix_x4(qf[kc], q_s + (wr + a_row) * LDS + kc * 16 + a_col);
      }
    }
    const bf16* kt = k_s + st * BLOCK_K * LDS;
    const bf16* vt = v_s + st * BLOCK_K * LDS;
    const float* bt = b_s + st * BLOCK_K;

    // S = Q K^T: 16 rows x 64 keys per warp, as 8 accumulator tiles. The
    // fragments of depth step kc + 1 are loaded before step kc's products,
    // so no mma waits on the ldmatrix just before it.
    auto load_k = [&](uint32_t (&f)[BLOCK_K / 16][4], int kc) {
#pragma unroll
      for (int np = 0; np < BLOCK_K / 16; ++np)  // key tiles 2np, 2np + 1
        ldmatrix_x4(f[np], kt + (np * 16 + k_row) * LDS + kc * 16 + k_col);
    };
    float s[BLOCK_K / 8][4] = {};
    uint32_t kf[2][BLOCK_K / 16][4];
    load_k(kf[0], 0);
#pragma unroll
    for (int kc = 0; kc < DMAX / 16; ++kc) {
      if (kc * 16 < D) {
        if ((kc + 1) * 16 < D) load_k(kf[(kc + 1) & 1], kc + 1);
#pragma unroll
        for (int np = 0; np < BLOCK_K / 16; ++np) {
          mma_bf16(s[2 * np], qf[kc], kf[kc & 1][np][0], kf[kc & 1][np][1]);
          mma_bf16(s[2 * np + 1], qf[kc], kf[kc & 1][np][2], kf[kc & 1][np][3]);
        }
      }
    }

    PHASE(3 + 4 * j);  // S issued (and, on tile 0, Q's fragments loaded)

    // Online softmax in base 2, once per score.
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BLOCK_K / 8; ++i) {
      const float b0 = bt[i * 8 + 2 * t], b1 = bt[i * 8 + 2 * t + 1];
      s[i][0] = fmaf(s[i][0], scale_log2, b0);
      s[i][1] = fmaf(s[i][1], scale_log2, b1);
      s[i][2] = fmaf(s[i][2], scale_log2, b0);
      s[i][3] = fmaf(s[i][3], scale_log2, b1);
      mt[0] = fmaxf(mt[0], fmaxf(s[i][0], s[i][1]));
      mt[1] = fmaxf(mt[1], fmaxf(s[i][2], s[i][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);  // finite: the tile has a key
      alpha[r] = exp2_approx(m[r] - m_new);    // 0 on the first tile
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    uint32_t pf[BLOCK_K / 16][4];  // P as A fragments, 16 keys each
#pragma unroll
    for (int i = 0; i < BLOCK_K / 8; ++i) {
      const float p0 = exp2_approx(s[i][0] - m[0]);
      const float p1 = exp2_approx(s[i][1] - m[0]);
      const float p2 = exp2_approx(s[i][2] - m[1]);
      const float p3 = exp2_approx(s[i][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[i >> 1][(i & 1) * 2] = pack_bf16(p0, p1);
      pf[i >> 1][(i & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    PHASE(4 + 4 * j);  // softmax

    // O = alpha * O + P V, in 8 steps of (16 keys, 64 output columns); the
    // V fragments of step i + 1 are loaded before step i's products.
#pragma unroll
    for (int i = 0; i < DMAX / 8; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }
    constexpr int HALF = DMAX / 32;  // column pairs (of 16) per step
    auto load_v = [&](uint32_t (&f)[HALF][4], int step) {
      const int kk = step / 2;
#pragma unroll
      for (int c = 0; c < HALF; ++c) {
        const int dp = (step % 2) * HALF + c;  // output columns 16dp..16dp+15
        if (dp * 16 < D)
          ldmatrix_x4_trans(f[c],
                            vt + (kk * 16 + v_row) * LDS + dp * 16 + v_col);
      }
    };
    uint32_t vf[2][HALF][4];
    load_v(vf[0], 0);
#pragma unroll
    for (int step = 0; step < BLOCK_K / 8; ++step) {
      if (step + 1 < BLOCK_K / 8) load_v(vf[(step + 1) & 1], step + 1);
#pragma unroll
      for (int c = 0; c < HALF; ++c) {
        const int dp = (step % 2) * HALF + c;
        if (dp * 16 < D) {
          const uint32_t(&f)[4] = vf[step & 1][c];
          mma_bf16(acc[2 * dp], pf[step / 2], f[0], f[1]);
          if (dp * 16 + 8 < D)
            mma_bf16(acc[2 * dp + 1], pf[step / 2], f[2], f[3]);
        }
      }
    }

    PHASE(5 + 4 * j);  // P V issued
    __syncthreads();  // every warp is done with stage st
    if (j + 2 < n_tiles) {
      copy_kv(j + 2, st);
      if (tid < BLOCK_K) b_s[st * BLOCK_K + tid] = bias_next;
    }
    cp_async_commit();  // possibly empty: keeps one group per tile
  }

  PHASE(40);  // every tile done
  // Epilogue: acc / max(l, 1e-30) in bf16, through this warp's Q rows.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  bf16* o_s = q_s + wr * LDS;
#pragma unroll
  for (int i = 0; i < DMAX / 8; ++i) {
    if (i * 8 < D) {
      *reinterpret_cast<uint32_t*>(o_s + g * LDS + i * 8 + 2 * t) =
          pack_bf16(acc[i][0] * inv[0], acc[i][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(o_s + (g + 8) * LDS + i * 8 + 2 * t) =
          pack_bf16(acc[i][2] * inv[1], acc[i][3] * inv[1]);
    }
  }
  __syncwarp();
  PHASE(41);  // output staged in shared memory
  bf16* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int it = 0; it < 16 * CHUNKS / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / CHUNKS, col = (i % CHUNKS) * 8;
    const int row = q0 + wr + r;
    if (row < Nq && col < D) {
      *reinterpret_cast<uint4*>(ob + (long long)row * os.n + col) =
          *reinterpret_cast<const uint4*>(o_s + r * LDS + col);
    }
  }
  PHASE(42);  // output stored
}

int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* bias,
                bf16* out, int B, int Nq, int Nk, int H, int D, Strides qs,
                Strides ks, Strides vs, long long bias_sb, long long bias_sn,
                Strides os, float scale, cudaStream_t st) {
  static bool smem_limit_set = false;  // once per process
  if (!smem_limit_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        flash_attn_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)BF16_SMEM);
    if (rc != cudaSuccess) return (int)rc;
    smem_limit_set = true;
  }
  const dim3 grid((Nq + BQ - 1) / BQ, H, B);
  flash_attn_bf16_kernel<<<grid, NT, BF16_SMEM, st>>>(
      q, k, v, bias, out, Nq, Nk, D, qs, ks, vs, bias_sb, bias_sn, os,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head_dim
// axis must be contiguous, and for bf16 D % 8 == 0 with every base and stride
// a multiple of 16 bytes, which the Python wrapper checks.
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
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh},
      vs{v_sb, v_sn, v_sh}, os{o_sb, o_sn, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((Nq + F_BQ - 1) / F_BQ, H, B);
    flash_attn_f32_kernel<<<grid, F_NT, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(bias),
        static_cast<float*>(out), Nq, Nk, D, qs, ks, vs, bias_sb, bias_sn,
        os, scale);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  return launch_bf16(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), B, Nq, Nk, H, D, qs, ks, vs, bias_sb, bias_sn,
      os, scale, st);
}

// Dynamic shared memory of one bf16 block, in bytes.
extern "C" int vmt_flash_attn_bf16_smem_bytes() { return (int)BF16_SMEM; }

#ifdef VMT_FLASH_PHASES
// Copy the 64 phase stamps to host and zero them on the card.
extern "C" int vmt_flash_phases_take(long long* host) {
  static const long long zeros[64] = {};
  cudaError_t rc = cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
  if (rc == cudaSuccess) rc = cudaMemcpyToSymbol(g_phase, zeros, sizeof(zeros));
  return (int)rc;
}
#endif
