// Weight-only int8 GEMM for the int8 serving mode: y = x . W^T (+ b), with
// W[n, k] = round_to_x_dtype(q[n, k] * s[n]) dequantized inside the kernel.
//
// Replaces no Pallas kernel. In the JAX package, EngineConfig.param_dtype =
// "int8" stores every matrix as per-channel {"int8", "scale"} pairs
// (vilbert_multitask_tpu/quant.py:70-99) and dequantizes them inside the
// jitted forward (engine/runtime.py:684-705), where XLA fuses the
// dequantization into each consuming matmul, so weights are read as int8.
// Eager PyTorch fuses nothing: dequantizing first would write and read a
// bf16 copy of every weight on every forward. This file is that fused work.
//
// The function, per batch entry, for x (M, K) in bf16 or f32, q (N, K) int8
// with K contiguous (torch's Linear layout), an f32 scale s (N,) and an
// optional bias b (N,) in x's type:
//   W[n, k] = round(fmul_rn(float(q[n, k]), s[n]))   (round: to x's type)
//   y       = round(x . W^T), f32 accumulation, rounded once after the sum
//   y       = round(y + b)
// the two roundings of flax's Dense (the product, then the bias). Every W
// element is rounded before the product, as JAX does; the scale is never
// moved to the epilogue and x is never quantized. Two scale paths, picked by
// a template flag the wrapper sets from the call site:
//   - the trunk passes s already rounded to bf16 (SCALE_BF16): bf16(q) is
//     exact, so one packed mul.rn.bf16x2 of bf16(q) by (s, s) is the one
//     rounding of the exact product, JAX's bf16(q) * bf16(s);
//   - the head slabs pass the f32 scale: the product is rounded to f32
//     (__fmul_rn, no FMA) and then to bf16, as JAX's f32 dequantization
//     followed by .astype(bf16) is.
// int8 -> exact f32 by the magic-number trick (one byte-permute puts the
// biased byte under the exponent of 2^23, one subtraction removes 2^23 + 128),
// so no I2F (a quarter-rate conversion) runs; an integer |v| <= 128 has
// 16 zero low bits in f32, so its bf16 is the high half, taken by a second
// byte-permute. Bit-identical to (float)(int8_t)v.
//
// What bounds it on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16 dense, 132
// SMs, 50 MB L2): a layer moves N.K int8 weight bytes for 2.M.N.K
// operations. At bucket 1 (M = 38 text or 101 visual rows) that is 76 or
// 202 operations per weight byte, below the ~295 at which the tensor cores
// and not the memory are the limit: bound by the weight bytes, and at 0.6-3
// MB a layer in practice by latency (the launch, the first tile's round
// trip, the dependent steps of one block, the reduction across blocks). At
// buckets 16 and 32 (M = 608-3232) it is bound by the tensor cores. Two
// regimes, one file; ops/int8_linear.py:plan_launch picks one from the shape
// alone (with the tile and the split count), and a shape it cannot serve
// raises there.
//
// (a) Small M, weight streaming (int8_linear_bf16_stream_kernel): every
// launch of buckets 1, 2 and 4, the heads, K % 8 != 0 and batched products.
//   - Weights on the 16-row side of mma.sync m16n8k16, tokens on the 8-wide
//     side: the block computes y^T = W . x^T, so M = 38 pads to 40, not 64.
//     A block of 4 warps owns 64 weight rows (16 a warp) and 64 x rows (8 n8
//     tiles; tiles past M are skipped, rows past M zero-filled).
//   - Deterministic split-K fills the SMs: the planner splits the K tiles of
//     64 into `splits` (1 to 16) whole-tile ranges, up to two blocks an SM.
//     The splits of one output tile are one thread-block cluster: every
//     block stores its f32 partials straight into the shared memory of the
//     block that owns them (the tile's 128 thread slots are dealt out to the
//     cluster's blocks), one cluster barrier makes them visible, and each
//     block sums its slots over the S partials in split order 0..S-1, applies
//     the two roundings and the bias, and stores its share of y. A block may
//     touch another's shared memory only once every block of the cluster is
//     known to have started: each arrives on the cluster barrier (relaxed)
//     at entry and waits on it just before its remote stores, a wait the K
//     loop hides. No
//     workspace in device memory, no counters to zero, no atomics (float or
//     integer): eager runs and graph replays give the same bits. (A counter-
//     and-workspace design, the block taking the last ticket summing every
//     partial, puts a __threadfence, an atomic and a one-block read of all
//     partials through L2 on the critical path, plus a memset of the
//     counters per launch.)
//   - The weights stream through a 4-stage ring of 16-byte cp.async copies
//     (int8 tiles of 64 x 64, and the x tile beside them), one
//     __syncthreads a tile: tiles i + 1 .. i + 3 are in flight while tile i
//     is used. Each thread always copies the same 16-byte column of a tile,
//     so its addresses step by whole rows. (TMA loads were no faster here,
//     and would need a tensor map of every x the eager path passes.)
//   - Dequantization in registers, straight into the A fragments: each
//     thread reads 16 int8 bytes of a weight row (one 16-byte shared load)
//     and turns them into the fragments of four k16 steps. For that, K is
//     permuted inside each 64-wide tile, the same way for both operands: the
//     k16 step c of thread t takes bytes 16t + 4c .. 16t + 4c + 3 of its row
//     as the fragment columns 2t, 2t+1, 2t+8, 2t+9 (a sum over the same 64
//     products, in the mma's own order). x's B fragments come from the
//     matching 32 bytes of x rows padded to 72 elements (conflict-free).
//     Every fragment of a tile is loaded before its first mma, and the mma
//     is not a volatile asm, so no product waits on the load just before
//     it. No bf16 weight tile, no second barrier.
//   Dynamic shared memory: 4 x (64 x 64 + 64 x 72 x 2) = 53,248 bytes of
//   ring and 18,304 of received partials: 71,552 bytes.
//
// (b) Large M, wgmma (int8_linear_bf16_wgmma_kernel): batch 1, K % 8 == 0,
// M >= 512 (buckets 16 and 32, and the visual stream of buckets 8 and 10).
// One block per 128 weight rows x 128 x rows, 320 threads:
//   - two TMA warps (one lane each): one loads the 128 x 64 bf16 x tiles
//     (128-byte swizzle) into a 6-stage ring, the other the 128 x 64 int8
//     weight tiles (64-byte swizzle: the 8 rows of a warp's fragment loads
//     fall in 8 bank quads) into a 6-stage ring, each stage completing on
//     its "full" mbarrier and refilled after its "empty" one. The weight's
//     tensor map is encoded once per weight tensor and cached
//     (ops/int8_linear.py);
//     x's is cached by address, so a captured graph encodes its maps once;
//   - two consumer warpgroups, 64 weight rows each: every warp dequantizes
//     its 16 weight rows of the int8 tile in registers straight into
//     wgmma's A fragments (RS form: the weights on the 64-row side), frees
//     the int8 stage, and runs wgmma m64n128k16 with x as the B operand in
//     shared memory (K-major, swizzled), 4 per tile. The product is
//     y^T, so the output is written back transposed, from the accumulators.
//   The A fragment wants the columns 2t, 2t+1, 2t+8, 2t+9 of each k16 step
//   in natural order (x is loaded unpermuted): two 32-bit loads of the int8
//   row and one byte-permute give them, with no repack of the stored
//   weights and no bf16 weight tile in shared memory. Each warpgroup waits
//   for its tile's products before writing the next tile's fragments:
//   rewriting the registers of a product in flight makes ptxas serialize
//   every wgmma (C7513); the other warpgroup's products fill the gap.
//   No split-K, no persistent blocks, no clusters.
//   Where it stands (chip_smoke.py phase 3, ops/int8_phases.py, PERF.md): a
//   64-deep tile takes each warpgroup ~1,150 SM cycles (two barrier waits
//   on landed tiles ~310, the dequantization ~500, the products ~360)
//   against 512 cycles of tensor-core work for the block's two products;
//   an earlier form (a dequantizing warpgroup writing a bf16 tile for both
//   operands from shared memory) was slower.
//   Dynamic shared memory: 1,024 (alignment) + 6 x 16,384 + 6 x 8,192 +
//   the mbarriers = 148,672 bytes; one block per SM.
//
// The f32 kernel (the f32 parity engines) stays on CUDA cores: 64 x 64
// output tiles, 256 threads of 4 x 4 outputs, K in tiles of 16 loaded one
// element at a time (any strides), f32 FMAs.
//
// Alignment (checked by the wrapper, and again here): q's base, row stride
// and batch stride are multiples of 16 bytes (QuantLinear pads K = 5 rows to
// 16 at load), as the 16-byte copies and TMA need; x goes 16 bytes at a time
// when K % 8 == 0 (its base 16-byte aligned, its row and batch strides
// multiples of 8 elements); other K take the stream kernel's element-wise x
// path.
//
// Phase stamps: built with -DVMT_INT8_PHASES (ops/int8_phases.py), one
// thread of block (0, 0, 0) of each bf16 kernel stamps clock64() at the end
// of each phase; the macro is empty in every other build.
//
// C interface (bound with ctypes): vmt_int8_linear launches on the given
// stream, allocates nothing, and returns a cudaError_t as an int;
// vmt_int8_tensor_map encodes an operand's TMA tensor map into a 128-byte
// host buffer (cuTensorMapEncodeTiled, looked up with
// cudaGetDriverEntryPoint, so the build needs no -lcuda).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;

#ifdef VMT_INT8_PHASES
// Built only by ops/int8_phases.py: in block (0, 0, 0) of the bf16 kernels
// the thread named by `who` stamps clock64() into slot n (the slots are
// listed there). STAMP is empty otherwise.
__device__ long long g_phase[128];
#define STAMP(who, n)                                                     \
  do {                                                                    \
    if ((who) && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && \
        (n) < 128)                                                        \
      g_phase[(n)] = clock64();                                           \
  } while (0)
#else
#define STAMP(who, n) \
  do {                \
  } while (0)
#endif

struct Batch {  // element strides between the entries of a batch
  long long x, w, s, b, y;
};

struct Args {
  const bf16* x;
  const int8_t* w;
  const float* s;
  const bf16* b;
  bf16* y;
  int M, N, K;
  long long lda, ldw, ldy;
  Batch bs;
  int splits;
};

// ---------------------------------------------------------------- helpers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until cp_async_wait; the first
// src_bytes are copied and the rest of the 16 written as zeros.
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d (16x8, f32) += a (16x16, bf16, row-major) . b (16x8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 (one 32-bit word, bytes in k order) as exact f32 values: the
// biased byte under 2^23's exponent, minus 2^23 + 128.
__device__ __forceinline__ void i8x4_to_f32(uint32_t word, float (&f)[4]) {
  const uint32_t u = word ^ 0x80808080u;
  f[0] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)),
                   8388736.f);
  f[1] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)),
                   8388736.f);
  f[2] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)),
                   8388736.f);
  f[3] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)),
                   8388736.f);
}

// Two f32 integers (|v| <= 128, exact in bf16) as packed bf16: the high
// halves, lo in the low 16 bits.
__device__ __forceinline__ uint32_t pack_high_halves(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The cluster barrier in two halves (every thread of every block of the
// cluster, warps converged). The relaxed arrive orders no memory access.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One row's scale in the forms the dequantization uses.
struct RowScale {
  float f;     // the f32 scale (head slabs)
  uint32_t h;  // (s, s) as packed bf16 (trunk: s is exact in bf16)
};

__device__ __forceinline__ RowScale row_scale(float s) {
  const bf16 b = __float2bfloat16_rn(s);
  const uint32_t u = *reinterpret_cast<const unsigned short*>(&b);
  return RowScale{s, u | (u << 16)};
}

// Dequantize one word of 4 int8: bytes (0, 1) -> lo, bytes (2, 3) -> hi.
template <bool SCALE_BF16>
__device__ __forceinline__ void dequant_word(uint32_t word, RowScale s,
                                             uint32_t& lo, uint32_t& hi) {
  float f[4];
  i8x4_to_f32(word, f);
  if (SCALE_BF16) {
    lo = mul_bf16x2(pack_high_halves(f[0], f[1]), s.h);
    hi = mul_bf16x2(pack_high_halves(f[2], f[3]), s.h);
  } else {
    lo = pack_rn(__fmul_rn(f[0], s.f), __fmul_rn(f[1], s.f));
    hi = pack_rn(__fmul_rn(f[2], s.f), __fmul_rn(f[3], s.f));
  }
}

// The two roundings of the output: the f32 sum to bf16, then the bias
// (b, a bf16 value held in f32) added in f32 and rounded again.
__device__ __forceinline__ bf16 finish(float acc, bool has_bias, float b) {
  bf16 v = __float2bfloat16_rn(acc);
  if (has_bias) v = __float2bfloat16_rn(__fadd_rn(__bfloat162float(v), b));
  return v;
}

// ------------------------------------------------- mbarriers and TMA
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Waits for the phase of the given parity to complete. The suspend-time
// hint lets the hardware park the waiting warp until then instead of
// letting it spin, so it leaves its instruction slots to the warps that
// work.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity), "r"(10000000)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// TMA: the box at (c0, c1, c2) of a 3-D tensor map into shared memory,
// completing on the mbarrier.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile with 128-byte rows in
// the 128-byte swizzle (8-row groups 1024 bytes apart).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// ------------------------------------------------- (a) the stream kernel
constexpr int S_NT = 128;        // 4 warps, 16 weight rows each
constexpr int S_BW = 64;         // weight rows (output columns) per block
constexpr int S_BX = 64;         // x rows per block (8 n8 tiles)
constexpr int S_BK = 64;         // depth of a tile
constexpr int S_STAGES = 4;      // ring depth
constexpr int S_LDX = S_BK + 8;  // bf16 row stride of the x tile (144 bytes)
constexpr int S_MAX_SPLITS = 16;  // a cluster of up to 16 blocks
constexpr int S_RING = S_STAGES * (S_BW * S_BK + S_BX * S_LDX * 2);
// Received partials: splits x 32 elements x ceil(128 / splits) thread slots.
constexpr int S_RECV = 32 * (S_NT + S_MAX_SPLITS - 1) * 4;
constexpr int S_SMEM = S_RING + S_RECV;

template <bool VEC_X, bool SCALE_BF16>
__global__ void __launch_bounds__(S_NT) int8_linear_bf16_stream_kernel(
    const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* wq = reinterpret_cast<int8_t*>(smem);  // [STAGES][64 x 64]
  bf16* xs = reinterpret_cast<bf16*>(smem + S_STAGES * S_BW * S_BK);
  float* recv = reinterpret_cast<float*>(smem + S_RING);
  __shared__ float sbias[S_BW];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int splits = a.splits;
  const int split = blockIdx.x % splits;  // = the block's rank in its cluster
  // This block has started; the matching wait comes before its stores into
  // the other blocks' shared memory.
  if (splits > 1) cluster_arrive_relaxed();
  STAMP(tid == 0, 0);
  const int n0 = (blockIdx.x / splits) * S_BW, m0 = blockIdx.y * S_BX;
  const long long z = blockIdx.z;
  const bf16* x = a.x + z * a.bs.x;
  const int8_t* w = a.w + z * a.bs.w;
  const bf16* bias = a.b != nullptr ? a.b + z * a.bs.b : nullptr;
  bf16* y = a.y + z * a.bs.y;
  const int M = a.M, N = a.N, K = a.K;

  const int nkt = (K + S_BK - 1) / S_BK;
  const int kt0 = split * nkt / splits, kt1 = (split + 1) * nkt / splits;
  const int nt = kt1 - kt0;
  const int mrows = min(S_BX, M - m0);
  const int nx = (mrows + 7) >> 3;  // n8 tiles holding rows below M
  const int wrow = warp * 16;       // this warp's first weight row
  const bool live = n0 + wrow < N;

  // Copies: each thread always takes the same 16-byte column of the tile,
  // so its addresses step by whole rows.
  const int wr0 = tid >> 2, wc = (tid & 3) * 16;  // weight rows wr0 + 32i
  const int xr0 = tid >> 3, xc = (tid & 7) * 8;   // x rows xr0 + 16i
  auto load_tile = [&](int kt, int st) {
    const int k0 = kt * S_BK;
    int8_t* wt = wq + st * S_BW * S_BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wr0 + 32 * i, n = n0 + r, k = k0 + wc;
      const int bytes = n < N && k < K ? min(16, K - k) : 0;
      cp_async16(wt + r * S_BK + wc, bytes ? w + n * a.ldw + k : w, bytes);
    }
    bf16* xt = xs + st * S_BX * S_LDX;
    if (VEC_X) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = xr0 + 16 * i, m = m0 + r, k = k0 + xc;
        if (r < nx * 8) {
          const int bytes = m < M && k < K ? 2 * min(8, K - k) : 0;
          cp_async16(xt + r * S_LDX + xc, bytes ? x + m * a.lda + k : x,
                     bytes);
        }
      }
    } else {
      for (int i = tid; i < nx * 8 * S_BK; i += S_NT) {  // the edge path
        const int r = i / S_BK, kk = i % S_BK;
        const int m = m0 + r, k = k0 + kk;
        xt[r * S_LDX + kk] =
            m < M && k < K ? x[m * a.lda + k] : __float2bfloat16_rn(0.f);
      }
    }
  };

  // The scales of this thread's rows g and g + 8 and the block's bias are
  // loaded first and used after the first copies start, so their latency
  // hides behind them.
  float sraw[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + wrow + g + 8 * h;
    sraw[h] = n < N ? a.s[z * a.bs.s + n] : 0.f;
  }
  const bool has_bias = bias != nullptr;
  const bf16 braw = has_bias && tid < S_BW && n0 + tid < N
                        ? bias[n0 + tid] : __float2bfloat16_rn(0.f);
#pragma unroll
  for (int s = 0; s < S_STAGES - 1; ++s) {
    if (s < nt) load_tile(kt0 + s, s);
    cp_async_commit();
  }
  const RowScale sr[2] = {row_scale(sraw[0]), row_scale(sraw[1])};
  if (tid < S_BW) sbias[tid] = __bfloat162float(braw);
  STAMP(tid == 0, 1);  // prologue: scales read, the first copies issued

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < nt; ++i) {
    cp_async_wait<S_STAGES - 2>();  // tile i has landed for this thread
    __syncthreads();                // ... for every thread, and tile i - 1
                                    // is no longer read by anyone
    STAMP(tid == 0 && i < 16, 2 + 2 * i);  // tile i landed
    if (i + S_STAGES - 1 < nt)
      load_tile(kt0 + i + S_STAGES - 1, (i + S_STAGES - 1) % S_STAGES);
    cp_async_commit();  // possibly empty: one group per tile
    if (!live) continue;
    const int st = i % S_STAGES;
    const int8_t* wt = wq + st * S_BW * S_BK;
    const bf16* xt = xs + st * S_BX * S_LDX;
    // Every fragment of the tile first, so no mma waits on its own load:
    // 16 bytes of weight rows g and g + 8, 32 bytes of each x row 8j + g.
    const uint4 wg = *reinterpret_cast<const uint4*>(
        wt + (wrow + g) * S_BK + 16 * t);
    const uint4 wg8 = *reinterpret_cast<const uint4*>(
        wt + (wrow + g + 8) * S_BK + 16 * t);
    uint4 xf[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nx) {
        const bf16* xr = xt + (8 * j + g) * S_LDX + 16 * t;
        xf[j][0] = *reinterpret_cast<const uint4*>(xr);
        xf[j][1] = *reinterpret_cast<const uint4*>(xr + 8);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // k16 step c: bytes 4c .. 4c + 3
      // word c of rows g and g + 8: fragment columns 2t, 2t+1 (bytes 0, 1)
      // and 2t+8, 2t+9 (bytes 2, 3)
      const uint32_t lo = c == 0 ? wg.x : c == 1 ? wg.y : c == 2 ? wg.z : wg.w;
      const uint32_t hi = c == 0 ? wg8.x : c == 1 ? wg8.y
                          : c == 2 ? wg8.z : wg8.w;
      uint32_t af[4];
      dequant_word<SCALE_BF16>(lo, sr[0], af[0], af[2]);
      dequant_word<SCALE_BF16>(hi, sr[1], af[1], af[3]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nx) {
          const uint4& v = xf[j][c >> 1];
          if (c & 1)
            mma_bf16(acc[j], af, v.z, v.w);
          else
            mma_bf16(acc[j], af, v.x, v.y);
        }
      }
    }
    STAMP(tid == 0 && i < 16, 3 + 2 * i);  // tile i's products issued
  }

  // acc[j][e] is y[m0 + 8j + 2t + (e & 1)][n0 + wrow + g + 8(e >> 1)]
  if (splits == 1) {
    if (!live) return;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 8 * j + 2 * t + (e & 1);
        const int nl = wrow + g + 8 * (e >> 1);
        if (j < nx && m < M && n0 + nl < N)
          y[m * a.ldy + n0 + nl] = finish(acc[j][e], has_bias, sbias[nl]);
      }
    }
    STAMP(tid == 0, 42);  // y stored
    return;
  }

  // Split-K inside the cluster. The 128 thread slots of the tile are dealt
  // out to the cluster's blocks, ceil(128 / S) each: every block stores the
  // E = 4·nx partial sums of each of its threads into the shared memory of
  // the block that owns that thread's slot ([split][e][slot]), one cluster
  // barrier makes them visible, and each block sums its slots' partials in
  // split order 0..S-1 from its own shared memory. The wait closes the
  // arrive at entry: every block of the cluster has started.
  cluster_wait();
  STAMP(tid == 0, 40);  // every block of the cluster has started
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int E = 4 * nx;
  const int slots = (S_NT + splits - 1) / splits;
  const int owner = tid / slots;
  float* dst = cluster.map_shared_rank(recv, owner) + split * E * slots +
               (tid - owner * slots);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (j < nx) dst[(4 * j + e) * slots] = acc[j][e];
  cluster.sync();
  STAMP(tid == 0, 41);  // partials stored and visible
  const int lo = split * slots, ns = min(slots, S_NT - lo);
  for (int idx = tid; idx < ns * E; idx += S_NT) {
    const int e = idx / ns, sl = idx - e * ns;
    const float* p = recv + e * slots + sl;
    float part[S_MAX_SPLITS];  // every partial first, then the ordered sum
#pragma unroll
    for (int s = 0; s < S_MAX_SPLITS; ++s)
      part[s] = s < splits ? p[s * E * slots] : 0.f;
    float sum = part[0];
#pragma unroll
    for (int s = 1; s < S_MAX_SPLITS; ++s)
      if (s < splits) sum = __fadd_rn(sum, part[s]);
    const int slot = lo + sl;  // the thread whose fragment this is
    const int m = m0 + 8 * (e >> 2) + 2 * (slot & 3) + (e & 1);
    const int nl = (slot >> 5) * 16 + ((slot & 31) >> 2) + 8 * ((e >> 1) & 1);
    if (m < M && n0 + nl < N)
      y[m * a.ldy + n0 + nl] = finish(sum, has_bias, sbias[nl]);
  }
  STAMP(tid == 0, 42);  // y stored
}

// -------------------------------------------------- (b) the wgmma kernel
constexpr int G_BN = 128;  // weight rows per block: 64 per consumer warpgroup
constexpr int G_BM = 128;  // x rows per block: wgmma's n
constexpr int G_BK = 64;   // depth of a tile: one 128-byte swizzle row of x
constexpr int G_SX = 6;    // stages of x tiles
constexpr int G_SQ = 6;    // stages of int8 weight tiles
constexpr int G_NT = 320;  // 2 consumer warpgroups + 2 TMA warps
constexpr int G_X_BYTES = G_BM * G_BK * 2;
constexpr int G_Q_BYTES = G_BN * G_BK;
constexpr int G_SMEM = 1024 + G_SX * G_X_BYTES + G_SQ * G_Q_BYTES +
                       2 * (G_SX + G_SQ) * 8;
static_assert(G_X_BYTES % 1024 == 0,
              "the 128-byte-swizzled x tiles must start on 1024-byte bounds");

#define VMT_ACC8(i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 weight rows x 128 x rows, f32, the warpgroup's accumulator) =
// A (64 x 16 bf16 from registers: the dequantized weights) . B^T (B: 128 x
// rows x 16, bf16 K-major in shared memory) (+ d unless accumulate is 0).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : VMT_ACC8(0), VMT_ACC8(8), VMT_ACC8(16), VMT_ACC8(24), VMT_ACC8(32),
        VMT_ACC8(40), VMT_ACC8(48), VMT_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

#undef VMT_ACC8

// Keeps the compiler from moving accumulator reads across a
// wgmma.wait_group. (No zero-fill: the first product overwrites the
// accumulators, so no other instruction defines them, C7515.)
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <bool SCALE_BF16>
__global__ void __launch_bounds__(G_NT, 1) int8_linear_bf16_wgmma_kernel(
    const Args a, const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* xs = reinterpret_cast<bf16*>(base);                       // [SX]
  int8_t* wq = reinterpret_cast<int8_t*>(base + G_SX * G_X_BYTES);  // [SQ]
  uint64_t* xfull = reinterpret_cast<uint64_t*>(wq + G_SQ * G_Q_BYTES);
  uint64_t* xempty = xfull + G_SX;
  uint64_t* qfull = xempty + G_SX;
  uint64_t* qempty = qfull + G_SQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * G_BN, m0 = blockIdx.y * G_BM;
  const int N = a.N;
  const int nkt = (a.K + G_BK - 1) / G_BK;
  if (tid == 0) {
    for (int s = 0; s < G_SX; ++s) {
      mbar_init(xfull + s, 1);   // the x tile's TMA (expect_tx)
      mbar_init(xempty + s, 8);  // every consumer warp's wgmma has retired
    }
    for (int s = 0; s < G_SQ; ++s) {
      mbar_init(qfull + s, 1);   // the int8 tile's TMA (expect_tx)
      mbar_init(qempty + s, 8);  // every consumer warp holds its fragments
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  STAMP(tid == 0, 0);

  if (warp >= 8) {  // the TMA warps: x, and the int8 weights
    if (lane == 0) {
      const bool is_x = warp == 8;
      const int stages = is_x ? G_SX : G_SQ;
      uint64_t* fullb = is_x ? xfull : qfull;
      uint64_t* emptyb = is_x ? xempty : qempty;
      for (int it = 0; it < nkt; ++it) {
        const int s = it % stages;
        if (it >= stages) mbar_wait(emptyb + s, ((it / stages) - 1) & 1);
        STAMP(it < 8, 72 + 8 * (warp - 8) + it);  // load it issued
        mbar_expect_tx(fullb + s, is_x ? G_X_BYTES : G_Q_BYTES);
        if (is_x)
          tma_load_3d(xs + s * G_BM * G_BK, &xmap, it * G_BK, m0, 0,
                      fullb + s);
        else
          tma_load_3d(wq + s * G_Q_BYTES, &wmap, it * G_BK, n0, 0,
                      fullb + s);
      }
    }
    return;
  }

  // The consumers: warp w of warpgroup wg owns weight rows
  // n0 + 64wg + 16w .. + 15, the A operand's rows g and g + 8 for thread
  // (g, t), and dequantizes them from the int8 tile into its A fragments:
  // columns 2t, 2t+1, 2t+8, 2t+9 of each k16 step, the bytes 2t, 2t+1 of
  // word t/2 and of word 2 + t/2 of the step's 16 bytes.
  const int g = lane >> 2, t = lane & 3;
  const int wrow = (warp >> 2) * 64 + (warp & 3) * 16;
  const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
  RowScale sr[2];
  float br[2];
  const bool hb = a.b != nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + wrow + g + 8 * h;
    sr[h] = row_scale(n < N ? a.s[n] : 0.f);
    br[h] = hb && n < N ? __bfloat162float(a.b[n]) : 0.f;
  }
  float acc[64];  // defined by the first wgmma (accumulate = 0)
  // Phase stamps: warpgroup wg's first thread, its first 8 tiles.
#define WG_STAMP(p) STAMP((tid & 127) == 0 && it < 8, \
                          8 + 32 * (warp >> 2) + 4 * it + (p))
  for (int it = 0; it < nkt; ++it) {
    const int sq = it % G_SQ, sx = it % G_SX;
    mbar_wait(qfull + sq, (it / G_SQ) & 1);
    WG_STAMP(0);  // the weight tile landed
    const int8_t* qt = wq + sq * G_Q_BYTES;
    uint32_t frag[4][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // Row r's 16-byte piece kk lies at piece kk ^ ((r / 2) % 4): the
      // 64-byte swizzle of the tensor map, so the 8 rows of a warp's loads
      // fall in 8 different bank quads.
      const int r = wrow + g + 8 * h;
      const uint32_t* row = reinterpret_cast<const uint32_t*>(qt + r * G_BK);
#pragma unroll
      for (int kk = 0; kk < G_BK / 16; ++kk) {
        const int piece = 4 * (kk ^ ((r >> 1) & 3));
        const uint32_t word = __byte_perm(row[piece + (t >> 1)],
                                          row[piece + 2 + (t >> 1)], sel);
        dequant_word<SCALE_BF16>(word, sr[h], frag[kk][h], frag[kk][2 + h]);
      }
    }
    WG_STAMP(1);  // dequantized
    __syncwarp();
    if (lane == 0) mbar_arrive(qempty + sq);  // this warp holds its bytes
    mbar_wait(xfull + sx, (it / G_SX) & 1);
    WG_STAMP(2);  // the x tile landed
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint32_t xa = smem_addr(xs + sx * G_BM * G_BK);
#pragma unroll
    for (int kk = 0; kk < G_BK / 16; ++kk)
      wgmma_rs(acc, frag[kk], sw128_desc(xa + 32 * kk), it > 0 || kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // Retire the tile before its fragments' registers are rewritten (a
    // product still in flight while they are would make ptxas serialize
    // every wgmma, C7513); the other warpgroup's products fill the gap.
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    WG_STAMP(3);  // products retired
    if (lane == 0) mbar_arrive(xempty + sx);  // the x stage has been read
  }

  // acc[4j + 2h + e] is y[m0 + 8j + 2t + e][n0 + wrow + g + 8h]: the
  // product comes out transposed.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + wrow + g + 8 * h;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < G_BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * t + e;
        if (m < a.M)
          a.y[(long long)m * a.ldy + n] = finish(acc[4 * j + 2 * h + e], hb,
                                                  br[h]);
      }
    }
  }
  STAMP((tid & 127) == 0, 88 + (warp >> 2));  // y stored
#undef WG_STAMP
}

// ------------------------------------------------------------- f32 kernel
constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_NT = 256;

__global__ void __launch_bounds__(F_NT) int8_linear_f32_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ y, int M, int N, int K, long long lda, long long ldw,
    long long ldy, Batch bs) {
  __shared__ float xs[F_BK][F_BM + 1];
  __shared__ float ws[F_BK][F_BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // columns tx + 16j, rows ty + 16i
  const int n0 = blockIdx.x * F_BN;
  const int m0 = blockIdx.y * F_BM;
  const long long z = blockIdx.z;
  x += z * bs.x;
  w += z * bs.w;
  scale += z * bs.s;
  if (bias != nullptr) bias += z * bs.b;
  y += z * bs.y;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += F_BK) {
    for (int i = tid; i < F_BM * F_BK; i += F_NT) {
      const int r = i / F_BK, k = k0 + i % F_BK;
      xs[i % F_BK][r] = m0 + r < M && k < K ? x[(m0 + r) * lda + k] : 0.f;
    }
    for (int i = tid; i < F_BN * F_BK; i += F_NT) {
      const int r = i / F_BK, k = k0 + i % F_BK;
      ws[i % F_BK][r] = n0 + r < N && k < K
                            ? __fmul_rn((float)w[(n0 + r) * ldw + k],
                                        scale[n0 + r])
                            : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty + 16 * i, c = n0 + tx + 16 * j;
      if (r < M && c < N)
        y[r * ldy + c] =
            bias != nullptr ? __fadd_rn(acc[i][j], bias[c]) : acc[i][j];
    }
  }
}

// ---------------------------------------------------------------- launch
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <bool VEC_X, bool SCALE_BF16>
int launch_stream(const Args& a, int batch, cudaStream_t st) {
  static bool smem_ready = false;  // once per instantiation and process
  auto kernel = int8_linear_bf16_stream_kernel<VEC_X, SCALE_BF16>;
  if (!smem_ready) {
    cudaError_t rc = allow_smem(kernel, S_SMEM);
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (rc != cudaSuccess) return (int)rc;
    smem_ready = true;
  }
  const long long gx = (long long)((a.N + S_BW - 1) / S_BW) * a.splits;
  const long long gy = (a.M + S_BX - 1) / S_BX;
  if (gx > 2147483647LL || gy > 65535 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  // The splits of one output tile are one cluster (consecutive blocks).
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)gx, (unsigned)gy, batch);
  cfg.blockDim = dim3(S_NT, 1, 1);
  cfg.dynamicSmemBytes = S_SMEM;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, a);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

template <bool SCALE_BF16>
int launch_wgmma(const Args& a, const CUtensorMap& xmap,
                 const CUtensorMap& wmap, cudaStream_t st) {
  static bool smem_ready = false;
  auto kernel = int8_linear_bf16_wgmma_kernel<SCALE_BF16>;
  if (!smem_ready) {
    const cudaError_t rc = allow_smem(kernel, G_SMEM);
    if (rc != cudaSuccess) return (int)rc;
    smem_ready = true;
  }
  const long long gy = (a.M + G_BM - 1) / G_BM;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((a.N + G_BN - 1) / G_BN, (unsigned)gy, 1), G_NT, G_SMEM,
           st>>>(a, xmap, wmap);
  return (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

namespace {

// A 3-D tensor map of batch x rows x cols elements (row stride ld, batch
// stride bstride, in elements) in boxes of G_BK columns x box_rows rows x 1,
// into out (128 bytes).
int encode(void* out, const void* p, CUtensorMapDataType type, int esize,
           int rows, int cols, long long ld, int batch, long long bstride,
           int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  if (batch == 1) bstride = (rows * ld * esize + 15) / 16 * 16 / esize;
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)(ld * esize),
                                 (cuuint64_t)(bstride * esize)};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult rc = fn(&map, type, 3, const_cast<void*>(p), dims, strides,
                         box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc != CUDA_SUCCESS) return (int)rc;
  memcpy(out, &map, sizeof(map));
  return 0;
}

}  // namespace

// The TMA tensor map of an operand, written to out (128 bytes): kind 0 an
// int8 weight (batch x rows x cols, 64-byte-swizzled boxes), kind 1 a bf16
// x (128-byte-swizzled boxes); boxes of 64 columns x box_rows rows x 1.
// Strides in elements.
// Returns 0, or a CUresult (-1 when cuTensorMapEncodeTiled cannot be
// found).
extern "C" int vmt_int8_tensor_map(void* out, const void* p, int kind,
                                   int batch, int rows, int cols,
                                   long long ld, long long bstride,
                                   int box_rows) {
  if (kind == 0)
    return encode(out, p, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, rows, cols, ld,
                  batch, bstride, 64, box_rows, CU_TENSOR_MAP_SWIZZLE_64B);
  return encode(out, p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rows, cols, ld,
                batch, bstride, 64, box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

// dtype: 0 = float32, 1 = bfloat16 (x, bias and y). Strides are in elements
// and K is contiguous in x and q. For bf16: ldw and w_sb are multiples of 16
// and q is 16-byte aligned; vec_x = 1 (K % 8 == 0) also needs lda and x_sb
// multiples of 8 and x 16-byte aligned, which the Python wrapper checks.
// regime (bf16 only, from ops/int8_linear.py:plan_launch): 0 = stream, with
// `splits` K ranges (1 to 16, a cluster each); 1 = wgmma (batch 1, vec_x,
// splits 1). xmap and wmap, read by the wgmma regime only (null for the
// stream regime), are the operands' tensor maps from vmt_int8_tensor_map,
// in boxes of 128 rows.
// scale_bf16 says every scale is exact in bf16 (the trunk's); bias may be
// null.
extern "C" int vmt_int8_linear(int dtype, const void* x, const void* w,
                               const void* scale, const void* bias, void* y,
                               int batch, int M, int N, int K, long long lda,
                               long long ldw, long long ldy, long long x_sb,
                               long long w_sb, long long s_sb, long long b_sb,
                               long long y_sb, int vec_x, int scale_bf16,
                               int regime, int splits, const void* xmap,
                               const void* wmap, void* stream) {
  if (batch < 1 || M < 1 || N < 1 || K < 1 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const Batch bs{x_sb, w_sb, s_sb, b_sb, y_sb};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM, batch);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    int8_linear_f32_kernel<<<grid, F_NT, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<float*>(y), M, N, K, lda, ldw, ldy, bs);
    return (int)cudaGetLastError();
  }
  const int nkt = (K + S_BK - 1) / S_BK;
  if (dtype != 1 || ldw % 16 || w_sb % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      (vec_x && (K % 8 || lda % 8 || x_sb % 8 ||
                 reinterpret_cast<uintptr_t>(x) % 16)) ||
      splits < 1 || splits > nkt) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{static_cast<const bf16*>(x),
               static_cast<const int8_t*>(w),
               static_cast<const float*>(scale),
               static_cast<const bf16*>(bias),
               static_cast<bf16*>(y),
               M,
               N,
               K,
               lda,
               ldw,
               ldy,
               bs,
               splits};
  if (regime == 1) {
    if (batch != 1 || !vec_x || splits != 1 || xmap == nullptr ||
        wmap == nullptr)
      return (int)cudaErrorInvalidValue;
    CUtensorMap xm, wm;
    memcpy(&xm, xmap, sizeof(xm));
    memcpy(&wm, wmap, sizeof(wm));
    return scale_bf16 ? launch_wgmma<true>(a, xm, wm, st)
                      : launch_wgmma<false>(a, xm, wm, st);
  }
  if (regime != 0 || splits > S_MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  if (vec_x)
    return scale_bf16 ? launch_stream<true, true>(a, batch, st)
                      : launch_stream<true, false>(a, batch, st);
  return scale_bf16 ? launch_stream<false, true>(a, batch, st)
                    : launch_stream<false, false>(a, batch, st);
}

#ifdef VMT_INT8_PHASES
// Copy the 128 phase stamps to host and zero them on the card.
extern "C" int vmt_int8_phases_take(long long* host) {
  static const long long zeros[128] = {};
  cudaError_t rc = cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
  if (rc == cudaSuccess) rc = cudaMemcpyToSymbol(g_phase, zeros, sizeof(zeros));
  return (int)rc;
}
#endif
