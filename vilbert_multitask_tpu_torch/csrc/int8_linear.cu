// Weight-only int8 GEMM for the int8 serving mode: y = x . W^T (+ b), with
// W[n, k] = round_to_x_dtype(q[n, k] * s[n]) dequantized inside the kernel.
//
// Replaces no Pallas kernel. In the JAX package, EngineConfig.param_dtype =
// "int8" stores every matrix as per-channel {"int8", "scale"} pairs
// (vilbert_multitask_tpu/quant.py:70-99) and dequantizes them inside the
// jitted forward (engine/runtime.py:684-705), where XLA fuses the
// dequantization into each consuming matmul, so weights are read as int8.
// Eager PyTorch fuses nothing: dequantizing first would write and read a
// bf16 copy of every weight on every forward. This kernel is that fused
// work: int8 weight tiles come from device memory and are dequantized in
// shared memory, next to the product.
//
// The function, per batch entry, for x (M, K) in bf16 or f32, q (N, K) int8
// with K contiguous (torch's Linear layout), an f32 scale s (N,) and an
// optional bias b (N,) in x's type:
//   W[n, k] = round(fmul_rn(float(q[n, k]), s[n]))   (round: to x's type)
//   y       = round(x . W^T), f32 accumulation
//   y       = round(y + b)
// the two roundings of flax's Dense (the product, then the bias). The trunk
// passes s already rounded to bf16, so one rounding of the exact product
// gives JAX's bf16(q) * bf16(s); the head slabs pass the f32 scale, so the
// product is rounded to f32 and then to bf16, as JAX's f32 dequantization
// followed by .astype(bf16) is. __fmul_rn keeps the compiler from folding
// the dequantization into an FMA.
//
// What bounds it on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16 dense): at
// serving shapes of one request (M = 38 or 101 rows) a layer moves N.K int8
// weight bytes for 2.M.N.K operations, about 76 or 202 operations per byte,
// under the ~295 at which the tensor cores and not the memory are the limit:
// bucket 1 is bound by the weight bytes. At bucket 32 (M = 3232) it is bound
// by the tensor cores.
//
// The bf16 kernel (every served request): one block of 4 warps per (64 rows
// of x, 64 rows of q, batch entry); each warp owns a 32 x 32 piece of the
// output as 2 x 4 accumulator tiles of mma.sync m16n8k16 (bf16 x bf16 ->
// f32). K moves in tiles of 64 through two stages of 16-byte cp.async.cg
// copies (tile t + 1 in flight while tile t is multiplied): x as bf16 rows
// padded to 72 elements, q as raw int8 rows. Each landed int8 tile is
// dequantized by all 128 threads (16 values each, 16 bytes in, 32 bytes
// out) into one bf16 tile of the same padded layout, from which ldmatrix
// loads the B fragments exactly as the flash kernel loads K
// (csrc/flash_attn.cu). Rows at or past M and N and columns at or past K
// are zero-filled by the copies (src-size below 16), never read.
//  - q's row stride must be a multiple of 16 bytes (QuantLinear pads K = 5
//    to 16 at load); the wrapper checks it and raises otherwise.
//  - x is copied 16 bytes at a time when K % 8 == 0 (its row and batch
//    strides then must be multiples of 8 elements, which the wrapper checks).
//    For other K (the 5 box coordinates of image_location_embeddings) the
//    kernel's edge path loads x one element at a time.
// Static shared memory: 2 x 64 x 72 x 2 (x) + 2 x 64 x 64 (q) + 64 x 72 x 2
// (W) + 64 x 4 (scales) = 36,096 bytes.
// mma.sync and cp.async, not wgmma and TMA, and no split-K: a first kernel
// that is right; PERF.md holds its times against its bound.
//
// The f32 kernel (the f32 parity engines) stays on CUDA cores: 64 x 64
// output tiles, 256 threads of 4 x 4 outputs, K in tiles of 16 loaded one
// element at a time (any strides), f32 FMAs.
//
// C interface (bound with ctypes): vmt_int8_linear launches on the given
// stream, allocates nothing, and returns a cudaError_t as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

struct Batch {  // element strides between the entries of a batch
  long long x, w, s, b, y;
};

// ------------------------------------------------------------ bf16 kernel
constexpr int BM = 64;        // rows of x per block
constexpr int BN = 64;        // rows of q (output columns) per block
constexpr int BK = 64;        // depth per tile
constexpr int NT = 128;       // threads per block: 4 warps, 2 x 2
constexpr int LDS = BK + 8;   // bf16 row stride in shared memory (144 bytes)

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

__device__ __forceinline__ uint32_t dequant_pair(uint32_t word, int byte,
                                                 float s) {
  const float lo = (float)(int8_t)(word >> (8 * byte));
  const float hi = (float)(int8_t)(word >> (8 * byte + 8));
  const __nv_bfloat162 h =
      __halves2bfloat162(__float2bfloat16_rn(__fmul_rn(lo, s)),
                         __float2bfloat16_rn(__fmul_rn(hi, s)));
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <bool VEC_X>
__global__ void __launch_bounds__(NT) int8_linear_bf16_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, const bf16* __restrict__ bias,
    bf16* __restrict__ y, int M, int N, int K, long long lda, long long ldw,
    long long ldy, Batch bs) {
  __shared__ __align__(16) bf16 xs[2][BM * LDS];
  __shared__ __align__(16) int8_t wq[2][BN * BK];
  __shared__ __align__(16) bf16 ws[BN * LDS];
  __shared__ float ss[BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int wm = (wid >> 1) * 32;  // this warp's first row in the tile
  const int wn = (wid & 1) * 32;   // ... and first output column
  const int g = lane >> 2;         // accumulator row (and row + 8)
  const int t = lane & 3;          // accumulator columns 2t, 2t + 1
  // ldmatrix.x4 addressing (see csrc/flash_attn.cu): x as A fragments of
  // 16 rows x 16 deep; W as the B fragments of two 8-column tiles.
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const long long z = blockIdx.z;
  x += z * bs.x;
  w += z * bs.w;
  scale += z * bs.s;
  if (bias != nullptr) bias += z * bs.b;
  y += z * bs.y;

  if (tid < BN) ss[tid] = n0 + tid < N ? scale[n0 + tid] : 0.f;

  auto load_tile = [&](int kt, int st) {
    const int k0 = kt * BK;
    if (VEC_X) {
#pragma unroll
      for (int i = 0; i < BM * BK / 8 / NT; ++i) {  // 4 pieces of 8 bf16
        const int c = tid + i * NT;
        const int r = c >> 3, k = k0 + (c & 7) * 8;
        const bool real = m0 + r < M && k < K;
        const int bytes = real ? 2 * min(8, K - k) : 0;
        cp_async16(&xs[st][r * LDS + (c & 7) * 8],
                   real ? x + (m0 + r) * lda + k : x, bytes);
      }
    } else {
      for (int i = tid; i < BM * BK; i += NT) {  // the edge path
        const int r = i / BK, k = k0 + i % BK;
        xs[st][r * LDS + i % BK] = m0 + r < M && k < K
                                       ? x[(m0 + r) * lda + k]
                                       : __float2bfloat16_rn(0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < BN * BK / 16 / NT; ++i) {  // 2 pieces of 16 int8
      const int c = tid + i * NT;
      const int r = c >> 2, k = k0 + (c & 3) * 16;
      const bool real = n0 + r < N && k < K;
      const int bytes = real ? min(16, K - k) : 0;
      cp_async16(&wq[st][r * BK + (c & 3) * 16],
                 real ? w + (n0 + r) * ldw + k : w, bytes);
    }
  };

  const int n_tiles = (K + BK - 1) / BK;
  load_tile(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_tile(1, 1);
  cp_async_commit();

  float acc[2][4][4] = {};
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    cp_async_wait<1>();  // tile kt has landed for this thread
    __syncthreads();     // ... and for every thread
    // Dequantize the int8 tile into ws: 16 values a piece, one scale per
    // row of q.
#pragma unroll
    for (int i = 0; i < BN * BK / 16 / NT; ++i) {
      const int c = tid + i * NT;
      const int r = c >> 2, col = (c & 3) * 16;
      const uint4 q16 = *reinterpret_cast<const uint4*>(&wq[st][r * BK + col]);
      const float s = ss[r];
      uint4 lo, hi;
      lo.x = dequant_pair(q16.x, 0, s);
      lo.y = dequant_pair(q16.x, 2, s);
      lo.z = dequant_pair(q16.y, 0, s);
      lo.w = dequant_pair(q16.y, 2, s);
      hi.x = dequant_pair(q16.z, 0, s);
      hi.y = dequant_pair(q16.z, 2, s);
      hi.z = dequant_pair(q16.w, 0, s);
      hi.w = dequant_pair(q16.w, 2, s);
      *reinterpret_cast<uint4*>(&ws[r * LDS + col]) = lo;
      *reinterpret_cast<uint4*>(&ws[r * LDS + col + 8]) = hi;
    }
    __syncthreads();  // ws holds the tile's W
    const bf16* xt = xs[st];
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t af[2][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], xt + (wm + mi * 16 + a_row) * LDS + kc * 16 + a_col);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4(bfr[np], ws + (wn + np * 16 + b_row) * LDS + kc * 16 + b_col);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma_bf16(acc[mi][2 * np], af[mi], bfr[np][0], bfr[np][1]);
          mma_bf16(acc[mi][2 * np + 1], af[mi], bfr[np][2], bfr[np][3]);
        }
      }
    }
    __syncthreads();  // every warp is done with xs[st] and ws
    if (kt + 2 < n_tiles) load_tile(kt + 2, st);
    cp_async_commit();  // possibly empty: keeps one group per tile
  }

  // Epilogue: round the product to bf16, then add the bias and round again.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm + mi * 16 + g + (e >> 1) * 8;
        const int c = n0 + wn + i * 8 + 2 * t + (e & 1);
        if (r < M && c < N) {
          bf16 v = __float2bfloat16_rn(acc[mi][i][e]);
          if (bias != nullptr)
            v = __float2bfloat16_rn(
                __fadd_rn(__bfloat162float(v), __bfloat162float(bias[c])));
          y[r * ldy + c] = v;
        }
      }
    }
  }
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, bias and y). Strides are in elements
// and K is contiguous in x and q. For bf16, ldw and w_sb are multiples of 16
// and q 16-byte aligned; vec_x = 1 (K % 8 == 0) also needs lda and x_sb
// multiples of 8 and x 16-byte aligned, which the Python wrapper checks.
// bias may be null.
extern "C" int vmt_int8_linear(int dtype, const void* x, const void* w,
                               const void* scale, const void* bias, void* y,
                               int batch, int M, int N, int K, long long lda,
                               long long ldw, long long ldy, long long x_sb,
                               long long w_sb, long long s_sb, long long b_sb,
                               long long y_sb, int vec_x, void* stream) {
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
  if (dtype != 1 || ldw % 16 || w_sb % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      (vec_x && (K % 8 || lda % 8 || x_sb % 8 ||
                 reinterpret_cast<uintptr_t>(x) % 16))) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const int8_t* wb = static_cast<const int8_t*>(w);
  const float* sb = static_cast<const float*>(scale);
  const bf16* bb = static_cast<const bf16*>(bias);
  bf16* yb = static_cast<bf16*>(y);
  if (vec_x) {
    int8_linear_bf16_kernel<true><<<grid, NT, 0, st>>>(
        xb, wb, sb, bb, yb, M, N, K, lda, ldw, ldy, bs);
  } else {
    int8_linear_bf16_kernel<false><<<grid, NT, 0, st>>>(
        xb, wb, sb, bb, yb, M, N, K, lda, ldw, ldy, bs);
  }
  return (int)cudaGetLastError();
}
