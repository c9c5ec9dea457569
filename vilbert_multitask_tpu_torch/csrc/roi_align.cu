// Multi-level ROIAlign for the detector's box head: each proposal pooled
// from its FPN level (P2..P5) into a res x res grid of channel vectors.
//
// Replaces no Pallas kernel: the JAX package computes this with XLA, as
// gathers vmapped over boxes under a lax.switch on the box's level
// (vilbert_multitask_tpu/detect/model.py:roi_align, :185, with the level
// choice of :279-292). The reference ran maskrcnn_benchmark's CUDA
// ROIAlign. The semantics are the JAX function's, not maskrcnn's kernel's:
//   - the level (0..3 for P2..P5) is chosen here, as detect/model.py:
//     fpn_level chooses it: floor(4 + log2(sqrt(max(area, 1)) / 224)),
//     clamped to 2..5, minus 2, with area = (x2 - x1) * (y2 - y1);
//   - a box is scaled to level coordinates by dividing by the level's
//     stride; n = res * sampling points per axis sit at
//     y1 + (i + 0.5) * (y2 - y1) / n;
//   - each point is clipped to [0, H - 1], its low corner to [0, H - 2]
//     (so H, W >= 2), and read bilinearly from the four corners;
//   - each output bin is the mean of its sampling x sampling points.
// Every operation is __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn (and
// IEEE sqrtf, libdevice's log2f: the build has no fast math) in the plain
// version's order, so nothing is contracted into an FMA; only the order of
// the mean's sum may differ from torch's.
//
// Layout: each level map is (H, W, C) f32 with C contiguous, which is what
// the FPN's channels-last NCHW tensors are when permuted to NHWC, so the
// maps are read where they lie; boxes are read through their strides. Out:
// (R, res, res, C) f32 (the JAX layout).
//
// Design: one block per (bin row, box). Its threads first compute the
// box's level and scaled corners, and the geometry of its n sample columns
// and `sampling` sample rows (corner index, weight and one minus it) once,
// into shared memory; then they sweep the channels, each thread 4
// neighbouring channels (a 16-byte load per corner, a 16-byte store per
// output), 64 threads covering C = 256, over the row's res bins. Indices
// are 32-bit. The scalar instance (one channel a thread) is the same code
// for maps whose base or row and column strides are not on 16 bytes or whose
// C % 4 != 0; the wrapper (detect/model.py:roi_vector_width) picks it from
// the shapes and pointers.
//
// What bounds it on the H100 (3.35 TB/s, 67 TFLOP/s f32): at the serving
// shape (300 boxes, res 7, sampling 2, C 256) it writes 3.76 M floats
// (15 MB) and reads the map elements the boxes' sample points touch, each
// once (chip_smoke.py counts them from each run's boxes): bytes bound it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 4;
constexpr int kMaxThreads = 256;
constexpr int kMaxSamples = 64;  // res * sampling per axis

struct Level {
  const float* feat;
  int sh, sw;  // element strides of rows and columns (C is 1)
  int H, W;
  float stride;
};

struct Levels {
  Level l[kLevels];
};

template <int V>
struct Vec;
template <>
struct Vec<1> {
  typedef float T;
};
template <>
struct Vec<4> {
  typedef float4 T;
};

__device__ __forceinline__ float sample_point(float lo, float extent, int i,
                                              int n) {
  return __fadd_rn(lo, __fdiv_rn(__fmul_rn(__fadd_rn((float)i, 0.5f),
                                           extent), (float)n));
}

// detect/model.py:fpn_level, 0..3 for P2..P5.
__device__ __forceinline__ int fpn_level(float area) {
  const float lvl = floorf(__fadd_rn(
      4.f, log2f(__fdiv_rn(sqrtf(fmaxf(area, 1.f)), 224.f))));
  return (int)fminf(fmaxf(lvl, 2.f), 5.f) - 2;
}

__device__ __forceinline__ float bilinear(float f00, float f01, float f10,
                                          float f11, float wy, float vy,
                                          float wx, float vx) {
  float v = __fmul_rn(__fmul_rn(f00, vy), vx);
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(f01, vy), wx));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(f10, wy), vx));
  return __fadd_rn(v, __fmul_rn(__fmul_rn(f11, wy), wx));
}

__device__ __forceinline__ void accumulate(float& acc, float f00, float f01,
                                           float f10, float f11, float wy,
                                           float vy, float wx, float vx) {
  acc = __fadd_rn(acc, bilinear(f00, f01, f10, f11, wy, vy, wx, vx));
}

__device__ __forceinline__ void accumulate(float4& acc, float4 f00,
                                           float4 f01, float4 f10, float4 f11,
                                           float wy, float vy, float wx,
                                           float vx) {
  accumulate(acc.x, f00.x, f01.x, f10.x, f11.x, wy, vy, wx, vx);
  accumulate(acc.y, f00.y, f01.y, f10.y, f11.y, wy, vy, wx, vx);
  accumulate(acc.z, f00.z, f01.z, f10.z, f11.z, wy, vy, wx, vx);
  accumulate(acc.w, f00.w, f01.w, f10.w, f11.w, wy, vy, wx, vx);
}

__device__ __forceinline__ float mean_of(float acc, float count) {
  return __fdiv_rn(acc, count);
}

__device__ __forceinline__ float4 mean_of(float4 acc, float count) {
  return make_float4(__fdiv_rn(acc.x, count), __fdiv_rn(acc.y, count),
                     __fdiv_rn(acc.z, count), __fdiv_rn(acc.w, count));
}

// V: channels a thread (4: float4, 1: scalar); S: the sampling ratio when
// it is known here (2, the detector's: every load of a bin in flight at
// once), else 0 and the runtime `sampling`.
template <int V, int S>
__global__ void __launch_bounds__(kMaxThreads) roi_align_kernel(
    Levels levels, const float* __restrict__ boxes, long long sbr,
    long long sbc, int C, int res, int sampling_arg,
    float* __restrict__ out) {
  typedef typename Vec<V>::T T;
  const int sampling = S > 0 ? S : sampling_arg;
  __shared__ int x0s[kMaxSamples], y0s[kMaxSamples];
  __shared__ float wxs[kMaxSamples], vxs[kMaxSamples];
  __shared__ float wys[kMaxSamples], vys[kMaxSamples];
  const int by = blockIdx.x, r = blockIdx.y, t = threadIdx.x;
  const int n = res * sampling;
  // Every thread: the box's level and its corners in level coordinates.
  const float* b = boxes + r * sbr;
  const float bx1 = b[0], by1 = b[sbc], bx2 = b[2 * sbc], by2 = b[3 * sbc];
  const int l = fpn_level(__fmul_rn(__fsub_rn(bx2, bx1), __fsub_rn(by2, by1)));
  const Level L = l == 0 ? levels.l[0]
                  : l == 1 ? levels.l[1]
                  : l == 2 ? levels.l[2] : levels.l[3];
  if (t < n) {  // sample column t
    const float x1 = __fdiv_rn(bx1, L.stride), x2 = __fdiv_rn(bx2, L.stride);
    const float gx = sample_point(x1, __fsub_rn(x2, x1), t, n);
    const float xx = fminf(fmaxf(gx, 0.f), (float)(L.W - 1));
    const int x0 = min(max((int)floorf(xx), 0), L.W - 2);
    const float wx = __fsub_rn(xx, (float)x0);
    x0s[t] = x0;
    wxs[t] = wx;
    vxs[t] = __fsub_rn(1.f, wx);
  } else if (t < n + sampling) {  // sample row by * sampling + (t - n)
    const int s = t - n;
    const float y1 = __fdiv_rn(by1, L.stride), y2 = __fdiv_rn(by2, L.stride);
    const float gy = sample_point(y1, __fsub_rn(y2, y1), by * sampling + s, n);
    const float yy = fminf(fmaxf(gy, 0.f), (float)(L.H - 1));
    const int y0 = min(max((int)floorf(yy), 0), L.H - 2);
    const float wy = __fsub_rn(yy, (float)y0);
    y0s[s] = y0;
    wys[s] = wy;
    vys[s] = __fsub_rn(1.f, wy);
  }
  __syncthreads();
  const float count = (float)(sampling * sampling);
  const int cv = C / V;
  T* orow = reinterpret_cast<T*>(out + (r * res + by) * res * C);
  for (int c = t; c < cv; c += blockDim.x) {
    const float* f = L.feat + c * V;
    for (int bx = 0; bx < res; ++bx) {
      T acc;
      acc = T{};
#pragma unroll
      for (int sy = 0; sy < (S > 0 ? S : sampling); ++sy) {
        const float wy = wys[sy], vy = vys[sy];
        const float* fy = f + y0s[sy] * L.sh;
#pragma unroll
        for (int sx = 0; sx < (S > 0 ? S : sampling); ++sx) {
          const int i = bx * sampling + sx;
          const T* p = reinterpret_cast<const T*>(fy + x0s[i] * L.sw);
          const T* q = reinterpret_cast<const T*>(fy + x0s[i] * L.sw + L.sh);
          const T f00 = p[0], f10 = q[0];
          const T f01 = *reinterpret_cast<const T*>(
              reinterpret_cast<const float*>(p) + L.sw);
          const T f11 = *reinterpret_cast<const T*>(
              reinterpret_cast<const float*>(q) + L.sw);
          accumulate(acc, f00, f01, f10, f11, wy, vy, wxs[i], vxs[i]);
        }
      }
      orow[bx * cv + c] = mean_of(acc, count);
    }
  }
}

}  // namespace

// feats[l]: level l's (H[l], W[l], C) f32 map, rows sh[l] and columns sw[l]
// elements apart, channels contiguous; strides[l]: its stride in pixels;
// boxes: (R, 4) f32 xyxy in pixels, box r's coordinates at boxes + r*sbr +
// {0, 1, 2, 3}*sbc; vec: 4 for the float4 instance (C % 4 == 0, every map's
// base and sh, sw on 16 bytes), 1 for the scalar one; out: (R, res, res, C)
// f32 contiguous. Returns the CUDA error of the launch.
extern "C" int vmt_roi_align(const float* const* feats, const int* H,
                             const int* W, const long long* sh,
                             const long long* sw, const float* strides,
                             const float* boxes, long long sbr, long long sbc,
                             int R, int C, int res, int sampling, int vec,
                             float* out, void* stream) {
  const int n = res * sampling;
  if (R < 1 || R > 65535 || C < 1 || res < 1 || sampling < 1 ||
      n > kMaxSamples || (vec != 1 && vec != 4) || C % vec != 0 ||
      (long long)R * res * res * C > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  Levels levels;
  for (int l = 0; l < kLevels; ++l) {
    if (H[l] < 2 || W[l] < 2 || sh[l] < 0 || sw[l] < 0 ||
        (H[l] - 1) * sh[l] + (W[l] - 1) * sw[l] + C > 0x7fffffffLL ||
        (vec == 4 && (reinterpret_cast<uintptr_t>(feats[l]) % 16 != 0 ||
                      sh[l] % 4 != 0 || sw[l] % 4 != 0))) {
      return (int)cudaErrorInvalidValue;
    }
    levels.l[l] = Level{feats[l], (int)sh[l], (int)sw[l], H[l], W[l],
                        strides[l]};
  }
  const int lanes = C / vec;
  int threads = ((lanes + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < n + sampling) threads = ((n + sampling + 31) / 32) * 32;
  const dim3 grid(res, R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4 && sampling == 2) {
    roi_align_kernel<4, 2><<<grid, threads, 0, st>>>(levels, boxes, sbr, sbc,
                                                     C, res, sampling, out);
  } else if (vec == 4) {
    roi_align_kernel<4, 0><<<grid, threads, 0, st>>>(levels, boxes, sbr, sbc,
                                                     C, res, sampling, out);
  } else if (sampling == 2) {
    roi_align_kernel<1, 2><<<grid, threads, 0, st>>>(levels, boxes, sbr, sbc,
                                                     C, res, sampling, out);
  } else {
    roi_align_kernel<1, 0><<<grid, threads, 0, st>>>(levels, boxes, sbr, sbc,
                                                     C, res, sampling, out);
  }
  return (int)cudaGetLastError();
}
