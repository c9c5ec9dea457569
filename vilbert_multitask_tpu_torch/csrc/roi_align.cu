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
// Layout: each level map is an (H, W, C) f32 view read where it lies, in
// one of two layouts, all four maps alike: channels contiguous (an NHWC
// map, or a channels-last NCHW tensor permuted to (H, W, C)), or columns
// contiguous with the channels H * W apart (a contiguous NCHW tensor
// permuted so: what the FPN leaves). Boxes are read through their strides.
// Out: (R, res, res, C) f32 (the JAX layout) in both.
//
// Design: one block per (bin row, box). Its threads first compute the
// box's level and scaled corners, and the geometry of its n sample columns
// and `sampling` sample rows (corner index, weight and one minus it) once,
// into shared memory. Then, for channels-last maps, they sweep the
// channels, each thread 4 neighbouring channels (a 16-byte load per
// corner, a 16-byte store per output), 64 threads covering C = 256, over
// the row's res bins; the scalar instance (one channel a thread) is the
// same code for maps whose base or row and column strides are not on 16
// bytes or whose C % 4 != 0. For NCHW maps a thread pools one (channel,
// bin), the bins of a channel on neighbouring lanes: a warp reads a few
// channels' stretches of the row's sample columns, so the corner reads of
// neighbouring samples share 32-byte sectors; the means are staged in
// shared memory (res x C, 7 KB at the serving shape) and written C-
// contiguous, 16 bytes a store when C % 4 == 0. Both compute each bin in the
// same order, so they are bit-equal on the same values. Indices are 32-bit.
// The wrapper (detect/model.py:roi_layout, roi_vector_width) picks the
// instance from the maps' strides and pointers.
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
constexpr int kStage = 2048;     // floats of bin means an NCHW block stages

struct Level {
  const float* feat;
  int sh, sw, sc;  // element strides of rows, columns and channels
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

// The sample geometry of one (bin row, box), shared by the block's threads.
struct Geometry {
  int x0[kMaxSamples], y0[kMaxSamples];
  float wx[kMaxSamples], vx[kMaxSamples];
  float wy[kMaxSamples], vy[kMaxSamples];
};

// Every thread: box r's level, returned; threads t < n + sampling also
// write sample column t or sample row by * sampling + (t - n) into g. The
// caller syncs before reading g.
__device__ __forceinline__ Level box_geometry(
    const Levels& levels, const float* __restrict__ boxes, long long sbr,
    long long sbc, int r, int by, int t, int n, int sampling, Geometry& g) {
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
    g.x0[t] = x0;
    g.wx[t] = wx;
    g.vx[t] = __fsub_rn(1.f, wx);
  } else if (t < n + sampling) {  // sample row by * sampling + (t - n)
    const int s = t - n;
    const float y1 = __fdiv_rn(by1, L.stride), y2 = __fdiv_rn(by2, L.stride);
    const float gy = sample_point(y1, __fsub_rn(y2, y1), by * sampling + s, n);
    const float yy = fminf(fmaxf(gy, 0.f), (float)(L.H - 1));
    const int y0 = min(max((int)floorf(yy), 0), L.H - 2);
    const float wy = __fsub_rn(yy, (float)y0);
    g.y0[s] = y0;
    g.wy[s] = wy;
    g.vy[s] = __fsub_rn(1.f, wy);
  }
  return L;
}

// Channels-last maps (sc == 1). V: channels a thread (4: float4, 1:
// scalar); S: the sampling ratio when it is known here (2, the detector's:
// every load of a bin in flight at once), else 0 and the runtime
// `sampling`.
template <int V, int S>
__global__ void __launch_bounds__(kMaxThreads) roi_align_kernel(
    Levels levels, const float* __restrict__ boxes, long long sbr,
    long long sbc, int C, int res, int sampling_arg,
    float* __restrict__ out) {
  typedef typename Vec<V>::T T;
  const int sampling = S > 0 ? S : sampling_arg;
  __shared__ Geometry g;
  const int by = blockIdx.x, r = blockIdx.y, t = threadIdx.x;
  const int n = res * sampling;
  const Level L = box_geometry(levels, boxes, sbr, sbc, r, by, t, n,
                               sampling, g);
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
        const float wy = g.wy[sy], vy = g.vy[sy];
        const float* fy = f + g.y0[sy] * L.sh;
#pragma unroll
        for (int sx = 0; sx < (S > 0 ? S : sampling); ++sx) {
          const int i = bx * sampling + sx;
          const T* p = reinterpret_cast<const T*>(fy + g.x0[i] * L.sw);
          const T* q = reinterpret_cast<const T*>(fy + g.x0[i] * L.sw + L.sh);
          const T f00 = p[0], f10 = q[0];
          const T f01 = *reinterpret_cast<const T*>(
              reinterpret_cast<const float*>(p) + L.sw);
          const T f11 = *reinterpret_cast<const T*>(
              reinterpret_cast<const float*>(q) + L.sw);
          accumulate(acc, f00, f01, f10, f11, wy, vy, g.wx[i], g.vx[i]);
        }
      }
      orow[bx * cv + c] = mean_of(acc, count);
    }
  }
}

// NCHW maps (sw == 1, channels sc apart). V: floats a store (4 when
// C % 4 == 0, else 1); S as above. A thread pools one (channel, bin) at a
// time, the bins of a channel on neighbouring lanes, in the order of the
// channels-last instance; the block stages up to `chunk` channels' means of
// its row, then stores them C-contiguous.
template <int V, int S>
__global__ void __launch_bounds__(kMaxThreads) roi_align_nchw_kernel(
    Levels levels, const float* __restrict__ boxes, long long sbr,
    long long sbc, int C, int res, int sampling_arg,
    float* __restrict__ out) {
  typedef typename Vec<V>::T T;
  const int sampling = S > 0 ? S : sampling_arg;
  __shared__ Geometry g;
  __shared__ __align__(16) float stage[kStage];
  const int by = blockIdx.x, r = blockIdx.y, t = threadIdx.x;
  const int n = res * sampling;
  const Level L = box_geometry(levels, boxes, sbr, sbc, r, by, t, n,
                               sampling, g);
  __syncthreads();
  const float count = (float)(sampling * sampling);
  // Channels staged at once, a multiple of 4; each bin's row of them is
  // padded by 4 floats, so the bins of one channel fall in other banks.
  const int chunk = min((C + 3) & ~3, (kStage / res - 4) & ~3);
  const int pitch = chunk + 4;
  float* orow = out + (r * res + by) * res * C;
  for (int c0 = 0; c0 < C; c0 += chunk) {
    const int cn = min(chunk, C - c0);
    for (int k = t; k < cn * res; k += blockDim.x) {
      const int cl = k / res, bx = k - cl * res;
      const float* f = L.feat + (c0 + cl) * L.sc;
      float acc = 0.f;
#pragma unroll
      for (int sy = 0; sy < (S > 0 ? S : sampling); ++sy) {
        const float wy = g.wy[sy], vy = g.vy[sy];
        const float* fy = f + g.y0[sy] * L.sh;
#pragma unroll
        for (int sx = 0; sx < (S > 0 ? S : sampling); ++sx) {
          const int i = bx * sampling + sx;
          const float* p = fy + g.x0[i];
          accumulate(acc, p[0], p[1], p[L.sh], p[L.sh + 1], wy, vy, g.wx[i],
                     g.vx[i]);
        }
      }
      stage[bx * pitch + cl] = mean_of(acc, count);
    }
    __syncthreads();
    const int cv = cn / V;
    for (int k = t; k < res * cv; k += blockDim.x) {
      const int bx = k / cv, j = k - bx * cv;
      reinterpret_cast<T*>(orow + bx * C + c0)[j] =
          reinterpret_cast<const T*>(stage + bx * pitch)[j];
    }
    __syncthreads();
  }
}

template <int V, int S>
void launch(bool channels_last, dim3 grid, int threads, cudaStream_t st,
            const Levels& levels, const float* boxes, long long sbr,
            long long sbc, int C, int res, int sampling, float* out) {
  if (channels_last) {
    roi_align_kernel<V, S><<<grid, threads, 0, st>>>(levels, boxes, sbr, sbc,
                                                     C, res, sampling, out);
  } else {
    roi_align_nchw_kernel<V, S><<<grid, threads, 0, st>>>(
        levels, boxes, sbr, sbc, C, res, sampling, out);
  }
}

}  // namespace

// feats[l]: level l's (H[l], W[l], C) f32 map, rows sh[l], columns sw[l]
// and channels sc[l] elements apart: every sc[l] 1 (channels-last) or
// every sw[l] 1 (NCHW); strides[l]: its stride in pixels; boxes: (R, 4)
// f32 xyxy in pixels, box r's coordinates at boxes + r*sbr + {0, 1, 2,
// 3}*sbc; vec: 4 or 1; for channels-last maps 4 is the float4 instance (C
// % 4 == 0, every map's base and sh, sw on 16 bytes), for NCHW maps 16-byte
// stores (C % 4 == 0, out on 16 bytes); out: (R, res, res, C) f32
// contiguous. Returns the CUDA error of the launch.
extern "C" int vmt_roi_align(const float* const* feats, const int* H,
                             const int* W, const long long* sh,
                             const long long* sw, const long long* sc,
                             const float* strides, const float* boxes,
                             long long sbr, long long sbc, int R, int C,
                             int res, int sampling, int vec, float* out,
                             void* stream) {
  const int n = res * sampling;
  if (R < 1 || R > 65535 || C < 1 || res < 1 || sampling < 1 ||
      n > kMaxSamples || (vec != 1 && vec != 4) || C % vec != 0 ||
      (long long)R * res * res * C > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  bool channels_last = true, nchw = true;
  for (int l = 0; l < kLevels; ++l) {
    channels_last = channels_last && sc[l] == 1;
    nchw = nchw && sw[l] == 1;
  }
  if (!channels_last && !nchw) return (int)cudaErrorInvalidValue;
  if (!channels_last && vec == 4 &&
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Levels levels;
  for (int l = 0; l < kLevels; ++l) {
    if (H[l] < 2 || W[l] < 2 || sh[l] < 0 || sw[l] < 0 || sc[l] < 0 ||
        (H[l] - 1) * sh[l] + (W[l] - 1) * sw[l] + (C - 1) * sc[l] + 1 >
            0x7fffffffLL ||
        (channels_last && vec == 4 &&
         (reinterpret_cast<uintptr_t>(feats[l]) % 16 != 0 ||
          sh[l] % 4 != 0 || sw[l] % 4 != 0))) {
      return (int)cudaErrorInvalidValue;
    }
    levels.l[l] = Level{feats[l], (int)sh[l], (int)sw[l], (int)sc[l], H[l],
                        W[l], strides[l]};
  }
  const int lanes = channels_last ? C / vec : C * res;
  int threads = ((lanes + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < n + sampling) threads = ((n + sampling + 31) / 32) * 32;
  const dim3 grid(res, R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4 && sampling == 2) {
    launch<4, 2>(channels_last, grid, threads, st, levels, boxes, sbr, sbc,
                 C, res, sampling, out);
  } else if (vec == 4) {
    launch<4, 0>(channels_last, grid, threads, st, levels, boxes, sbr, sbc,
                 C, res, sampling, out);
  } else if (sampling == 2) {
    launch<1, 2>(channels_last, grid, threads, st, levels, boxes, sbr, sbc,
                 C, res, sampling, out);
  } else {
    launch<1, 0>(channels_last, grid, threads, st, levels, boxes, sbr, sbc,
                 C, res, sampling, out);
  }
  return (int)cudaGetLastError();
}
