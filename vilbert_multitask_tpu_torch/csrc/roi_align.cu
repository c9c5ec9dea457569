// Multi-level ROIAlign for the detector's box head: each proposal pooled
// from its FPN level (P2..P5) into a res x res grid of channel vectors.
//
// Replaces no Pallas kernel: the JAX package computes this with XLA, as
// gathers vmapped over boxes under a lax.switch on the box's level
// (vilbert_multitask_tpu/detect/model.py:roi_align, :185, with the level
// choice of :281-292). The reference ran maskrcnn_benchmark's CUDA
// ROIAlign. The semantics are the JAX function's, not maskrcnn's kernel's:
//   - the level (0..3 for P2..P5) comes from the Python wrapper
//     (detect/model.py:fpn_level, the same torch ops as the plain version);
//   - a box is scaled to level coordinates by dividing by the level's
//     stride; n = res * sampling points per axis sit at
//     y1 + (i + 0.5) * (y2 - y1) / n;
//   - each point is clipped to [0, H - 1], its low corner to [0, H - 2]
//     (so H, W >= 2), and read bilinearly from the four corners;
//   - each output bin is the mean of its sampling x sampling points.
// The coordinate and weight arithmetic uses __fadd_rn / __fsub_rn /
// __fmul_rn / __fdiv_rn in the plain version's order, so nothing is
// contracted into an FMA; only the order of the mean's sum differs.
//
// Layout: each level map is (H, W, C) f32 with C contiguous, which is what
// the FPN's channels-last NCHW tensors are when permuted to NHWC, so the
// maps are read where they lie. Out: (R, res, res, C) f32 (the JAX layout).
//
// What bounds it on the H100 (3.35 TB/s, 67 TFLOP/s f32): at the serving
// shape (300 boxes, res 7, sampling 2, C 256) it writes 3.76 M floats
// (15 MB) and reads at most 300 x 196 x 4 corners x 256 floats, bytes
// that depend on where the boxes fall; chip_smoke.py counts the bytes of
// the corners this run's boxes touch, each once. The design is one thread
// per output element (box, bin y, bin x, channel), channel fastest: a
// warp's 32 threads read 32 neighbouring channels of each corner, 128
// contiguous bytes, and write 128 contiguous bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 4;
constexpr int kThreads = 256;

struct Level {
  const float* feat;
  long long sh, sw;  // element strides of rows and columns (C is 1)
  int H, W;
  float stride;
};

struct Levels {
  Level l[kLevels];
};

__device__ __forceinline__ float sample_point(float lo, float extent, int i,
                                              int n) {
  return __fadd_rn(lo, __fdiv_rn(__fmul_rn(__fadd_rn((float)i, 0.5f),
                                           extent), (float)n));
}

__global__ void __launch_bounds__(kThreads) roi_align_kernel(
    Levels levels, const float* __restrict__ boxes,
    const int* __restrict__ level, int R, int C, int res, int sampling,
    float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long total = (long long)R * res * res * C;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  long long rest = idx / C;
  const int bx = (int)(rest % res);
  rest /= res;
  const int by = (int)(rest % res);
  const int r = (int)(rest / res);
  const int l = level[r];
  const Level L = l == 0 ? levels.l[0]
                  : l == 1 ? levels.l[1]
                  : l == 2 ? levels.l[2] : levels.l[3];
  const float* b = boxes + 4LL * r;
  const float x1 = __fdiv_rn(b[0], L.stride), y1 = __fdiv_rn(b[1], L.stride);
  const float x2 = __fdiv_rn(b[2], L.stride), y2 = __fdiv_rn(b[3], L.stride);
  const float dy = __fsub_rn(y2, y1), dx = __fsub_rn(x2, x1);
  const int n = res * sampling;
  const float* f = L.feat + c;
  float acc = 0.f;
  for (int sy = 0; sy < sampling; ++sy) {
    const float gy = sample_point(y1, dy, by * sampling + sy, n);
    const float yy = fminf(fmaxf(gy, 0.f), (float)(L.H - 1));
    const int y0 = min(max((int)floorf(yy), 0), L.H - 2);
    const float wy = __fsub_rn(yy, (float)y0);
    const float vy = __fsub_rn(1.f, wy);
    for (int sx = 0; sx < sampling; ++sx) {
      const float gx = sample_point(x1, dx, bx * sampling + sx, n);
      const float xx = fminf(fmaxf(gx, 0.f), (float)(L.W - 1));
      const int x0 = min(max((int)floorf(xx), 0), L.W - 2);
      const float wx = __fsub_rn(xx, (float)x0);
      const float vx = __fsub_rn(1.f, wx);
      const float* p = f + y0 * L.sh + x0 * L.sw;
      const float f00 = p[0], f01 = p[L.sw], f10 = p[L.sh],
                  f11 = p[L.sh + L.sw];
      float v = __fmul_rn(__fmul_rn(f00, vy), vx);
      v = __fadd_rn(v, __fmul_rn(__fmul_rn(f01, vy), wx));
      v = __fadd_rn(v, __fmul_rn(__fmul_rn(f10, wy), vx));
      v = __fadd_rn(v, __fmul_rn(__fmul_rn(f11, wy), wx));
      acc = __fadd_rn(acc, v);
    }
  }
  out[idx] = __fdiv_rn(acc, (float)(sampling * sampling));
}

}  // namespace

// feats[l]: level l's (H[l], W[l], C) f32 map, rows sh[l] and columns sw[l]
// elements apart, channels contiguous; strides[l]: its stride in pixels;
// boxes: (R, 4) f32 contiguous, xyxy in pixels; level: (R,) int32 in 0..3;
// out: (R, res, res, C) f32 contiguous. Returns the CUDA error of the launch.
extern "C" int vmt_roi_align(const float* const* feats, const int* H,
                             const int* W, const long long* sh,
                             const long long* sw, const float* strides,
                             const float* boxes, const int* level, int R,
                             int C, int res, int sampling, float* out,
                             void* stream) {
  if (R < 1 || C < 1 || res < 1 || sampling < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Levels levels;
  for (int l = 0; l < kLevels; ++l) {
    if (H[l] < 2 || W[l] < 2) return (int)cudaErrorInvalidValue;
    levels.l[l] = Level{feats[l], sh[l], sw[l], H[l], W[l], strides[l]};
  }
  const long long total = (long long)R * res * res * C;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  roi_align_kernel<<<(unsigned)blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      levels, boxes, level, R, C, res, sampling, out);
  return (int)cudaGetLastError();
}
