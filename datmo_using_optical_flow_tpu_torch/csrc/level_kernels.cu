// K8: the pyramid's level images and the flow's bilinear upsample for Hopper
// (sm_90a), with a plain C interface.
//
//   datmo_level_image  <- cv2's pre-blur then the bilinear resize of one level
//   datmo_blur         <- the pre-blur alone (level 0, scale 1)
//   datmo_resize       <- the bilinear resize of C planes, times a scale (the
//                         flow's upsample between levels, the initial flow)
//
// No Pallas kernel does this work: on the TPU, XLA fuses the JAX package's
// gaussian_blur and resize_bilinear (datmo_using_optical_flow_tpu/ops/
// farneback.py:68,76) into the jitted build_pyramid and flow step.  Its
// compiled CPU code, which the port is held to, rounds them so:
//
//   * each 1-D correlation of the blur (reflect-101 padding, as jnp.pad's
//     "reflect" repeats it past a short axis) is a chain in ascending tap
//     order, zero taps skipped: acc = fma(p0, w0, w1 * p1), then
//     acc = fma(p_i, w_i, acc); the vertical pass first; on an axis of one
//     value, taps of equal weight share one product (chain_one);
//   * each axis of the resize is fma(a, 1 - w, b * w), 1 - w a float32
//     subtraction; the rows first, then the columns; then the scale.
//
// Here each fma is __fmaf_rn and every other product or difference
// __fmul_rn / __fsub_rn, under the library's -fmad=false, so each kernel
// equals its plain version (ops/farneback.py: gaussian_blur_reference,
// resize_bilinear_reference, level_image_reference) bit for bit.  The (i0,
// i1, w) tables of each resized axis are the plain version's
// (farneback.resize_table); the kernels read them and do not recompute them.
//
// Bound: the bytes.  A level image reads its source once and writes lh x lw
// values; its arithmetic, with the blur evaluated only where the resize
// reads it, is a few instructions per source value (diagnostics/roofline.py:
// level_image).
//
// Design (the simple form): a level image is two launches.  The first runs
// the vertical correlation only at the 2 * lh source rows that the output
// rows' i0 and i1 name, one thread per value of a (2 * lh, W) buffer, a
// block's threads on neighbouring columns of one row.  The second runs one thread per
// output pixel: the horizontal correlation of both buffer rows at both of its
// columns i0 and i1 (four chains), then both lerps.  There is no full-size
// intermediate.  A source row or column that two outputs read is evaluated
// twice; each evaluation is the same chain, so the bits are the same.  The
// blur alone runs the same two passes at every row and column; the resize is
// one launch, one thread per output value.
//
// Each C entry point makes the given device current (device_guard.cuh),
// launches on the stream it is given and returns cudaGetLastError(); the
// Python wrapper (ops/level_kernels.py) raises when that is not cudaSuccess.

#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 127;  // the largest odd ksize taken (4K's last level: 91)

// The nonzero taps of a blur, ascending: offsets from the centre, weights,
// and whether another tap has the same weight.
struct BlurTaps {
  int count;
  int off[kMaxTaps];
  float w[kMaxTaps];
  unsigned char shared[kMaxTaps];
};

// Position i of an axis of `size` values under jnp.pad's reflect-101 padding.
__device__ __forceinline__ int reflect101(int i, int size) {
  if (i >= 0 && i < size) return i;
  if (size == 1) return 0;
  const int period = 2 * (size - 1);
  int m = i % period;
  if (m < 0) m += period;
  return m >= size ? period - m : m;
}

// The correlation on an axis of one value x: every tap reads x, and XLA's
// compiled code computes the product of taps of equal weight once, so such a
// product is rounded on its own and added; the others contract as usual.
__device__ __forceinline__ float chain_one(const BlurTaps& t, float x) {
  if (t.count == 1) return __fmul_rn(t.w[0], x);
  float acc;
  if (!t.shared[0]) {
    acc = __fmaf_rn(x, t.w[0], __fmul_rn(t.w[1], x));
  } else if (!t.shared[1]) {
    acc = __fmaf_rn(x, t.w[1], __fmul_rn(t.w[0], x));
  } else {
    acc = __fadd_rn(__fmul_rn(t.w[0], x), __fmul_rn(t.w[1], x));
  }
  for (int k = 2; k < t.count; ++k)
    acc = t.shared[k] ? __fadd_rn(acc, __fmul_rn(t.w[k], x)) : __fmaf_rn(x, t.w[k], acc);
  return acc;
}

// The correlation at position p of a line of `size` values (load(q) reads
// position q), rounded as the compiled chain is.
template <typename Load>
__device__ __forceinline__ float chain(const BlurTaps& t, int p, int size, Load load) {
  if (size == 1) return chain_one(t, load(0));
  if (t.count == 1) return __fmul_rn(t.w[0], load(reflect101(p + t.off[0], size)));
  float acc = __fmaf_rn(load(reflect101(p + t.off[0], size)), t.w[0],
                        __fmul_rn(t.w[1], load(reflect101(p + t.off[1], size))));
  for (int k = 2; k < t.count; ++k)
    acc = __fmaf_rn(load(reflect101(p + t.off[k], size)), t.w[k], acc);
  return acc;
}

// fma(a, 1 - w, b * w): one axis of the resize.
__device__ __forceinline__ float lerp(float a, float b, float w) {
  return __fmaf_rn(a, __fsub_rn(1.0f, w), __fmul_rn(b, w));
}

// buf[j][c] = the vertical correlation of img (h, w) at column c and source
// row j (rows0 null), or at rows0[j] for j < half and rows1[j - half] after.
// Grid: (column blocks, buffer rows).
__global__ void __launch_bounds__(kThreads)
blur_rows_kernel(const float* __restrict__ img, int h, int w,
                 const int64_t* __restrict__ rows0, const int64_t* __restrict__ rows1,
                 int half, BlurTaps t, float* __restrict__ buf) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int j = blockIdx.y;
  if (c >= w) return;
  int r = j;
  if (rows0 != nullptr) r = static_cast<int>(j < half ? rows0[j] : rows1[j - half]);
  buf[static_cast<int64_t>(j) * w + c] =
      chain(t, r, h, [&](int q) { return img[static_cast<int64_t>(q) * w + c]; });
}

// out (h, w) = the horizontal correlation of buf (h, w).  Grid: (column
// blocks, rows).
__global__ void __launch_bounds__(kThreads)
blur_cols_kernel(const float* __restrict__ buf, int w, BlurTaps t, float* __restrict__ out) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= w) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * w;
  const float* row = buf + base;
  out[base + c] = chain(t, c, w, [&](int q) { return row[q]; });
}

// out (lh, lw): for output (r, q), the horizontal correlation of buffer rows r
// (source row y0[r]) and lh + r (y1[r]) at columns x0[q] and x1[q], then the
// rows' lerp at each column and the columns' lerp.  Grid: (column blocks,
// output rows).
__global__ void __launch_bounds__(kThreads)
level_cols_kernel(const float* __restrict__ buf, int w, int lh, int lw,
                  const float* __restrict__ wy, const int64_t* __restrict__ x0,
                  const int64_t* __restrict__ x1, const float* __restrict__ wx, BlurTaps t,
                  float* __restrict__ out) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int r = blockIdx.y;
  if (q >= lw) return;
  const int64_t i = static_cast<int64_t>(r) * lw + q;
  const float* a = buf + static_cast<int64_t>(r) * w;
  const float* b = buf + static_cast<int64_t>(lh + r) * w;
  auto load_a = [&](int c) { return a[c]; };
  auto load_b = [&](int c) { return b[c]; };
  const int c0 = static_cast<int>(x0[q]), c1 = static_cast<int>(x1[q]);
  const float v0 = lerp(chain(t, c0, w, load_a), chain(t, c0, w, load_b), wy[r]);
  const float v1 = lerp(chain(t, c1, w, load_a), chain(t, c1, w, load_b), wy[r]);
  out[i] = lerp(v0, v1, wx[q]);
}

// out (planes, oh, ow) = the bilinear resize of img (planes, h, w), times
// scale unless it is 1.  Grid: (column blocks, output rows, planes).
__global__ void __launch_bounds__(kThreads)
resize_kernel(const float* __restrict__ img, int h, int w, int oh, int ow,
              const int64_t* __restrict__ y0, const int64_t* __restrict__ y1,
              const float* __restrict__ wy, const int64_t* __restrict__ x0,
              const int64_t* __restrict__ x1, const float* __restrict__ wx, float scale,
              float* __restrict__ out) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int r = blockIdx.y;
  const int64_t p = blockIdx.z;
  if (q >= ow) return;
  const int64_t i = (p * oh + r) * ow + q;
  const float* src = img + p * h * w;
  const float* a = src + y0[r] * w;
  const float* b = src + y1[r] * w;
  const int64_t c0 = x0[q], c1 = x1[q];
  const float v0 = lerp(a[c0], b[c0], wy[r]);
  const float v1 = lerp(a[c1], b[c1], wy[r]);
  const float v = lerp(v0, v1, wx[q]);
  out[i] = scale == 1.0f ? v : __fmul_rn(v, scale);
}

constexpr int kMaxGridY = 65535;  // rows (and planes) per launch: gridDim.y, gridDim.z

// (blocks of kThreads columns, rows, planes)
dim3 grid_for(int cols, int rows, int planes = 1) {
  return dim3((cols + kThreads - 1) / kThreads, rows, planes);
}

// The taps from HOST arrays of count offsets and weights; false if they are
// not count in [1, kMaxTaps] ascending offsets.
bool taps_from_host(BlurTaps* t, const int* off, const float* w, int count) {
  if (count < 1 || count > kMaxTaps) return false;
  t->count = count;
  for (int k = 0; k < count; ++k) {
    if (k > 0 && off[k] <= off[k - 1]) return false;
    t->off[k] = off[k];
    t->w[k] = w[k];
  }
  for (int k = 0; k < count; ++k) {
    t->shared[k] = 0;
    for (int j = 0; j < count; ++j)
      if (j != k && w[j] == w[k]) t->shared[k] = 1;
  }
  return true;
}

}  // namespace

extern "C" {

// img (h, w), out (lh, lw) and scratch (2 * lh, w) are DEVICE pointers to
// float32; y0, y1 (lh) and x0, x1 (lw) DEVICE int64 source positions, wy (lh)
// and wx (lw) DEVICE float32 weights of y1 and x1; off and w HOST arrays of
// the count nonzero taps (offsets from the centre, ascending, and weights).
int datmo_level_image(float* out, const float* img, float* scratch, int h, int w, int lh,
                      int lw, const int64_t* y0, const int64_t* y1, const float* wy,
                      const int64_t* x0, const int64_t* x1, const float* wx, const int* off,
                      const float* tw, int count, int device, void* stream) {
  BlurTaps t{};
  if (h < 1 || w < 1 || lh < 1 || lw < 1 || 2 * lh > kMaxGridY ||
      !taps_from_host(&t, off, tw, count))
    return cudaErrorInvalidValue;
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const auto s = static_cast<cudaStream_t>(stream);
  blur_rows_kernel<<<grid_for(w, 2 * lh), kThreads, 0, s>>>(img, h, w, y0, y1, lh, t,
                                                             scratch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  level_cols_kernel<<<grid_for(lw, lh), kThreads, 0, s>>>(scratch, w, lh, lw, wy, x0, x1, wx,
                                                          t, out);
  return cudaGetLastError();
}

// img, out and scratch are DEVICE pointers to (h, w) float32; off and w as
// datmo_level_image's.
int datmo_blur(float* out, const float* img, float* scratch, int h, int w, const int* off,
               const float* tw, int count, int device, void* stream) {
  BlurTaps t{};
  if (h < 1 || w < 1 || h > kMaxGridY || !taps_from_host(&t, off, tw, count))
    return cudaErrorInvalidValue;
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const auto s = static_cast<cudaStream_t>(stream);
  blur_rows_kernel<<<grid_for(w, h), kThreads, 0, s>>>(img, h, w, nullptr, nullptr, 0, t,
                                                        scratch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  blur_cols_kernel<<<grid_for(w, h), kThreads, 0, s>>>(scratch, w, t, out);
  return cudaGetLastError();
}

// img (planes, h, w) and out (planes, oh, ow) are DEVICE pointers to float32;
// the tables as datmo_level_image's, of oh rows and ow columns.
int datmo_resize(float* out, const float* img, int64_t planes, int h, int w, int oh, int ow,
                 const int64_t* y0, const int64_t* y1, const float* wy, const int64_t* x0,
                 const int64_t* x1, const float* wx, float scale, int device, void* stream) {
  if (planes < 1 || h < 1 || w < 1 || oh < 1 || ow < 1 || oh > kMaxGridY ||
      planes > kMaxGridY)
    return cudaErrorInvalidValue;
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  resize_kernel<<<grid_for(ow, oh, static_cast<int>(planes)), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(img, h, w, oh, ow, y0, y1, wy, x0, x1,
                                                        wx, scale, out);
  return cudaGetLastError();
}

}  // extern "C"
