// Farnebäck flow kernels for Hopper (sm_90a), with a plain C interface.
//
// Four kernels, each the counterpart of one Pallas TPU kernel of the JAX
// package and each held to a plain PyTorch version of the same function
// (ops/flow_kernels.py, *_reference):
//
//   poly_exp_kernel          <- ops/flow_pallas.py::poly_exp_pallas  (_poly_exp_kernel)
//   blur_solve_kernel        <- ops/flow_pallas.py::blur_solve       (_blur_solve_kernel)
//   fused_iteration_kernel   <- ops/flow_pallas.py::fused_iteration  (_fused_kernel,
//                               blur_solve_strip; warp_pallas._warp_into/_warp_epilogue)
//   warp_matrices_kernel     <- ops/warp_pallas.py::warp_matrices    (_kernel,
//                               _warp_into/_warp_epilogue)
//
// Layouts are the JAX package's: images (H, W) and coefficient / normal-equation
// planes (5, H, W), float32, row-major and contiguous.  K1-K3 give each block one
// 32x32 output tile (blockDim 32x8, four rows per thread; K1's compile-time
// instance 256 threads, or 128 for a 16x32 tile on a grid of one wave) and
// stage the tile plus
// its halo in shared memory, recomputing the halo rather than exchanging it:
// blocks run in any order, nothing carries between them.  Halo positions outside
// the image take the value at the clamped pixel (BORDER_REPLICATE), so a partial
// last tile needs no special case.  K4 has no window and so no halo: one thread
// per output pixel.  K3 and K4 share the per-pixel warp and M assembly
// (warp_assemble).
//
// Arithmetic order is the plain version's: taps accumulate in ascending order,
// the vertical pass before the horizontal one, and the 1/win^2 box scale comes
// after the horizontal pass.  The library is built with -fmad=false (see
// kernels/build.py) so no multiply-add is contracted.
//
// K1 has two kernels: a compile-time instance for poly_n 5 and 7, taken when
// the taps have their structural zero pattern (register-blocked passes, taps
// out of shared memory), and the runtime-n kernel for any other taps.
//
// K2 and K3 have two window stages.  The main path's window (winsize 15) runs
// a compile-time instance, box or Gaussian (window_solve_fixed: register-
// blocked passes, taps out of shared memory); every other winsize runs the
// runtime-radius window_solve.  The C entry points pick the instance.
//
// Each C entry point makes the given device current (device_guard.cuh),
// launches on the stream it is given and returns cudaGetLastError(); the Python
// wrapper raises when that is not cudaSuccess.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "device_guard.cuh"

namespace {

constexpr int kTile = 32;           // output tile edge
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kRowsPerThread = kTile / kBlockY;
constexpr int kPixelThreads = 256;  // K4: one thread per output pixel
constexpr int kMaxTaps = 64;        // window taps: winsize <= 63
constexpr int kMaxPolyN = 7;        // poly_n in {5, 7}
constexpr int kMaxPolyTaps = 2 * kMaxPolyN + 1;
constexpr int kBorder = 5;          // OpenCV's certainty attenuation band
__constant__ float kBorderAtten[kBorder] = {0.14f, 0.14f, 0.4472f, 0.4472f, 0.4472f};
constexpr int kMainR = 7;           // the main path's window radius (winsize 15)
// Blocks per SM the winsize-15 instances are built for (56 registers for K3).
// 5 (48 registers, 5 blocks of 43.2 KB) measured slower on the H100: K3 122.4
// against 87.1 us at 1080x1920, the M stage's gathers losing L1 (PERF.md).
constexpr int kWindowMinBlocks = 4;
// Blocks per SM K1's compile-time instances are built for: 32 registers for
// 32-row tiles (256 threads), which beat 40 and 44 at 1080x1920 on the H100;
// 16-row tiles (128 threads) take the 44 they need (PERF.md).
constexpr int kPolyMinBlocks = 8;

struct Window {
  float w[kMaxTaps];
};

struct PolyTaps {
  float g[kMaxPolyTaps];
  float xg[kMaxPolyTaps];
  float xxg[kMaxPolyTaps];
  float ig[4];  // ig11, ig03, ig33, ig55
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ float border_atten(int i, int size) {
  const int near = min(i, size - 1 - i);
  return near < kBorder ? kBorderAtten[near] : 1.0f;
}

// The per-pixel 2x2 solve of the five window sums a[0..4] at pixel (i, j),
// stored when the pixel lies in the image.
__device__ __forceinline__ void solve_store(const float* a, float scale, int i, int j, int h,
                                            int w, float* odx, float* ody) {
  if (i >= h || j >= w) return;
  const float g11 = a[0] * scale;
  const float g12 = a[1] * scale;
  const float g22 = a[2] * scale;
  const float h1 = a[3] * scale;
  const float h2 = a[4] * scale;
  const float idet = 1.0f / (g11 * g22 - g12 * g12 + 1e-3f);
  odx[static_cast<size_t>(i) * w + j] = (g11 * h2 - g12 * h1) * idet;
  ody[static_cast<size_t>(i) * w + j] = (g22 * h1 - g12 * h2) * idet;
}

// Window sum of the five staged M planes, then the per-pixel 2x2 solve, at a
// radius r known only at run time (every winsize but the main path's).
//
// ms: 5 planes of e x e (tile plus a halo of r on each side, e = kTile + 2r);
// vbuf: kTile x e scratch; taps: 2r+1 window weights in shared memory.  Writes
// the new flow of the block's tile to (odx, ody).  Shared by K2 and K3.
__device__ void window_solve(const float* ms, float* vbuf, const float* taps, int r,
                             float scale, int y0, int x0, int h, int w, float* odx,
                             float* ody) {
  const int e = kTile + 2 * r;
  const int ntaps = 2 * r + 1;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  float acc[kRowsPerThread][5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float* m = ms + static_cast<size_t>(c) * e * e;
    __syncthreads();  // M staged; the previous channel's reads of vbuf are done
    for (int idx = tid; idx < kTile * e; idx += nthreads) {
      const int i = idx / e;
      const int j = idx - i * e;
      float s = taps[0] * m[i * e + j];
      for (int k = 1; k < ntaps; ++k) s = s + taps[k] * m[(i + k) * e + j];
      vbuf[idx] = s;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const float* v = vbuf + (threadIdx.y + q * kBlockY) * e + threadIdx.x;
      float s = taps[0] * v[0];
      for (int k = 1; k < ntaps; ++k) s = s + taps[k] * v[k];
      acc[q][c] = s;
    }
  }
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q)
    solve_store(acc[q], scale, y0 + threadIdx.y + q * kBlockY, x0 + threadIdx.x, h, w, odx,
                ody);
}

// Layout of the five staged planes of a block: edge e = kTile + 2r, rows
// `stride` floats apart, planes e * stride apart.  kR > 0 is a compile-time
// radius, whose rows get an odd stride (window_solve_fixed); kR == 0 takes
// the radius r at run time, rows packed (window_solve).
template <int kR>
struct Staged {
  int e, stride;
  __device__ __host__ explicit Staged(int r)
      : e(kTile + 2 * (kR > 0 ? kR : r)), stride(kR > 0 ? (e | 1) : e) {}
  __device__ __host__ int plane() const { return e * stride; }
  // the staged position of flat index idx = li * e + lj
  __device__ int at(int idx, int li, int lj) const { return kR > 0 ? li * stride + lj : idx; }
};

// The window sum and solve at the compile-time radius R: the main path's
// winsize-15 instance (R = 7), box (kBox: every tap 1.0f) or with the
// window's taps.
//
// ms: the 5 staged planes of M in Staged<R>'s layout (row stride e | 1); the
// vertical pass overwrites their first kTile rows.  No shared scratch and no
// taps in shared memory: box sums are plain chains of adds (1.0f * m == m, so
// they equal the plain version's 1.0 * m terms bit for bit), Gaussian taps are
// kernel parameters read at unrolled, constant indices.
//
// Vertical pass: thread (c, j), 5 e of the block's threads, owns column j of
// plane c.  It reads the column's e values once, top to bottom, each into the
// (up to 2R + 1) running sums whose window covers it, and stores output row i
// over input row i as soon as row i + 2R is read; no other thread reads that
// column, so the pass works in place.  e loads for kTile sums instead of
// kTile (2R + 1).  Horizontal pass: each thread sums a run of kRun
// consecutive outputs of one row of the five planes (kRun + 2R loads for kRun
// sums); a warp takes 4 rows x 8 runs, and the odd row stride puts its 32
// lanes on 32 distinct banks.  Each output still adds its terms in ascending
// tap order, as the plain version, and the scale follows the horizontal pass.
template <int R, bool kBox>
__device__ void window_solve_fixed(float* ms, const Window& win, float scale, int y0, int x0,
                                   int h, int w, float* odx, float* ody) {
  constexpr int kTaps = 2 * R + 1;
  constexpr int kE = kTile + 2 * R;
  constexpr int kStride = kE | 1;
  constexpr int kPlane = kE * kStride;
  constexpr int kRun = 4;
  constexpr int kRowsPerWarp = 32 * kRun / kTile;
  static_assert(kBlockX * kBlockY / 32 * kRowsPerWarp == kTile, "one output row per run slot");
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  float taps[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) taps[k] = kBox ? 1.0f : win.w[k];

  __syncthreads();  // M staged
  if (tid < 5 * kE) {
    const int c = tid / kE;
    float* col = ms + c * kPlane + (tid - c * kE);
    float acc[kTile];
#pragma unroll
    for (int y = 0; y < kE; ++y) {
      const float v = col[y * kStride];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const int i = y - k;  // output row i takes tap k from row y
        if (i >= 0 && i < kTile) {
          const float term = kBox ? v : taps[k] * v;
          acc[i] = k == 0 ? term : acc[i] + term;
        }
      }
      if (y >= 2 * R) col[(y - 2 * R) * kStride] = acc[y - 2 * R];
    }
  }
  __syncthreads();

  const int lane = tid & 31;
  const int row = (tid >> 5) * kRowsPerWarp + lane / (kTile / kRun);
  const int c0 = (lane % (kTile / kRun)) * kRun;
  float out[kRun][5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float* v = ms + c * kPlane + row * kStride + c0;
    float acc[kRun];
#pragma unroll
    for (int x = 0; x < kRun + 2 * R; ++x) {
      const float val = v[x];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const int q = x - k;  // output q takes tap k from column x
        if (q >= 0 && q < kRun) {
          const float term = kBox ? val : taps[k] * val;
          acc[q] = k == 0 ? term : acc[q] + term;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRun; ++q) out[q][c] = acc[q];
  }
#pragma unroll
  for (int q = 0; q < kRun; ++q)
    solve_store(out[q], scale, y0 + row, x0 + c0 + q, h, w, odx, ody);
}

__device__ void load_taps(float* dst, const Window& win, int ntaps) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = tid; k < ntaps; k += blockDim.x * blockDim.y) dst[k] = win.w[k];
}

// The warp and M assembly of one pixel (gi, gj), shared by K3 and K4: bilinear
// warp of R1's five planes to the absolute position (gj + dx, gi + dy), the
// inside mask, the BORDER=5 attenuation and the five normal-equation values,
// stored at m[0], m[stride], ..., m[4 * stride].  Warp weights: floor and
// fraction of the absolute position j + dx, not of dx.  The operations and
// their order are the plain version's (ops/farneback.py::update_matrices).
__device__ __forceinline__ void warp_assemble(const float* __restrict__ R0,
                                              const float* __restrict__ R1,
                                              const float* __restrict__ dx,
                                              const float* __restrict__ dy, int gi, int gj,
                                              int h, int w, float* m, size_t stride) {
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t p = static_cast<size_t>(gi) * w + gj;
  const float fdx = dx[p];
  const float fdy = dy[p];
  const float gx = static_cast<float>(gj) + fdx;
  const float gy = static_cast<float>(gi) + fdy;
  const float x1 = floorf(gx);
  const float y1 = floorf(gy);
  const float fx = gx - x1;
  const float fy = gy - y1;
  const bool inside = x1 >= 0.0f && x1 < static_cast<float>(w - 1) && y1 >= 0.0f &&
                      y1 < static_cast<float>(h - 1);
  float wr[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (inside) {
    const float a00 = (1.0f - fx) * (1.0f - fy);
    const float a01 = fx * (1.0f - fy);
    const float a10 = (1.0f - fx) * fy;
    const float a11 = fx * fy;
    const size_t b = static_cast<size_t>(y1) * w + static_cast<size_t>(x1);
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float* q = R1 + c * plane + b;
      wr[c] = a00 * q[0] + a01 * q[1] + a10 * q[w] + a11 * q[w + 1];
    }
  }
  const float* r0 = R0 + p;
  float r2 = inside ? wr[0] : 0.0f;
  float r3 = inside ? wr[1] : 0.0f;
  float r4 = inside ? (r0[2 * plane] + wr[2]) * 0.5f : r0[2 * plane];
  float r5 = inside ? (r0[3 * plane] + wr[3]) * 0.5f : r0[3 * plane];
  float r6 = inside ? (r0[4 * plane] + wr[4]) * 0.25f : r0[4 * plane] * 0.5f;
  r2 = (r0[0] - r2) * 0.5f;
  r3 = (r0[plane] - r3) * 0.5f;
  r2 = r2 + r4 * fdy + r6 * fdx;
  r3 = r3 + r6 * fdy + r5 * fdx;
  const float s = border_atten(gi, h) * border_atten(gj, w);
  r2 = r2 * s;
  r3 = r3 * s;
  r4 = r4 * s;
  r5 = r5 * s;
  r6 = r6 * s;
  m[0] = r4 * r4 + r6 * r6;
  m[stride] = (r4 + r5) * r6;
  m[2 * stride] = r5 * r5 + r6 * r6;
  m[3 * stride] = r4 * r2 + r6 * r3;
  m[4 * stride] = r6 * r2 + r5 * r3;
}

// ---------------------------------------------------------------- K1
// Polynomial expansion: image (H, W) -> planes (5, H, W) =
// [y-linear, x-linear, y^2, x^2, xy], the inverse-Gram-scaled separable
// correlations of FarnebackPolyExp (2n+1 taps of g, xg, xxg).
//
// Replaces ops/flow_pallas.py::poly_exp_pallas.  Bound on the H100: it moves
// 24 bytes per pixel (one image read, five plane writes) for ~190 separately
// rounded flops, about the card's float32 flop:byte balance, so neither side
// dominates at 1080p.  Tiling: the block reads its tile plus an n-pixel halo
// once into shared memory (edge-clamped, which is the plain version's edge
// padding of the image and of the row planes), keeps the three vertical
// correlations there, and writes only the five planes.  Skip rules as the plain
// version: xg's zero centre tap is skipped in the vertical pass, xxg's is kept;
// horizontal taps that are zero in float32 are skipped.
//
// Two kernels.  poly_exp_fixed_kernel<N, kTileH> is the compile-time instance
// for poly_n N (5 or 7) when the taps have the structural zero pattern (every g
// tap nonzero, xg and xxg zero exactly at the centre), which every poly_sigma
// but a tiny one gives; poly_exp_kernel takes n and any zero pattern at run
// time.  datmo_poly_exp picks one, and the instance's tile height: 16 rows
// when that grid fits in one wave (kPolyMinBlocks blocks per SM), where one
// block's latency sets the time (324x576 and 97x173 at 1080p), else 32 rows,
// 8 blocks of 256 threads per SM for throughput (1080x1920).

// Shared-memory layout and thread maps of poly_exp_fixed_kernel<N, kTileH>:
// a kTileH x kTile output tile, its image staged as kRows x kE.
template <int N, int kTileH>
struct PolyFixed {
  static constexpr int kE = kTile + 2 * N;      // staged columns
  static constexpr int kRows = kTileH + 2 * N;  // staged image rows
  static constexpr int kRun = 8;                // vertical pass: output rows per thread
  static constexpr int kRuns = kTileH / kRun;   // runs per staged column
  static constexpr int kHRun = 4;               // horizontal pass: outputs per thread
  static constexpr int kRunsPerRow = kTile / kHRun;
  static constexpr int kThreads = kTileH * kRunsPerRow;
  // A vertical warp is (32 / kRuns) columns x kRuns runs, kRun rows apart: its
  // 32 lanes fall on 32 banks when kRun * stride is an odd multiple of
  // 32 / kRuns modulo 32, i.e. an odd stride for 4 runs, 2 mod 4 for 2.  A
  // horizontal warp is 4 rows x 8 runs of the row planes: 32 banks with an odd
  // row stride.  (The vertical stores of 16-row tiles take 2-way conflicts.)
  static constexpr int kImgStride = kRuns == 4 ? (kE | 1) : kE + (6 - kE % 4) % 4;
  static constexpr int kRowStride = kE | 1;
  static_assert(kRuns == 2 || kRuns == 4, "16- or 32-row tiles");
  static_assert(kRuns * kE <= kThreads, "one thread per (column, run)");
};

// The compile-time instance: the vertical pass has each of kRuns * kE threads
// read one staged column's kRun + 2N values once, top to bottom, each into the
// open g, xg and xxg sums of the kRun outputs whose window covers it ((kRun +
// 2N) loads for 3 kRun sums instead of 4 loads per tap and sum); the horizontal
// pass has each thread read kHRun + 2N values of each row plane once into the
// 6 x kHRun sums of its run of outputs.  Taps are kernel parameters read at
// unrolled, constant indices (constant-bank operands), and the skip rules are
// fixed: vertically xg skips its centre and g, xxg keep every tap;
// horizontally the centres of xg and xxg, zero in float32, are skipped.  Every
// sum still adds its terms in ascending tap order, as the plain version.
// The image is staged by cp.async, global to shared memory with no register
// in between, under one wait: faster than loads through registers at every
// level on the H100 (PERF.md).  `vec`: the five planes are stored as float4
// (w % 4 == 0, out 16-byte aligned).
template <int N, int kTileH>
__global__ void __launch_bounds__(PolyFixed<N, kTileH>::kThreads, kPolyMinBlocks)
poly_exp_fixed_kernel(const float* __restrict__ img, float* __restrict__ out, int h, int w,
                      bool vec, PolyTaps pt) {
  using L = PolyFixed<N, kTileH>;
  constexpr int kTaps = 2 * N + 1;
  constexpr int kStaged = L::kRows * L::kE;
  __shared__ float s_img[L::kRows * L::kImgStride];
  __shared__ float s_rows[3][kTileH * L::kRowStride];
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTile;
#pragma unroll
  for (int it = 0; it < (kStaged + L::kThreads - 1) / L::kThreads; ++it) {
    const int idx = tid + it * L::kThreads;
    if (idx < kStaged) {
      const int li = idx / L::kE;
      const int lj = idx - li * L::kE;
      const int gi = clampi(y0 - N + li, 0, h - 1);
      const int gj = clampi(x0 - N + lj, 0, w - 1);
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(
          s_img + li * L::kImgStride + lj));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                   "l"(img + static_cast<size_t>(gi) * w + gj));
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  if (tid < L::kRuns * L::kE) {
    const int col = tid / L::kRuns;
    const int run = tid - col * L::kRuns;
    const float* src = s_img + run * L::kRun * L::kImgStride + col;
    float ag[L::kRun], axg[L::kRun], axxg[L::kRun];
#pragma unroll
    for (int y = 0; y < L::kRun + 2 * N; ++y) {
      const float v = src[y * L::kImgStride];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const int i = y - k;  // output row i takes tap k from row y
        if (i >= 0 && i < L::kRun) {
          const float tg = pt.g[k] * v;
          ag[i] = k == 0 ? tg : ag[i] + tg;
          if (k != N) {
            const float txg = pt.xg[k] * v;
            axg[i] = k == 0 ? txg : axg[i] + txg;
          }
          const float txxg = pt.xxg[k] * v;
          axxg[i] = k == 0 ? txxg : axxg[i] + txxg;
        }
      }
    }
    const int base = run * L::kRun * L::kRowStride + col;
#pragma unroll
    for (int i = 0; i < L::kRun; ++i) {
      s_rows[0][base + i * L::kRowStride] = ag[i];
      s_rows[1][base + i * L::kRowStride] = axg[i];
      s_rows[2][base + i * L::kRowStride] = axxg[i];
    }
  }
  __syncthreads();

  // b1 = g*row_g, b2 = xg*row_g, b3 = g*row_xg, b4 = xxg*row_g,
  // b5 = g*row_xxg, b6 = xg*row_xg
  constexpr int kH = L::kHRun;
  const int lane = tid & 31;
  const int row = (tid >> 5) * (32 / L::kRunsPerRow) + lane / L::kRunsPerRow;
  const int c0 = (lane % L::kRunsPerRow) * kH;
  float b1[kH], b2[kH], b3[kH], b4[kH], b5[kH], b6[kH];
  const float* rg = s_rows[0] + row * L::kRowStride + c0;
#pragma unroll
  for (int x = 0; x < kH + 2 * N; ++x) {
    const float v = rg[x];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const int q = x - k;  // output q takes tap k from column x
      if (q >= 0 && q < kH) {
        b1[q] = k == 0 ? pt.g[k] * v : b1[q] + pt.g[k] * v;
        if (k != N) {
          b2[q] = k == 0 ? pt.xg[k] * v : b2[q] + pt.xg[k] * v;
          b4[q] = k == 0 ? pt.xxg[k] * v : b4[q] + pt.xxg[k] * v;
        }
      }
    }
  }
  const float* rxg = s_rows[1] + row * L::kRowStride + c0;
#pragma unroll
  for (int x = 0; x < kH + 2 * N; ++x) {
    const float v = rxg[x];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const int q = x - k;
      if (q >= 0 && q < kH) {
        b3[q] = k == 0 ? pt.g[k] * v : b3[q] + pt.g[k] * v;
        if (k != N) b6[q] = k == 0 ? pt.xg[k] * v : b6[q] + pt.xg[k] * v;
      }
    }
  }
  const float* rxxg = s_rows[2] + row * L::kRowStride + c0;
#pragma unroll
  for (int x = 0; x < kH + 2 * N; ++x) {
    const float v = rxxg[x];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const int q = x - k;
      if (q >= 0 && q < kH) b5[q] = k == 0 ? pt.g[k] * v : b5[q] + pt.g[k] * v;
    }
  }

  const int i = y0 + row;
  const int j = x0 + c0;
  if (i >= h || j >= w) return;
  float o[5][kH];
#pragma unroll
  for (int q = 0; q < kH; ++q) {
    o[0][q] = b3[q] * pt.ig[0];
    o[1][q] = b2[q] * pt.ig[0];
    o[2][q] = b1[q] * pt.ig[1] + b5[q] * pt.ig[2];
    o[3][q] = b1[q] * pt.ig[1] + b4[q] * pt.ig[2];
    o[4][q] = b6[q] * pt.ig[3];
  }
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t p = static_cast<size_t>(i) * w + j;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    float* dst = out + c * plane + p;
    if (vec) {  // j + 3 < w: w and j are multiples of 4
      *reinterpret_cast<float4*>(dst) = make_float4(o[c][0], o[c][1], o[c][2], o[c][3]);
    } else {
#pragma unroll
      for (int q = 0; q < kH; ++q)
        if (j + q < w) dst[q] = o[c][q];
    }
  }
}

// The runtime-n kernel: any poly_n up to kMaxPolyN and any zero pattern of
// the taps, which it tests one by one.
__global__ void __launch_bounds__(kBlockX * kBlockY)
poly_exp_kernel(const float* __restrict__ img, float* __restrict__ out, int h, int w,
                int n, PolyTaps pt) {
  constexpr int kMaxE = kTile + 2 * kMaxPolyN;
  __shared__ float s_img[kMaxE * kMaxE];
  __shared__ float s_rows[3][kTile * kMaxE];
  __shared__ PolyTaps s_pt;
  const int e = kTile + 2 * n;
  const int ntaps = 2 * n + 1;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  if (tid == 0) s_pt = pt;
  for (int idx = tid; idx < e * e; idx += nthreads) {
    const int li = idx / e;
    const int lj = idx - li * e;
    const int gi = clampi(y0 - n + li, 0, h - 1);
    const int gj = clampi(x0 - n + lj, 0, w - 1);
    s_img[idx] = img[static_cast<size_t>(gi) * w + gj];
  }
  __syncthreads();
  const float* g = s_pt.g;
  const float* xg = s_pt.xg;
  const float* xxg = s_pt.xxg;
  for (int idx = tid; idx < kTile * e; idx += nthreads) {
    const int i = idx / e;
    const int j = idx - i * e;
    float rg = 0.0f, rxg = 0.0f, rxxg = 0.0f;
    bool have_xg = false;
    for (int k = 0; k < ntaps; ++k) {
      const float v = s_img[(i + k) * e + j];
      rg = k == 0 ? g[k] * v : rg + g[k] * v;
      if (xg[k] != 0.0f) {
        rxg = have_xg ? rxg + xg[k] * v : xg[k] * v;
        have_xg = true;
      }
      rxxg = k == 0 ? xxg[k] * v : rxxg + xxg[k] * v;
    }
    s_rows[0][idx] = rg;
    s_rows[1][idx] = rxg;
    s_rows[2][idx] = rxxg;
  }
  __syncthreads();
  const size_t plane = static_cast<size_t>(h) * w;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int li = threadIdx.y + q * kBlockY;
    const int i = y0 + li;
    const int j = x0 + threadIdx.x;
    if (i >= h || j >= w) continue;
    const float* rg = s_rows[0] + li * e + threadIdx.x;
    const float* rxg = s_rows[1] + li * e + threadIdx.x;
    const float* rxxg = s_rows[2] + li * e + threadIdx.x;
    // b1 = g*row_g, b2 = xg*row_g, b3 = g*row_xg, b4 = xxg*row_g,
    // b5 = g*row_xxg, b6 = xg*row_xg; each sum starts at its first kept tap
    float b1 = 0.0f, b2 = 0.0f, b3 = 0.0f, b4 = 0.0f, b5 = 0.0f, b6 = 0.0f;
    bool f_g = false, f_xg = false, f_xxg = false;
    for (int k = 0; k < ntaps; ++k) {
      if (g[k] != 0.0f) {
        b1 = f_g ? b1 + g[k] * rg[k] : g[k] * rg[k];
        b3 = f_g ? b3 + g[k] * rxg[k] : g[k] * rxg[k];
        b5 = f_g ? b5 + g[k] * rxxg[k] : g[k] * rxxg[k];
        f_g = true;
      }
      if (xg[k] != 0.0f) {
        b2 = f_xg ? b2 + xg[k] * rg[k] : xg[k] * rg[k];
        b6 = f_xg ? b6 + xg[k] * rxg[k] : xg[k] * rxg[k];
        f_xg = true;
      }
      if (xxg[k] != 0.0f) {
        b4 = f_xxg ? b4 + xxg[k] * rg[k] : xxg[k] * rg[k];
        f_xxg = true;
      }
    }
    const float ig11 = s_pt.ig[0], ig03 = s_pt.ig[1], ig33 = s_pt.ig[2], ig55 = s_pt.ig[3];
    const size_t p = static_cast<size_t>(i) * w + j;
    out[p] = b3 * ig11;
    out[plane + p] = b2 * ig11;
    out[2 * plane + p] = b1 * ig03 + b5 * ig33;
    out[3 * plane + p] = b1 * ig03 + b4 * ig33;
    out[4 * plane + p] = b6 * ig55;
  }
}

// ---------------------------------------------------------------- K2
// Window aggregation of M (5, H, W) (box, or Gaussian with
// sigma = (win//2)*0.3) with BORDER_REPLICATE, then the 2x2 solve -> (dx, dy).
//
// Replaces ops/flow_pallas.py::blur_solve.  Bound on the H100: at the main
// path's 97x173 level it is 24 blocks on 132 SMs, so it is bound by launch
// latency and by one block's serial work, not by bytes (0.34 MB of M) or flops.
// Tiling: the 32x32 tile plus its (win//2) halo of all five planes is staged in
// shared memory (edge-clamped), the blurred planes live only in registers, and
// only the two flow components are written.
//
// kR > 0 is the compile-time instance of that radius (window_solve_fixed,
// box when kBox); kR == 0 takes the radius r at run time (window_solve).
template <int kR, bool kBox>
__global__ void __launch_bounds__(kBlockX * kBlockY, kR > 0 ? kWindowMinBlocks : 1)
blur_solve_kernel(const float* __restrict__ M, float* __restrict__ odx,
                  float* __restrict__ ody, int h, int w, int r, Window win, float scale) {
  extern __shared__ float smem[];
  if (kR > 0) r = kR;
  const Staged<kR> st(r);
  float* ms = smem;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const size_t plane = static_cast<size_t>(h) * w;
  float* vbuf = ms + 5 * st.plane();
  float* taps = vbuf + kTile * st.e;
  if (kR == 0) load_taps(taps, win, 2 * r + 1);
  for (int idx = tid; idx < st.e * st.e; idx += nthreads) {
    const int li = idx / st.e;
    const int lj = idx - li * st.e;
    const int gi = clampi(y0 - r + li, 0, h - 1);
    const int gj = clampi(x0 - r + lj, 0, w - 1);
    const size_t p = static_cast<size_t>(gi) * w + gj;
    for (int c = 0; c < 5; ++c) ms[c * st.plane() + st.at(idx, li, lj)] = M[c * plane + p];
  }
  if constexpr (kR > 0)
    window_solve_fixed<kR, kBox>(ms, win, scale, y0, x0, h, w, odx, ody);
  else
    window_solve(ms, vbuf, taps, r, scale, y0, x0, h, w, odx, ody);
}

// ---------------------------------------------------------------- K3
// One refinement iteration: bilinear warp of R1's five planes to the absolute
// position (j + dx, i + dy), the inside mask, the BORDER=5 attenuation, the
// assembly of M, the window sum and the 2x2 solve -> new (dx, dy).  M never
// reaches global memory.
//
// Replaces ops/flow_pallas.py::fused_iteration.  The TPU kernel walks row
// strips in order with a ring DMA and decomposes the warp into integer-shift
// rolls because TPU gathers are slow; it can only reach a fixed window of
// displacements.  Here each pixel gathers its four corners directly, so any
// displacement is warped exactly and no window guard is needed.
// Bound on the H100: ~56 bytes of unique traffic per pixel (R0 and R1's five
// planes, the flow in and out; the gathers of a smooth flow hit L1/L2) against
// ~470 separately rounded flops per pixel once the halo recompute (x2.07 at
// winsize 15) is counted, so it leans compute-bound.  With the winsize-15
// window stage (window_solve_fixed) the window's adds run near the SM's
// instruction throughput, and the M stage's gathers, at 2.07 staged positions
// per pixel, take most of the time.
// Tiling: the block computes M for its 32x32 tile plus a (win//2) halo into
// shared memory (43 KB at winsize 15; dynamic shared memory above 48 KB),
// M at a halo position outside the image is M at the clamped pixel, then the
// window sum and solve run from shared memory as in K2, with the same
// choice of window stage (kR, kBox).
template <int kR, bool kBox>
__global__ void __launch_bounds__(kBlockX * kBlockY, kR > 0 ? kWindowMinBlocks : 1)
fused_iteration_kernel(const float* __restrict__ R0, const float* __restrict__ R1,
                       const float* __restrict__ dx, const float* __restrict__ dy,
                       float* __restrict__ odx, float* __restrict__ ody, int h, int w,
                       int r, Window win, float scale) {
  extern __shared__ float smem[];
  if (kR > 0) r = kR;
  const Staged<kR> st(r);
  float* ms = smem;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  float* vbuf = ms + 5 * st.plane();
  float* taps = vbuf + kTile * st.e;
  if (kR == 0) load_taps(taps, win, 2 * r + 1);
  for (int idx = tid; idx < st.e * st.e; idx += nthreads) {
    const int li = idx / st.e;
    const int lj = idx - li * st.e;
    const int gi = clampi(y0 - r + li, 0, h - 1);
    const int gj = clampi(x0 - r + lj, 0, w - 1);
    warp_assemble(R0, R1, dx, dy, gi, gj, h, w, ms + st.at(idx, li, lj), st.plane());
  }
  if constexpr (kR > 0)
    window_solve_fixed<kR, kBox>(ms, win, scale, y0, x0, h, w, odx, ody);
  else
    window_solve(ms, vbuf, taps, r, scale, y0, x0, h, w, odx, ody);
}

// ---------------------------------------------------------------- K4
// The warp and M assembly of K3, with M (5, H, W) stored to global memory.
//
// Replaces ops/warp_pallas.py::warp_matrices.  As in K3 the TPU kernel's
// integer-shift decomposition, its ring-DMA window of padded R1 and that
// window's displacement limits are not carried over: each pixel gathers its
// four corners of the unpadded R1 directly, at any displacement.
// Bound on the H100: 68 bytes of unique traffic per pixel (R0 and R1's five
// planes and the flow in, M's five planes out) against ~89 separately rounded
// flops, so it is bound by memory.  One thread per output pixel, consecutive
// threads on consecutive pixels: the R0, flow and M accesses coalesce, and the
// corner gathers of a smooth flow hit L1/L2.
__global__ void __launch_bounds__(kPixelThreads)
warp_matrices_kernel(const float* __restrict__ R0, const float* __restrict__ R1,
                     const float* __restrict__ dx, const float* __restrict__ dy,
                     float* __restrict__ M, int h, int w) {
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t p = static_cast<size_t>(blockIdx.x) * kPixelThreads + threadIdx.x;
  if (p >= plane) return;
  const int gi = static_cast<int>(p / w);
  const int gj = static_cast<int>(p - static_cast<size_t>(gi) * w);
  warp_assemble(R0, R1, dx, dy, gi, gj, h, w, M + p, plane);
}

// K2 and K3's dynamic shared memory: the staged planes, plus the vertical
// pass's scratch and the taps at the runtime radius.
template <int kR>
size_t window_smem_bytes(int r) {
  const Staged<kR> st(r);
  const size_t scratch = kR > 0 ? 0 : static_cast<size_t>(kTile) * st.e + kMaxTaps;
  return sizeof(float) * (5 * st.plane() + scratch);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool window_from_host(Window* win, const float* taps, int winsize) {
  if (winsize < 1 || winsize > kMaxTaps - 1 || winsize % 2 == 0) return false;
  for (int k = 0; k < winsize; ++k) win->w[k] = taps[k];
  return true;
}

// Calls launch(radius, box) with the window stage's instance for `win`: the
// compile-time kMainR one for winsize 15 (box when every tap is 1.0f), else the
// runtime-radius one (radius 0).  Both are std::integral_constant values.
template <typename Launch>
cudaError_t with_window_instance(const Window& win, int winsize, Launch launch) {
  using Main = std::integral_constant<int, kMainR>;
  if (winsize != 2 * kMainR + 1) return launch(std::integral_constant<int, 0>{}, std::false_type{});
  for (int k = 0; k < winsize; ++k)
    if (win.w[k] != 1.0f) return launch(Main{}, std::false_type{});
  return launch(Main{}, std::true_type{});
}

dim3 tile_grid(int h, int w, int tile_h = kTile) {
  return dim3((w + kTile - 1) / kTile, (h + tile_h - 1) / tile_h);
}

// The structural zero pattern of K1's taps, which the compile-time instances
// take: every g tap nonzero, xg and xxg zero exactly at the centre.
bool poly_taps_structural(const PolyTaps& pt, int n) {
  for (int k = 0; k < 2 * n + 1; ++k) {
    const bool centre = k == n;
    if (pt.g[k] == 0.0f || (pt.xg[k] == 0.0f) != centre || (pt.xxg[k] == 0.0f) != centre)
      return false;
  }
  return true;
}

// K1's compile-time instance for poly_n N: 16-row tiles when their grid fits
// in one wave of kPolyMinBlocks blocks per SM, else 32-row tiles.
template <int N>
cudaError_t launch_poly_fixed(float* out, const float* img, int h, int w, const PolyTaps& pt,
                              int device, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  constexpr int kShort = kTile / 2;
  const dim3 short_grid = tile_grid(h, w, kShort);
  if (static_cast<int>(short_grid.x * short_grid.y) <= kPolyMinBlocks * sms) {
    poly_exp_fixed_kernel<N, kShort><<<short_grid, PolyFixed<N, kShort>::kThreads, 0, stream>>>(
        img, out, h, w, vec, pt);
  } else {
    poly_exp_fixed_kernel<N, kTile><<<tile_grid(h, w), PolyFixed<N, kTile>::kThreads, 0,
                                      stream>>>(img, out, h, w, vec, pt);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// g, xg, xxg (2n+1 each) and ig (ig11, ig03, ig33, ig55) are HOST pointers.
int datmo_poly_exp(float* out, const float* img, int h, int w, int n, const float* g,
                   const float* xg, const float* xxg, const float* ig, int device,
                   void* stream) {
  if (h < 1 || w < 1 || n < 1 || n > kMaxPolyN) return cudaErrorInvalidValue;
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  PolyTaps pt{};
  for (int k = 0; k < 2 * n + 1; ++k) {
    pt.g[k] = g[k];
    pt.xg[k] = xg[k];
    pt.xxg[k] = xxg[k];
  }
  for (int k = 0; k < 4; ++k) pt.ig[k] = ig[k];
  const auto s = static_cast<cudaStream_t>(stream);
  if (poly_taps_structural(pt, n)) {
    if (n == 5) return launch_poly_fixed<5>(out, img, h, w, pt, device, s);
    if (n == 7) return launch_poly_fixed<7>(out, img, h, w, pt, device, s);
  }
  poly_exp_kernel<<<tile_grid(h, w), dim3(kBlockX, kBlockY), 0, s>>>(img, out, h, w, n, pt);
  return cudaGetLastError();
}

// taps (winsize) is a HOST pointer.
int datmo_blur_solve(float* odx, float* ody, const float* M, int h, int w,
                     const float* taps, int winsize, float scale, int device, void* stream) {
  Window win;
  if (h < 1 || w < 1 || !window_from_host(&win, taps, winsize)) return cudaErrorInvalidValue;
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const int r = winsize / 2;
  return with_window_instance(win, winsize, [&](auto radius, auto box) {
    const auto kernel = blur_solve_kernel<decltype(radius)::value, decltype(box)::value>;
    const size_t smem = window_smem_bytes<decltype(radius)::value>(r);
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<tile_grid(h, w), dim3(kBlockX, kBlockY), smem, static_cast<cudaStream_t>(stream)>>>(
        M, odx, ody, h, w, r, win, scale);
    return cudaGetLastError();
  });
}

// taps (winsize) is a HOST pointer.
int datmo_fused_iteration(float* odx, float* ody, const float* R0, const float* R1,
                          const float* dx, const float* dy, int h, int w,
                          const float* taps, int winsize, float scale, int device,
                          void* stream) {
  Window win;
  if (h < 2 || w < 2 || !window_from_host(&win, taps, winsize)) return cudaErrorInvalidValue;
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const int r = winsize / 2;
  return with_window_instance(win, winsize, [&](auto radius, auto box) {
    const auto kernel = fused_iteration_kernel<decltype(radius)::value, decltype(box)::value>;
    const size_t smem = window_smem_bytes<decltype(radius)::value>(r);
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<tile_grid(h, w), dim3(kBlockX, kBlockY), smem, static_cast<cudaStream_t>(stream)>>>(
        R0, R1, dx, dy, odx, ody, h, w, r, win, scale);
    return cudaGetLastError();
  });
}

// All pointers are DEVICE pointers.
int datmo_warp_matrices(float* M, const float* R0, const float* R1, const float* dx,
                        const float* dy, int h, int w, int device, void* stream) {
  if (h < 2 || w < 2) return cudaErrorInvalidValue;
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const size_t n = static_cast<size_t>(h) * w;
  const unsigned int blocks = static_cast<unsigned int>((n + kPixelThreads - 1) / kPixelThreads);
  warp_matrices_kernel<<<blocks, kPixelThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      R0, R1, dx, dy, M, h, w);
  return cudaGetLastError();
}

const char* datmo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
