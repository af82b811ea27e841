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
//   warp_packed_kernel       <- no Pallas kernel: ops/farneback.py::update_matrices
//   corner_scale_kernel         with R1_packed, the small levels' warp (K9) and
//                               its scale pass
//
// Layouts are the JAX package's: images (H, W) and coefficient / normal-equation
// planes (5, H, W), float32, row-major and contiguous.  K1-K3 give each block one
// 32x32 output tile (blockDim 32x8, four rows per thread; K1's compile-time
// instance 256 threads, or 128 for a 16x32 tile on a grid of one wave) and
// stage the tile plus
// its halo in shared memory, recomputing the halo rather than exchanging it:
// blocks run in any order, nothing carries between them.  Halo positions outside
// the image take the value at the clamped pixel (BORDER_REPLICATE), so a partial
// last tile needs no special case.  K4 and K9 have no window and so no halo:
// one thread per output pixel (K9 in 2-D tiles of 32 columns).  K3 and K4
// share the per-pixel exact warp (warp_assemble), and all three M's tail
// (assemble_tail).
//
// Arithmetic order is the plain version's: taps accumulate in ascending order,
// the vertical pass before the horizontal one, and the 1/win^2 box scale comes
// after the horizontal pass.  The library is built with -fmad=false (see
// kernels/build.py) so no multiply-add is contracted but where the plain
// version takes a once-rounded fma (__fmaf_rn), as XLA's compiled CPU code
// contracts it: K1's sums, the Gaussian window's taps, the warp's bilinear
// sums, M's tail and the 2x2 solve.
//
// The flow into a warp (FlowIn) is (vx, vy) or (vx, vy) times a scale, the
// product XLA's compiled refinement recomputes in the warp: the upsampled
// flow times 1 / pyr_scale, or the last solve's numerators times 1 / det.
// Then the position is fma(vx, s, j), once rounded, and M's flow terms take
// the rounded product.  K2 and K3 write either the flow or, between
// iterations, the numerators and 1 / det.
//
// K1 has three kernels: a compile-time instance for poly_n 5 and 7, taken when
// the taps have their structural zero pattern (register-blocked passes, taps
// out of shared memory), the runtime-n kernel for any other taps, and the
// tiny form for images of at most poly_n rows or columns, which runs a
// rounding plan (ops/poly_tiny.py) as a program in two stages, with its own
// entry, datmo_poly_exp_tiny.
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
constexpr int kWarpSize = 32;
constexpr int kPackedRows = 4;     // K9: tiles of 32 columns by 4 rows
constexpr int kScaleThreads = 1024; // K9's scale pass: one block per plane
constexpr int kMaxTaps = 64;        // window taps: winsize <= 63
constexpr int kMaxPolyN = 7;        // poly_n in {5, 7}
constexpr int kMaxPolyTaps = 2 * kMaxPolyN + 1;
constexpr int kBorder = 5;          // OpenCV's certainty attenuation band
__constant__ float kBorderAtten[kBorder] = {0.14f, 0.14f, 0.4472f, 0.4472f, 0.4472f};
// Levels of at most this many rows and columns have one attenuation value
// (the first two of kBorderAtten are equal), which XLA folds to a scalar.
constexpr int kUniformMax = 4;
constexpr int kMainR = 7;           // the main path's window radius (winsize 15)
// K3 on levels below kFusedMinH x kFusedMinW (ops/warp.py::eligible's
// thresholds, which tests/test_torch_exact_route.py holds equal: the small
// levels of the exact warp) at the compile-time radius: tiles of kTile
// columns by kSmallTileH rows, so the grid spreads over more SMs and each
// thread assembles fewer staged positions of M (PERF.md).
constexpr int kFusedMinH = 128;
constexpr int kFusedMinW = 256;
constexpr int kSmallTileH = 8;
// Blocks per SM the winsize-15 instances are built for (56 registers for K3).
// 5 (48 registers, 5 blocks of 43.2 KB) measured slower on the H100: K3 122.4
// against 87.1 us at 1080x1920, the M stage's gathers losing L1 (PERF.md).
constexpr int kWindowMinBlocks = 4;
// Blocks per SM K1's compile-time instances are built for: 32 registers for
// 32-row tiles (256 threads), which beat 40 and 44 at 1080x1920 on the H100;
// 16-row tiles (128 threads) take the 44 they need (PERF.md).
constexpr int kPolyMinBlocks = 8;
// K1's narrow form below w + n of 128 columns (ops/flow_kernels.poly_exp_narrow).
constexpr int kPolyNarrow = 128;

struct Window {
  float w[kMaxTaps];
  unsigned long long shared;  // taps whose weight another tap has (tap_shared)
  // Taps whose products keep their own rounding where an axis is at most the
  // radius (window_broadcast): in the vertical sums of the image's columns
  // (v_int) and of the edge columns that pad them (v_pad), and in the
  // horizontal sums (h_bcast).  Zero on every other level.
  unsigned long long v_int, v_pad, h_bcast;
};

struct PolyTaps {
  float g[kMaxPolyTaps];
  float xg[kMaxPolyTaps];
  float xxg[kMaxPolyTaps];
  float ig[4];  // ig11, ig03, ig33, ig55
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// One of K1's correlation sums, rounded as the plain version's _fma_chain: the
// first product folds into the add of the second, each later product into the
// running sum, by a once-rounded fma; a product that two sums of one output
// share (`shared`) is added separately rounded.
struct FmaChain {
  float acc = 0.0f, w0 = 0.0f, x0 = 0.0f;
  int terms = 0;
  bool shared0 = false;
  __device__ __forceinline__ void add(float w, float x, bool shared = false) {
    if (terms == 0) {
      w0 = w;
      x0 = x;
      shared0 = shared;
    } else if (terms == 1) {
      acc = !shared0 ? __fmaf_rn(w0, x0, w * x)
                     : (!shared ? __fmaf_rn(w, x, w0 * x0) : w0 * x0 + w * x);
    } else {
      acc = shared ? acc + w * x : __fmaf_rn(w, x, acc);
    }
    ++terms;
  }
  __device__ __forceinline__ float value() const { return terms == 1 ? w0 * x0 : acc; }
};

__device__ __forceinline__ float border_atten(int i, int size) {
  const int near = min(i, size - 1 - i);
  return near < kBorder ? kBorderAtten[near] : 1.0f;
}

// The per-pixel 2x2 solve of the five window sums a[0..4] at pixel (i, j),
// stored when the pixel lies in the image: each difference of products a
// once-rounded fma(a, b, -(c * d)), as XLA's compiled solve_flow.  With oidet
// the numerators go to (odx, ody) and 1 / det to oidet (the flow into the next
// iteration's warp); else the flow, numerator times 1 / det.
__device__ __forceinline__ void solve_store(const float* a, float scale, int i, int j, int h,
                                            int w, float* odx, float* ody, float* oidet) {
  if (i >= h || j >= w) return;
  const float g11 = a[0] * scale;
  const float g12 = a[1] * scale;
  const float g22 = a[2] * scale;
  const float h1 = a[3] * scale;
  const float h2 = a[4] * scale;
  const float idet = 1.0f / (__fmaf_rn(g11, g22, -(g12 * g12)) + 1e-3f);
  const float nx = __fmaf_rn(g11, h2, -(g12 * h1));
  const float ny = __fmaf_rn(g22, h1, -(g12 * h2));
  const size_t p = static_cast<size_t>(i) * w + j;
  if (oidet != nullptr) {
    odx[p] = nx;
    ody[p] = ny;
    oidet[p] = idet;
  } else {
    odx[p] = nx * idet;
    ody[p] = ny * idet;
  }
}

// The shared-product mask of a window's taps on an axis of one value, where
// every tap reads that value and XLA computes the product of taps of equal
// weight once: bit k set when another nonzero tap has tap k's weight.
__device__ __forceinline__ bool tap_shared(unsigned long long shared, int k) {
  return (shared >> k) & 1ull;
}

// Window sum of the five staged M planes, then the per-pixel 2x2 solve, at a
// radius r known only at run time (every winsize but the main path's).
//
// ms: 5 planes of e x e (tile plus a halo of r on each side, e = kTile + 2r);
// vbuf: kTile x e scratch; taps: 2r+1 window weights in shared memory.  Writes
// the new flow of the block's tile to (odx, ody).  Shared by K2 and K3.
//
// Each sum is a chain of once-rounded fmas in tap order, zero taps skipped
// (FmaChain; the box's unit taps make it a chain of adds), as XLA's compiled
// gauss_blur5; on an axis of length 1 the products of equal taps are added
// separately rounded (shared), and where an axis is at most the radius the
// broadcast taps' products keep their own rounding (Window's v_int, v_pad for
// the staged columns outside the image, and h_bcast), in the kBcast
// instance, which the launch picks for such a level alone (as runtime flags
// they cost the other levels of this stage 17-19 µs a launch on the H100,
// PERF.md).  Levels of one row or column take this stage, and so do those.
template <bool kBcast>
__device__ void window_solve(const float* ms, float* vbuf, const float* taps, int r,
                             unsigned long long shared, unsigned long long v_int,
                             unsigned long long v_pad, unsigned long long h_bcast, float scale,
                             int y0, int x0, int h, int w, float* odx, float* ody,
                             float* oidet) {
  const int e = kTile + 2 * r;
  const int ntaps = 2 * r + 1;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const bool one_row = h == 1;
  const bool one_col = w == 1;
  float acc[kRowsPerThread][5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float* m = ms + static_cast<size_t>(c) * e * e;
    __syncthreads();  // M staged; the previous channel's reads of vbuf are done
    for (int idx = tid; idx < kTile * e; idx += nthreads) {
      const int i = idx / e;
      const int j = idx - i * e;
      const int gj = x0 - r + j;
      const unsigned long long bcast = !kBcast ? 0ull : gj < 0 || gj >= w ? v_pad : v_int;
      FmaChain s;
      for (int k = 0; k < ntaps; ++k)
        if (taps[k] != 0.0f)
          s.add(taps[k], m[(i + k) * e + j],
                (one_row && tap_shared(shared, k)) || (kBcast && tap_shared(bcast, k)));
      vbuf[idx] = s.value();
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const float* v = vbuf + (threadIdx.y + q * kBlockY) * e + threadIdx.x;
      FmaChain s;
      for (int k = 0; k < ntaps; ++k)
        if (taps[k] != 0.0f)
          s.add(taps[k], v[k],
                (one_col && tap_shared(shared, k)) || (kBcast && tap_shared(h_bcast, k)));
      acc[q][c] = s.value();
    }
  }
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q)
    solve_store(acc[q], scale, y0 + threadIdx.y + q * kBlockY, x0 + threadIdx.x, h, w, odx,
                ody, oidet);
}

// Layout of the five staged planes of a block: edge e = kTile + 2r, rows
// `stride` floats apart, planes e * stride apart.  kR > 0 is a compile-time
// radius, whose rows get an odd stride (window_solve_fixed); kR == 0 takes
// the radius r at run time, rows packed (window_solve).
// A tile of kTileH rows (kTile by default; a compile-time radius only
// otherwise) stages rows = kTileH + 2r of them.
template <int kR, int kTileH = kTile>
struct Staged {
  static_assert(kR > 0 || kTileH == kTile, "the runtime radius takes square tiles");
  int e, rows, stride;
  __device__ __host__ explicit Staged(int r)
      : e(kTile + 2 * (kR > 0 ? kR : r)), rows(kTileH + 2 * (kR > 0 ? kR : r)),
        stride(kR > 0 ? (e | 1) : e) {}
  __device__ __host__ int plane() const { return rows * stride; }
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
// kernel parameters read at unrolled, constant indices, each sum a chain of
// once-rounded fmas as in window_solve (a running sum holds its first value
// until the second tap: fma(t0, v0, t1 * v1)).  Levels of one row or column
// take window_solve, which adds the products of equal taps there.
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
template <int R, bool kBox, int kTileH = kTile>
__device__ void window_solve_fixed(float* ms, const Window& win, float scale, int y0, int x0,
                                   int h, int w, float* odx, float* ody, float* oidet) {
  constexpr int kTaps = 2 * R + 1;
  constexpr int kE = kTile + 2 * R;
  constexpr int kEH = kTileH + 2 * R;
  constexpr int kStride = kE | 1;
  constexpr int kPlane = kEH * kStride;
  constexpr int kRun = kTileH * kTile / (kBlockX * kBlockY);  // outputs per thread
  constexpr int kRowsPerWarp = 32 * kRun / kTile;
  static_assert(kRun >= 1 && kBlockX * kBlockY / 32 * kRowsPerWarp == kTileH,
                "one output row per run slot");
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  float taps[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) taps[k] = kBox ? 1.0f : win.w[k];

  __syncthreads();  // M staged
  if (tid < 5 * kE) {
    const int c = tid / kE;
    float* col = ms + c * kPlane + (tid - c * kE);
    float acc[kTileH];
#pragma unroll
    for (int y = 0; y < kEH; ++y) {
      const float v = col[y * kStride];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const int i = y - k;  // output row i takes tap k from row y
        if (i >= 0 && i < kTileH) {
          if (kBox)
            acc[i] = k == 0 ? v : acc[i] + v;
          else
            acc[i] = k == 0 ? v
                   : k == 1 ? __fmaf_rn(taps[0], acc[i], taps[1] * v)
                            : __fmaf_rn(taps[k], v, acc[i]);
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
          if (kBox)
            acc[q] = k == 0 ? val : acc[q] + val;
          else
            acc[q] = k == 0 ? val
                   : k == 1 ? __fmaf_rn(taps[0], acc[q], taps[1] * val)
                            : __fmaf_rn(taps[k], val, acc[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRun; ++q) out[q][c] = acc[q];
  }
#pragma unroll
  for (int q = 0; q < kRun; ++q)
    solve_store(out[q], scale, y0 + row, x0 + c0 + q, h, w, odx, ody, oidet);
}

__device__ void load_taps(float* dst, const Window& win, int ntaps) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = tid; k < ntaps; k += blockDim.x * blockDim.y) dst[k] = win.w[k];
}

// The flow into a warp at pixel p: (vx, vy) (mode 0) or (vx, vy) times a
// scale, s0 (mode 1: the upsampled flow's 1 / pyr_scale) or s[p] (mode 2: the
// last solve's 1 / det).  The kernels take the mode as a template parameter
// (with_flow_mode), so a warp carries no branch on it.
struct FlowIn {
  const float* vx;
  const float* vy;
  const float* s;
  float s0;
  int mode;
  // The sampling position (gx, gy) of pixel (gi, gj) and the flow (dx, dy):
  // with a scale the position is fma(v, s, j), once rounded, and the flow the
  // rounded product.  Read-only loads (the flow is an input of the kernel).
  template <int kMode>
  __device__ __forceinline__ void at(size_t p, int gi, int gj, float* gx, float* gy,
                                     float* dx, float* dy) const {
    const float fx = __ldg(vx + p);
    const float fy = __ldg(vy + p);
    if constexpr (kMode == 0) {
      *gx = static_cast<float>(gj) + fx;
      *gy = static_cast<float>(gi) + fy;
      *dx = fx;
      *dy = fy;
    } else {
      const float sc = kMode == 1 ? s0 : __ldg(s + p);
      *gx = __fmaf_rn(fx, sc, static_cast<float>(gj));
      *gy = __fmaf_rn(fy, sc, static_cast<float>(gi));
      *dx = fx * sc;
      *dy = fy * sc;
    }
  }
};

// The bilinear warp's sampling of pixel (gi, gj): the floor of the position,
// its fraction's four weights and the inside mask.
struct WarpAt {
  float a00, a01, a10, a11, dx, dy;
  int x1, y1;
  bool inside;
  template <int kMode>
  __device__ __forceinline__ void init(const FlowIn& flow, size_t p, int gi, int gj, int h,
                                       int w) {
    float gx, gy;
    flow.at<kMode>(p, gi, gj, &gx, &gy, &dx, &dy);
    const float fx1 = floorf(gx);
    const float fy1 = floorf(gy);
    const float fx = gx - fx1;
    const float fy = gy - fy1;
    inside = fx1 >= 0.0f && fx1 < static_cast<float>(w - 1) && fy1 >= 0.0f &&
             fy1 < static_cast<float>(h - 1);
    x1 = inside ? static_cast<int>(fx1) : 0;
    y1 = inside ? static_cast<int>(fy1) : 0;
    a00 = (1.0f - fx) * (1.0f - fy);
    a01 = fx * (1.0f - fy);
    a10 = (1.0f - fx) * fy;
    a11 = fx * fy;
  }
  // a00 c00 + a01 c01 + a10 c10 + a11 c11 as XLA's compiled warp rounds it:
  // fma(a11, c11, fma(a10, c10, fma(a00, c00, a01 c01)))
  __device__ __forceinline__ float sum(float c00, float c01, float c10, float c11) const {
    return __fmaf_rn(a11, c11, __fmaf_rn(a10, c10, __fmaf_rn(a00, c00, a01 * c01)));
  }
};

// The rows of a block: its first row in the grid, the target's rows R1 holds
// above it (a halo), R1's row count and the grid's height; `sharded` for a
// rank's block of the row-sharded flow (parallel/sharded_flow.py), whose
// attenuation XLA cannot fold.  A whole level is {0, 0, h, h, false}.
struct Rows {
  int start, halo, ext, total;
  bool sharded;
};

// M's tail at pixel (gi, gj) from the differences d0 = R0[0] - r[0], d1 and
// the sums s4 = R0[2] + r[2], s5, s6 of the sampled planes r (used where
// inside), stored at m[0], m[stride], ..., m[4 * stride]: the plain version's
// ops/farneback.py::matrices_from_samples, each contraction a __fmaf_rn.  The
// attenuation s of BORDER=5 enters as (a * b) * s^2, XLA's folded form.  Which
// product of h2 + r4 dy and h3 + r6 dy each of M3 and M4 contracts depends on
// the warp (kPacked: K9), on a level of one row or column and on whether the
// flow is a recomputed product (`computed`), as the plain version says.
// (gi, gj) is the pixel in the grid of h rows.  A
// sharded block scales each value first, R = r s (`unfolded`), and then
// M0 = fma(R4, R4, R6 R6), M3 = fma(R4, R2, R6 R3) and M4 takes r4 dy rounded.
// A level of more than one pixel whose attenuation is one value (kUniform:
// at most 4 rows and 4 columns, where kBorderAtten[0] == kBorderAtten[1])
// takes the same unfolded form, XLA's for a scalar attenuation, with M4's
// r4 dy contracted but on a level of one row or column, where
// M1 = (R4 + R5) R6.  K3 (!kGeneral) runs no level of one row or column,
// none of at most kUniformMax rows and columns and no sharded block
// (datmo_fused_iteration refuses them), and carries no such case.
template <bool kPacked, bool kGeneral, bool kUniform = false>
__device__ __forceinline__ void assemble_tail(const float* r0, size_t plane, const WarpAt& wa,
                                              float d0, float d1, float s4, float s5,
                                              float s6, bool computed, bool unfolded, int gi,
                                              int gj, int h, int w, float* m, size_t stride) {
  const bool in = wa.inside;
  const float r4 = in ? s4 * 0.5f : r0[2 * plane];
  const float r5 = in ? s5 * 0.5f : r0[3 * plane];
  const float r6 = in ? s6 * 0.25f : r0[4 * plane] * 0.5f;
  const float h2 = (in ? d0 : r0[0]) * 0.5f;
  const float h3 = (in ? d1 : r0[plane]) * 0.5f;
  const float dx = wa.dx;
  const float dy = wa.dy;
  // r4 dy also stays rounded on a level of one row or column (no pixel inside);
  // M3's sums as the plain version picks them for each kind of level
  const bool one_line = kGeneral && (h == 1 || w == 1);
  const float r2_sep = __fmaf_rn(r6, dx, h2 + r4 * dy);
  const float r2_fma = __fmaf_rn(r6, dx, __fmaf_rn(r4, dy, h2));
  const float r2 = one_line ? r2_sep : r2_fma;
  const float r3 = __fmaf_rn(r5, dx, __fmaf_rn(r6, dy, h3));
  const float r3_sep = __fmaf_rn(r5, dx, h3 + r6 * dy);
  const float r2_m3 = kPacked ? (h == 1 || (w == 1 && computed) ? r2_sep : r2_fma) : r2;
  const float r3_m3 = (kPacked ? computed || w == 1 : computed && one_line) ? r3_sep : r3;
  const float s = border_atten(gi, h) * border_atten(gj, w);
  m[stride] = __fmaf_rn(r4, s, r5 * s) * (r6 * s);
  if (kGeneral && (kUniform || unfolded)) {
    const float R4 = r4 * s, R5 = r5 * s, R6 = r6 * s;
    if (kUniform && one_line) m[stride] = (R4 + R5) * R6;
    m[0] = __fmaf_rn(R4, R4, R6 * R6);
    m[2 * stride] = __fmaf_rn(R5, R5, R6 * R6);
    m[3 * stride] = __fmaf_rn(R4, r2_m3 * s, R6 * (r3_m3 * s));
    m[4 * stride] = __fmaf_rn(R6, (kUniform ? r2 : r2_sep) * s, R5 * (r3 * s));
    return;
  }
  const float s2 = s * s;
  const float r66 = (r6 * r6) * s2;
  m[0] = __fmaf_rn(r4 * r4, s2, r66);
  m[2 * stride] = __fmaf_rn(r5 * r5, s2, r66);
  m[3 * stride] = __fmaf_rn(r4 * r2_m3, s2, (r6 * r3_m3) * s2);
  m[4 * stride] = __fmaf_rn(r6 * (kPacked ? r2_sep : r2), s2, (r5 * r3) * s2);
}

// The exact warp and M assembly of one pixel (gi, gj) of a block of h rows,
// shared by K3 and K4: bilinear warp of R1's five planes to the absolute
// position (gj + dx, gi + rows.start + dy), the inside mask, the BORDER=5
// attenuation and the five normal-equation values, stored at m[0], m[stride],
// ..., m[4 * stride].  Warp weights: floor and fraction of the absolute
// position j + dx, not of dx; a sampled row clamps to R1's rows (a sharded
// block's halo).  The operations and their order are the plain version's
// (ops/farneback.py::update_matrices, parallel/sharded_flow.py::
// sharded_update_reference).
template <int kMode, bool kGeneral, bool kUniform = false>
__device__ __forceinline__ void warp_assemble(const float* __restrict__ R0,
                                              const float* __restrict__ R1, const FlowIn& flow,
                                              const Rows& rows, int gi, int gj, int h, int w,
                                              float* m, size_t stride) {
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t p = static_cast<size_t>(gi) * w + gj;
  const int row = gi + rows.start;
  WarpAt wa;
  wa.init<kMode>(flow, p, row, gj, rows.total, w);
  float wr[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (wa.inside) {
    const int y = clampi(wa.y1 - rows.start + rows.halo, 0, rows.ext - 2);
    const size_t b = static_cast<size_t>(y) * w + static_cast<size_t>(clampi(wa.x1, 0, w - 2));
    const size_t plane1 = static_cast<size_t>(rows.ext) * w;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float* q = R1 + c * plane1 + b;
      wr[c] = wa.sum(q[0], q[1], q[w], q[w + 1]);
    }
  }
  const float* r0 = R0 + p;
  assemble_tail<false, kGeneral, kUniform>(r0, plane, wa, r0[0] - wr[0], r0[plane] - wr[1],
                                           r0[2 * plane] + wr[2], r0[3 * plane] + wr[3],
                                           r0[4 * plane] + wr[4], kMode != 0, rows.sharded,
                                           row, gj, rows.total, w, m, stride);
}

// The packed warp's quantisation (K9): each corner is clip(rint(v / s), -q,
// q) of R1's value v and its plane's scale s (ops/farneback.py::pack_corners:
// rint of the IEEE quotient, half to even), through an integer as the table
// holds it: a v in (-s / 2, 0) gives +0.0, not -0.0.  An out-of-range
// quotient saturates and a NaN gives 0, as the table's conversion gives them.
//
// rint of the quotient is taken from qa = v * rs, rs = rcp.approx(s) (within
// 1 ulp of 1 / s, PTX ISA): |qa - v / s| <= |v / s| (2^-23 + 2^-24), and the
// IEEE quotient is within |v / s| 2^-24 of v / s, so both lie within
// |qa| 2^-22 (1 + 2^-22) of each other, half the margin rint_quotient
// takes.  Where qa lies farther than |qa| 2^-21 from a half-integer, both
// round to the same integer; elsewhere (rarely: most often at the int16
// planes' large values; a NaN; a quotient of 2^20 or more) the IEEE division
// decides.  So the bits are the division's (tests/test_torch_packed_warp.py
// holds the rule to it in float32 numpy), at a multiply's cost.
struct Quantiser {
  float s, rs;
  __device__ __forceinline__ explicit Quantiser(float scale) : s(scale) {
    asm("rcp.approx.f32 %0, %1;" : "=f"(rs) : "f"(scale));
  }
  // rint(v / s) from the product; *slow set where the division must decide
  __device__ __forceinline__ float rint_quotient(float v, bool* slow) const {
    const float qa = __fmul_rn(v, rs);
    const float n = rintf(qa);
    *slow = !(0.5f - fabsf(qa - n) > fabsf(qa) * 0x1p-21f);
    return n;
  }
  __device__ __forceinline__ float rint_divided(float v) const { return rintf(__fdiv_rn(v, s)); }
};

__device__ __forceinline__ float clip_through_int(float n, int q) {
  return static_cast<float>(clampi(__float2int_rn(n), -q, q));
}

// The packed warp and M assembly of one pixel (gi, gj) (K9): the four corners
// of the five planes read from R1 at (y1, x1), (y1, x1 + 1), (y1 + 1, x1) and
// (y1 + 1, x1 + 1), each quantised with its plane's scale qs[5] (int16 for
// planes 0-1, int8 for planes 2-4: Quantiser), as the packed table
// (ops/farneback.py::pack_corner_pairs) holds them, times qs, and M's tail,
// rounded as XLA compiles the packed update_matrices: the int16 planes' sums
// start fma(a01, c01, a00 c00); the scale of planes 2-4 is contracted into
// R0 + r, that of planes 0-1 into R0 - r in XLA's vector loops, the columns
// below (w - 1) / 8 * 8, not in their scalar remainder.  A pixel inside has
// all four corners in R1 (x1 < w - 1, y1 < h - 1), so the table's edge
// replication is never reached; a pixel outside uses no corner
// (assemble_tail) and reads none.  The chain of one pixel's latencies is the
// kernel's time at the small levels, so R0's five values load with the flow,
// the 20 corners load together, and their quantisation is straight-line
// code; a pixel with a corner the product cannot decide loops over those
// corners alone.
template <int kMode>
__device__ __forceinline__ void warp_assemble_packed(const float* __restrict__ R0,
                                                     const float* __restrict__ R1,
                                                     const float* __restrict__ qs,
                                                     const FlowIn& flow, int gi, int gj, int h,
                                                     int w, float* m, size_t stride) {
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t p = static_cast<size_t>(gi) * w + gj;
  float r0[5], qsc[5];
#pragma unroll
  for (int ch = 0; ch < 5; ++ch) {
    r0[ch] = __ldg(R0 + p + ch * plane);
    qsc[ch] = __ldg(qs + ch);
  }
  WarpAt wa;
  wa.init<kMode>(flow, p, gi, gj, h, w);
  float c[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (wa.inside) {
    const float* q = R1 + static_cast<size_t>(wa.y1) * w + wa.x1;
    float v[5][4];
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) {
      v[ch][0] = __ldg(q + ch * plane);
      v[ch][1] = __ldg(q + ch * plane + 1);
      v[ch][2] = __ldg(q + ch * plane + w);
      v[ch][3] = __ldg(q + ch * plane + w + 1);
    }
    float n[5][4];
    unsigned int slow = 0;  // bit 4 ch + k: the division decides
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) {
      const Quantiser qz(qsc[ch]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bool s;
        n[ch][k] = qz.rint_quotient(v[ch][k], &s);
        slow |= static_cast<unsigned int>(s) << (4 * ch + k);
      }
    }
    while (slow) {  // rare: the corners the product cannot decide, one by one
      const int i = __ffs(slow) - 1;
      slow &= slow - 1;
      const int ch = i >> 2, k = i & 3;
      const float x = __ldg(q + ch * plane + (k & 1) + (k >> 1) * w);
      const float r = rintf(__fdiv_rn(x, __ldg(qs + ch)));
#pragma unroll
      for (int j = 0; j < 20; ++j)
        if (j == i) n[j >> 2][j & 3] = r;
    }
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) {
      const int qmax = ch < 2 ? 32767 : 127;
      const float a = clip_through_int(n[ch][0], qmax);
      const float b = clip_through_int(n[ch][1], qmax);
      const float cc = clip_through_int(n[ch][2], qmax);
      const float d = clip_through_int(n[ch][3], qmax);
      c[ch] = ch < 2 ? __fmaf_rn(wa.a11, d, __fmaf_rn(wa.a10, cc, __fmaf_rn(wa.a01, b, wa.a00 * a)))
                     : wa.sum(a, b, cc, d);
    }
  }
  const bool vec = gj < (w - 1) / 8 * 8;
  const float d0 = vec ? __fmaf_rn(c[0], -qsc[0], r0[0]) : r0[0] - c[0] * qsc[0];
  const float d1 = vec ? __fmaf_rn(c[1], -qsc[1], r0[1]) : r0[1] - c[1] * qsc[1];
  // R0's values from registers: the tail reads plane k at r0[k * 1]
  assemble_tail<true, true>(r0, 1, wa, d0, d1, __fmaf_rn(c[2], qsc[2], r0[2]),
                            __fmaf_rn(c[3], qsc[3], r0[3]), __fmaf_rn(c[4], qsc[4], r0[4]),
                            kMode != 0, false, gi, gj, h, w, m, stride);
}

// ---------------------------------------------------------------- K1
// Polynomial expansion: image (H, W) -> planes (5, H, W) =
// [y-linear, x-linear, y^2, x^2, xy], the inverse-Gram-scaled separable
// correlations of FarnebackPolyExp (2n+1 taps of g, xg, xxg).
//
// Replaces ops/flow_pallas.py::poly_exp_pallas.  Bound on the H100: it moves
// 24 bytes per pixel (one image read, five plane writes) for ~211 flops (an
// fma counted as two), about the card's float32 flop:byte balance, so neither
// side dominates at 1080p.  Tiling: the block reads its tile plus an n-pixel halo
// once into shared memory (edge-clamped, which is the plain version's edge
// padding of the image and of the row planes), keeps the three vertical
// correlations there, and writes only the five planes.  Skip rules as the plain
// version: xg's zero centre tap is skipped in the vertical pass, xxg's is kept;
// horizontal taps that are zero in float32 are skipped.  Rounding as the plain
// version: each sum is a chain of once-rounded fmas (FmaChain), and the x^2
// plane's g and xxg sums add their shared products (x = +-1, where xxg == g
// exactly) separately rounded, so it takes a second g sum of row_g.  At a
// narrow width (w + n < 128, ops/flow_kernels.poly_exp_narrow) XLA fuses the
// vertical pass into the planes' fusion, and the y^2 plane's b1 and b5 take
// their centre tap from row planes recomputed with those shared products
// separately rounded (centre_sum).  The launch decides it from w: the
// compile-time instance has a narrow variant (kNarrow, 16-row tiles), so the
// wide instances carry no code for it; the runtime-n kernel takes a flag.
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

// One vertical g or xxg sum of the staged column `col` (2N + 1 rows `stride`
// apart) with the products of taps N -+ 1 separately rounded: the row planes
// XLA recomputes for the centre tap at a narrow width.
template <int N>
__device__ __forceinline__ float centre_sum(const float* k, const float* col, int stride) {
  float a = __fmaf_rn(k[0], col[0], k[1] * col[stride]);
#pragma unroll
  for (int t = 2; t < 2 * N + 1; ++t) {
    const float v = col[t * stride];
    a = (t == N - 1 || t == N + 1) ? a + k[t] * v : __fmaf_rn(k[t], v, a);
  }
  return a;
}

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
template <int N, int kTileH, bool kNarrow>
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
    float vprev = 0.0f;  // the row above v: tap 0 of the outputs that take v as tap 1
#pragma unroll
    for (int y = 0; y < L::kRun + 2 * N; ++y) {
      const float v = src[y * L::kImgStride];
#pragma unroll
      for (int k = 1; k < kTaps; ++k) {
        const int i = y - k;  // output row i takes tap k from row y
        if (i >= 0 && i < L::kRun) {
          if (k == 1) {  // tap 0's product folds into tap 1's add
            ag[i] = __fmaf_rn(pt.g[0], vprev, pt.g[1] * v);
            axg[i] = __fmaf_rn(pt.xg[0], vprev, pt.xg[1] * v);
            axxg[i] = __fmaf_rn(pt.xxg[0], vprev, pt.xxg[1] * v);
          } else {
            ag[i] = __fmaf_rn(pt.g[k], v, ag[i]);
            if (k != N) axg[i] = __fmaf_rn(pt.xg[k], v, axg[i]);
            axxg[i] = __fmaf_rn(pt.xxg[k], v, axxg[i]);
          }
        }
      }
      vprev = v;
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
  // b5 = g*row_xxg, b6 = xg*row_xg; b1s is b1 as the x^2 plane rounds it.
  // Taps N -+ 1 (x = -+1) are the ones where xxg == g exactly (x^2 g is g
  // there, and differs from a nonzero g at every other x), so b1s and b4 add
  // their products there separately rounded; taps 0 and 1 are never among
  // them, so each first product folds into the second's add.
  static_assert(N >= 3, "the shared taps N -+ 1 lie past the first two");
  constexpr int kH = L::kHRun;
  const int lane = tid & 31;
  const int row = (tid >> 5) * (32 / L::kRunsPerRow) + lane / L::kRunsPerRow;
  const int c0 = (lane % L::kRunsPerRow) * kH;
  float b1[kH], b1s[kH], b2[kH], b3[kH], b4[kH], b5[kH], b6[kH];
  // at a narrow width, the y^2 plane's centre taps, computed where they are added
  const float* col = s_img + row * L::kImgStride + c0 + N;  // output q's column at col[q]
  const float* rg = s_rows[0] + row * L::kRowStride + c0;
  float vprev = 0.0f;  // the column left of v
#pragma unroll
  for (int x = 0; x < kH + 2 * N; ++x) {
    const float v = rg[x];
#pragma unroll
    for (int k = 1; k < kTaps; ++k) {
      const int q = x - k;  // output q takes tap k from column x
      if (q >= 0 && q < kH) {
        if (k == 1) {
          b1[q] = __fmaf_rn(pt.g[0], vprev, pt.g[1] * v);
          b1s[q] = b1[q];
          b2[q] = __fmaf_rn(pt.xg[0], vprev, pt.xg[1] * v);
          b4[q] = __fmaf_rn(pt.xxg[0], vprev, pt.xxg[1] * v);
        } else {
          const float c = k == N && kNarrow ? centre_sum<N>(pt.g, col + q, L::kImgStride) : v;
          b1[q] = __fmaf_rn(pt.g[k], c, b1[q]);
          if (k == N - 1 || k == N + 1) {
            b1s[q] = b1s[q] + pt.g[k] * v;
            b4[q] = b4[q] + pt.xxg[k] * v;
          } else {
            b1s[q] = __fmaf_rn(pt.g[k], v, b1s[q]);
            if (k != N) b4[q] = __fmaf_rn(pt.xxg[k], v, b4[q]);
          }
          if (k != N) b2[q] = __fmaf_rn(pt.xg[k], v, b2[q]);
        }
      }
    }
    vprev = v;
  }
  const float* rxg = s_rows[1] + row * L::kRowStride + c0;
  vprev = 0.0f;
#pragma unroll
  for (int x = 0; x < kH + 2 * N; ++x) {
    const float v = rxg[x];
#pragma unroll
    for (int k = 1; k < kTaps; ++k) {
      const int q = x - k;
      if (q >= 0 && q < kH) {
        if (k == 1) {
          b3[q] = __fmaf_rn(pt.g[0], vprev, pt.g[1] * v);
          b6[q] = __fmaf_rn(pt.xg[0], vprev, pt.xg[1] * v);
        } else {
          b3[q] = __fmaf_rn(pt.g[k], v, b3[q]);
          if (k != N) b6[q] = __fmaf_rn(pt.xg[k], v, b6[q]);
        }
      }
    }
    vprev = v;
  }
  const float* rxxg = s_rows[2] + row * L::kRowStride + c0;
  vprev = 0.0f;
#pragma unroll
  for (int x = 0; x < kH + 2 * N; ++x) {
    const float v = rxxg[x];
#pragma unroll
    for (int k = 1; k < kTaps; ++k) {
      const int q = x - k;
      if (q >= 0 && q < kH) {
        const float c = k == N && kNarrow ? centre_sum<N>(pt.xxg, col + q, L::kImgStride) : v;
        b5[q] = k == 1 ? __fmaf_rn(pt.g[0], vprev, pt.g[1] * v) : __fmaf_rn(pt.g[k], c, b5[q]);
      }
    }
    vprev = v;
  }

  const int i = y0 + row;
  const int j = x0 + c0;
  if (i >= h || j >= w) return;
  float o[5][kH];
#pragma unroll
  for (int q = 0; q < kH; ++q) {
    o[0][q] = b3[q] * pt.ig[0];
    o[1][q] = b2[q] * pt.ig[0];
    o[2][q] = __fmaf_rn(b5[q], pt.ig[2], b1[q] * pt.ig[1]);
    o[3][q] = __fmaf_rn(b4[q], pt.ig[2], b1s[q] * pt.ig[1]);
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
                int n, bool narrow, PolyTaps pt) {
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
    FmaChain rg, rxg, rxxg;
    for (int k = 0; k < ntaps; ++k) {
      const float v = s_img[(i + k) * e + j];
      rg.add(g[k], v);
      if (xg[k] != 0.0f) rxg.add(xg[k], v);
      rxxg.add(xxg[k], v);
    }
    s_rows[0][idx] = rg.value();
    s_rows[1][idx] = rxg.value();
    s_rows[2][idx] = rxxg.value();
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
    // b5 = g*row_xxg, b6 = xg*row_xg, each over its nonzero taps; b1s is b1
    // as the x^2 plane rounds it (taps where xxg == g are shared with b4).
    // At a narrow width b1 and b5 take their centre tap from row planes with
    // those shared products separately rounded (cg, cxxg).
    float cg = 0.0f, cxxg = 0.0f;
    if (narrow) {
      FmaChain vg, vxxg;
      for (int k = 0; k < ntaps; ++k) {
        const float v = s_img[(li + k) * e + threadIdx.x + n];
        const bool shared = g[k] == xxg[k] && g[k] != 0.0f;
        vg.add(g[k], v, shared);
        vxxg.add(xxg[k], v, shared);
      }
      cg = vg.value();
      cxxg = vxxg.value();
    }
    FmaChain b1, b1s, b2, b3, b4, b5, b6;
    for (int k = 0; k < ntaps; ++k) {
      const bool shared = g[k] == xxg[k];
      const bool centre = narrow && k == n;
      if (g[k] != 0.0f) {
        b1.add(g[k], centre ? cg : rg[k]);
        b1s.add(g[k], rg[k], shared);
        b3.add(g[k], rxg[k]);
        b5.add(g[k], centre ? cxxg : rxxg[k]);
      }
      if (xg[k] != 0.0f) {
        b2.add(xg[k], rg[k]);
        b6.add(xg[k], rxg[k]);
      }
      if (xxg[k] != 0.0f) b4.add(xxg[k], rg[k], shared);
    }
    const float ig11 = s_pt.ig[0], ig03 = s_pt.ig[1], ig33 = s_pt.ig[2], ig55 = s_pt.ig[3];
    const size_t p = static_cast<size_t>(i) * w + j;
    out[p] = b3.value() * ig11;
    out[plane + p] = b2.value() * ig11;
    out[2 * plane + p] = __fmaf_rn(b5.value(), ig33, b1.value() * ig03);
    out[3 * plane + p] = __fmaf_rn(b4.value(), ig33, b1s.value() * ig03);
    out[4 * plane + p] = b6.value() * ig55;
  }
}

// K1's tiny form, at most n rows or columns (ops/poly_tiny.py): XLA rounds
// such shapes by rules of their own (broadcast taps, sums recomputed in the
// planes' fusion), which ops/poly_tiny.tiny_plan writes down as a rounding
// plan: vertical-sum variants and the seven horizontal sums that read them.
// ops/poly_tiny.tiny_program turns the plan into the program this kernel
// runs: each chain's operation at each tap (poly_tiny.chain_ops, the plan's
// chain with its lead, swap, separate products and trailing broadcast terms
// decided on the host), each horizontal tap's fixed variant, and the tile.
//
// Bound on the H100: a few thousand outputs, so launch latency and one
// block's dependent chains, not bytes or operations.  Two stages in one
// launch.  Stage 1 computes every vertical-sum variant once per (row,
// column) of the block's tile and of its n-column halo inside the image, in
// parallel across the threads, into shared memory; stage 2 forms each of
// the seven horizontal chains of each pixel from there, in parallel, into
// shared memory; stage 3 writes each pixel's five planes.  Each chain is
// straight-line code (TinyAcc): a pixel's seven sums unrolled in one thread
// took many more registers and measured slower.  The program and the
// taps sit in shared memory; the tap loops unroll into registers (compile-time
// instances for n = 5 and 7, taken for the structural taps as K1's wide form
// takes them; the runtime-n instance unrolls to kMaxPolyTaps, its program
// skipping the taps past 2n + 1).  A block takes all of the short axis by up
// to poly_tiny.TILE of the long one, the tile whose grid takes the fewest
// rounds of chains per thread (poly_tiny.tiny_tiles), so a tall or a wide
// image spreads over many blocks.
constexpr int kTinyVariants = 12;
constexpr int kTinyOps = 16;  // operations per chain: one per tap, then skips
constexpr int kTinyThreads = 256;
constexpr int kTinySmem = 48 * 1024;
enum TinyOp { kSkip = 0, kFirst = 1, kFuse0 = 2, kFma = 3, kAdd = 4 };

// ops/poly_tiny.tiny_program, packed: the variant count, the tile, then per
// horizontal sum (v_int, v_pad, v_rem, rem_start), the kinds (0 g, 1 xg,
// 2 xxg), the operations and each horizontal tap's fixed variant (or -1).
struct TinyProgram {
  int nv, tile_rows, tile_cols;
  int sv[7][4];
  signed char vkind[kTinyVariants];
  signed char vop[kTinyVariants][kTinyOps];
  signed char skind[8];
  signed char sop[7][kTinyOps];
  signed char sfix[7][kTinyOps];
};
static_assert(sizeof(TinyProgram) % sizeof(int) == 0, "copied to shared memory as words");

// One chain of the program, fed its terms in tap order (poly_tiny.chain_ops):
// every candidate is formed and the operation selects one, so that a chain
// is straight-line code whatever its operations (they differ between a
// block's variants and sums, not between the threads of most warps).
struct TinyAcc {
  float out = 0.0f, c0 = 0.0f, x0 = 0.0f;
  __device__ __forceinline__ void step(int op, float c, float x) {
    const float p = c * x;
    const float fused0 = __fmaf_rn(x0, c0, p);
    const float fused = __fmaf_rn(x, c, out);
    const float added = out + p;
    const bool first = op == kFirst;
    out = first ? p : op == kFuse0 ? fused0 : op == kFma ? fused : op == kAdd ? added : out;
    c0 = first ? c : c0;
    x0 = first ? x : x0;
  }
};

template <int N>
__global__ void __launch_bounds__(kTinyThreads)
poly_exp_tiny_kernel(const float* __restrict__ img, float* __restrict__ out, int h, int w,
                     int n_rt, const __grid_constant__ PolyTaps pt,
                     const __grid_constant__ TinyProgram prog) {
  constexpr int kT = N > 0 ? 2 * N + 1 : kMaxPolyTaps;
  const int n = N > 0 ? N : n_rt;
  __shared__ TinyProgram sp;
  __shared__ float taps[3][kTinyOps];
  // [variant][tile row][staged column], then [sum][pixel of the tile]
  extern __shared__ float vs[];
  const int tid = threadIdx.x;
  const int* words = reinterpret_cast<const int*>(&prog);
  for (int q = tid; q < static_cast<int>(sizeof(TinyProgram) / sizeof(int)); q += kTinyThreads)
    reinterpret_cast<int*>(&sp)[q] = words[q];
  if (tid < 3 * kTinyOps) {
    const int kind = tid / kTinyOps, k = tid - kind * kTinyOps;
    const float* c = kind == 0 ? pt.g : kind == 1 ? pt.xg : pt.xxg;
    taps[kind][k] = k < 2 * n + 1 ? c[k] : 0.0f;
  }
  __syncthreads();
  const int i0 = blockIdx.y * prog.tile_rows, j0 = blockIdx.x * prog.tile_cols;
  const int rows = min(prog.tile_rows, h - i0), cols = min(prog.tile_cols, w - j0);
  const int c_lo = max(0, j0 - n);
  const int sc = min(w, j0 + cols + n) - c_lo;
  const int per_v = rows * sc;
  const int pixels = rows * cols;
  float* hs = vs + prog.nv * per_v;
  // stage 1: each variant's vertical sum at each staged (row, column)
  for (int idx = tid; idx < prog.nv * per_v; idx += kTinyThreads) {
    const int v = idx / per_v;
    const int r = (idx - v * per_v) / sc;
    const float* src = img + (c_lo + idx - v * per_v - r * sc);
    const float* c = taps[sp.vkind[v]];
    const signed char* ops = sp.vop[v];
    TinyAcc acc;
#pragma unroll
    for (int k = 0; k < kT; ++k)
      acc.step(ops[k], c[k],
               __ldg(src + static_cast<size_t>(clampi(i0 + r + k - n, 0, h - 1)) * w));
    vs[idx] = acc.out;
  }
  __syncthreads();
  // stage 2: each horizontal sum at each pixel, from the staged variants
  for (int idx = tid; idx < 7 * pixels; idx += kTinyThreads) {
    const int q = idx / pixels;
    const int r = (idx - q * pixels) / cols;
    const int j = j0 + idx - q * pixels - r * cols;
    const float* vrow = vs + r * sc - c_lo;  // + v * per_v + column
    const float* c = taps[sp.skind[q]];
    const signed char* ops = sp.sop[q];
    const signed char* fix = sp.sfix[q];
    const int v_int = sp.sv[q][0], v_pad = sp.sv[q][1], v_rem = sp.sv[q][2];
    const int rem_start = sp.sv[q][3];
    TinyAcc acc;
#pragma unroll
    for (int k = 0; k < kT; ++k) {
      const int col = j + k - n;
      int v = fix[k];
      if (v < 0) v = (col >= 0 && col < w) ? (col >= rem_start ? v_rem : v_int) : v_pad;
      acc.step(ops[k], c[k], vrow[v * per_v + clampi(col, 0, w - 1)]);
    }
    hs[idx] = acc.out;
  }
  __syncthreads();
  // stage 3: each pixel's five planes
  const size_t plane = static_cast<size_t>(h) * w;
  for (int p = tid; p < pixels; p += kTinyThreads) {
    const int r = p / cols;
    const size_t o = static_cast<size_t>(i0 + r) * w + j0 + p - r * cols;
    const float* s = hs + p;
    out[o] = s[0] * pt.ig[0];
    out[plane + o] = s[pixels] * pt.ig[0];
    out[2 * plane + o] = __fmaf_rn(s[2 * pixels], pt.ig[2], s[3 * pixels] * pt.ig[1]);
    out[3 * plane + o] = __fmaf_rn(s[4 * pixels], pt.ig[2], s[5 * pixels] * pt.ig[1]);
    out[4 * plane + o] = s[6 * pixels] * pt.ig[3];
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
// box when kBox); kR == 0 takes the radius r at run time (window_solve, with
// the broadcast taps when kBcast).
template <int kR, bool kBox, bool kBcast>
__global__ void __launch_bounds__(kBlockX * kBlockY, kR > 0 ? kWindowMinBlocks : 1)
blur_solve_kernel(const float* __restrict__ M, float* __restrict__ odx,
                  float* __restrict__ ody, float* __restrict__ oidet, int h, int w, int r,
                  Window win, float scale) {
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
    window_solve_fixed<kR, kBox>(ms, win, scale, y0, x0, h, w, odx, ody, oidet);
  else
    window_solve<kBcast>(ms, vbuf, taps, r, win.shared, win.v_int, win.v_pad, win.h_bcast,
                         scale, y0, x0, h, w, odx, ody, oidet);
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
// Levels: the large ones (at least 128x256) and the small levels of the
// exact warp, where it replaces K4 then K2 (ops/warp.py::exact_fused), so M
// is neither stored nor reloaded and an iteration is one launch.  It takes
// none of the levels on which K4 then K2 round otherwise: a line (K4's and
// K2's forms for one row or column), a level of at most kUniformMax rows and
// columns (K4's kUniform) or with broadcast taps (K2's kBcast stage).  A
// small level at the compile-time radius is a few blocks of 32x32 tiles
// (4 at 60x60), each thread assembling ~8 staged positions of M, one chain
// of the flow's and R1's loads after another; it takes tiles of kSmallTileH
// rows instead (kTileH), whose window stage sums kRun = 1 output a thread
// (the same order of taps, so the same bits).
template <int kR, bool kBox, int kMode, int kTileH = kTile>
__global__ void __launch_bounds__(kBlockX * kBlockY, kR > 0 ? kWindowMinBlocks : 1)
fused_iteration_kernel(const float* __restrict__ R0, const float* __restrict__ R1,
                       FlowIn flow, float* __restrict__ odx, float* __restrict__ ody,
                       float* __restrict__ oidet, int h, int w, int r, Window win,
                       float scale) {
  extern __shared__ float smem[];
  if (kR > 0) r = kR;
  const Staged<kR, kTileH> st(r);
  float* ms = smem;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTile;
  float* vbuf = ms + 5 * st.plane();
  float* taps = vbuf + kTile * st.e;
  if (kR == 0) load_taps(taps, win, 2 * r + 1);
  for (int idx = tid; idx < st.rows * st.e; idx += nthreads) {
    const int li = idx / st.e;
    const int lj = idx - li * st.e;
    const int gi = clampi(y0 - r + li, 0, h - 1);
    const int gj = clampi(x0 - r + lj, 0, w - 1);
    warp_assemble<kMode, false>(R0, R1, flow, Rows{0, 0, h, h, false}, gi, gj, h, w,
                                ms + st.at(idx, li, lj), st.plane());
  }
  if constexpr (kR > 0)
    window_solve_fixed<kR, kBox, kTileH>(ms, win, scale, y0, x0, h, w, odx, ody, oidet);
  else
    window_solve<false>(ms, vbuf, taps, r, win.shared, win.v_int, win.v_pad, win.h_bcast,
                        scale, y0, x0, h, w, odx, ody, oidet);
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
// corner gathers of a smooth flow hit L1/L2.  It runs where M must be stored
// or where K3 rounds otherwise: a rank's block of the row-sharded flow (M
// crosses ranks before K2), the levels K3 refuses, and the diagnostics; the
// other small levels of the exact warp take K3.
// kUniform: a level of at most kUniformMax rows and columns, whose
// attenuation is one value (assemble_tail); picked per launch, so the other
// levels' instance carries no code for it.
template <int kMode, bool kUniform>
__global__ void __launch_bounds__(kPixelThreads)
warp_matrices_kernel(const float* __restrict__ R0, const float* __restrict__ R1, FlowIn flow,
                     Rows rows, float* __restrict__ M, int h, int w) {
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t p = static_cast<size_t>(blockIdx.x) * kPixelThreads + threadIdx.x;
  if (p >= plane) return;
  const int gi = static_cast<int>(p / w);
  const int gj = static_cast<int>(p - static_cast<size_t>(gi) * w);
  warp_assemble<kMode, true, kUniform>(R0, R1, flow, rows, gi, gj, h, w, M + p, plane);
}

// ---------------------------------------------------------------- K9
// The small levels' packed warp and M assembly when the flow packs R1
// (fast_warp): K4 with each bilinear corner quantised to int16 (planes 0-1)
// or int8 (planes 2-4) with its plane's scale, in two kernels: the scale
// pass (corner_scale_kernel, once per level) and the warp
// (warp_packed_kernel, once per iteration).
//
// No Pallas kernel: the JAX package runs update_matrices with R1_packed in
// XLA below 128x256 on its kernel path too (ops/flow_pallas.py), over a
// table of the four corners of every pixel packed into 7 words, because a
// TPU gathers a row of up to 32 bytes for the cost of one index.  On the
// H100 a pixel's four corners are neighbours in R1, in L1 and L2, and each
// quantised corner depends only on R1 at that point and its plane's scale,
// so the kernel quantises the corners it reads and no table is built
// (~51 launches of plain PyTorch a level before).  Its contracted
// multiply-adds are XLA's.
//
// Bound on the H100: 68 bytes of unique traffic per pixel (R0's and R1's
// five planes, the flow, M's five planes) against ~190 operations (K4's 99,
// the five scales and 20 quantisations: a multiply, a rounding and a clamp
// each, the IEEE division only near a half-integer: Quantiser), so it is
// bound by memory.  At the pipelines' small levels (60x60 to 200x200) a
// launch is about one warp per scheduler, and its time is the chain of one
// pixel's latencies (the flow, then R1's corners, their quantisation, M's
// tail), so the quantisation is kept short: a plain IEEE division per corner
// measured ~0.23 us slower at 60x60 to 97x173 on the H100 (PERF.md).  One
// thread a pixel in 2-D tiles of 32 columns by kPackedRows, so the grid
// spreads over the card's 132 SMs (150 blocks at 97x173) and a warp's corner
// reads fall on two rows of R1; tiles of 1, 2 and 8 rows were no faster.
template <int kMode>
__global__ void __launch_bounds__(kWarpSize * kPackedRows)
warp_packed_kernel(const float* __restrict__ R0, const float* __restrict__ R1,
                   const float* __restrict__ qs, FlowIn flow, float* __restrict__ M, int h,
                   int w) {
  const int gj = static_cast<int>(blockIdx.x) * kWarpSize + static_cast<int>(threadIdx.x);
  const int gi = static_cast<int>(blockIdx.y) * kPackedRows + static_cast<int>(threadIdx.y);
  if (gi >= h || gj >= w) return;
  warp_assemble_packed<kMode>(R0, R1, qs, flow, gi, gj, h, w,
                              M + static_cast<size_t>(gi) * w + gj, static_cast<size_t>(h) * w);
}

// K9's scale pass: qs[c] = max(max |R1[c]|, 1e-20) * fl(1 / qmax), qmax 32767
// for planes 0-1 and 127 for planes 2-4 (ops/farneback.py::corner_scale; XLA
// folds the division into a multiply by the float32 reciprocal).  One block
// per plane takes the maximum of the integer bits of |v| (exact in any
// order, and a NaN's bits exceed every number's, as a NaN wins torch.amax),
// by warps, then over its warps.  Bound: 20 bytes a pixel read once; one
// launch in place of two.  The small levels' planes (at most 40,000 values)
// take a few loads a thread, so a launch's latency sets the time: a cluster
// of 8 blocks a plane, reduced through distributed shared memory, measured
// 0.6-1.0 us slower on the H100 at 60x60 to 97x173 and only 0.15 us faster
// at 200x200 (PERF.md).
__global__ void __launch_bounds__(kScaleThreads)
corner_scale_kernel(const float* __restrict__ R1, float* __restrict__ qs, size_t n) {
  __shared__ unsigned int s_warp[kScaleThreads / kWarpSize];
  const int ch = static_cast<int>(blockIdx.x);
  const unsigned int* x = reinterpret_cast<const unsigned int*>(R1) + ch * n;
  constexpr size_t stride = kScaleThreads;
  size_t i = threadIdx.x;
  unsigned int m = 0;
  for (; i + 3 * stride < n; i += 4 * stride) {
    const unsigned int v0 = __ldg(x + i), v1 = __ldg(x + i + stride);
    const unsigned int v2 = __ldg(x + i + 2 * stride), v3 = __ldg(x + i + 3 * stride);
    m = max(max(m, max(v0 & 0x7fffffffu, v1 & 0x7fffffffu)),
            max(v2 & 0x7fffffffu, v3 & 0x7fffffffu));
  }
  for (; i < n; i += stride) m = max(m, __ldg(x + i) & 0x7fffffffu);
  m = __reduce_max_sync(0xffffffffu, m);
  if (threadIdx.x % kWarpSize == 0) s_warp[threadIdx.x / kWarpSize] = m;
  __syncthreads();
  if (threadIdx.x >= kWarpSize) return;
  const unsigned int b = __reduce_max_sync(0xffffffffu, s_warp[threadIdx.x]);
  if (threadIdx.x == 0) {
    const float absmax = __uint_as_float(b);
    const float clamped = b > 0x7f800000u ? absmax : fmaxf(absmax, 1e-20f);  // a NaN stays
    qs[ch] = clamped * (ch < 2 ? 1.0f / 32767.0f : 1.0f / 127.0f);
  }
}

// K2 and K3's dynamic shared memory: the staged planes, plus the vertical
// pass's scratch and the taps at the runtime radius.
template <int kR, int kTileH = kTile>
size_t window_smem_bytes(int r) {
  const Staged<kR, kTileH> st(r);
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
  win->shared = win->v_int = win->v_pad = win->h_bcast = 0;
  for (int k = 0; k < winsize; ++k) {
    win->w[k] = taps[k];
    for (int j = 0; j < winsize; ++j)
      if (j != k && taps[j] == taps[k] && taps[k] != 0.0f) win->shared |= 1ull << k;
  }
  return true;
}

// The broadcast taps of a window over an h x w level (ops/farneback.py::
// broadcast_taps and gauss_blur5): at two or more rows and three or more
// columns, where an axis is at most the radius, a tap whose slice of the
// edge-padded axis is all padding has its product computed once by XLA; a
// lead of one such tap keeps its product's rounding, and so do the trailing
// ones in the edge columns' vertical sums and in the horizontal sums.  The
// box window's unit taps make every product exact, so it takes none.
void window_broadcast(Window* win, int winsize, int h, int w) {
  bool box = true;
  for (int k = 0; k < winsize; ++k) box = box && win->w[k] == 1.0f;
  if (box || h < 2 || w < 3) return;
  const int r = winsize / 2;
  auto mask = [&](int size, bool trail) {
    unsigned long long out = 0;
    int lead = 0, first = -1;
    for (int k = 0; k < winsize; ++k) {
      if (win->w[k] == 0.0f) continue;
      if (k <= r - size) {
        ++lead;
        if (first < 0) first = k;
      }
      if (trail && k >= r + size) out |= 1ull << k;
    }
    return lead == 1 ? out | 1ull << first : out;
  };
  win->v_int = mask(h, false);
  win->v_pad = mask(h, true);
  win->h_bcast = mask(w, true);
}

// The flow into a warp from the host's arguments; false for a bad mode.
bool flow_from_host(FlowIn* flow, const float* vx, const float* vy, const float* s, float s0,
                    int mode) {
  *flow = FlowIn{vx, vy, s, s0, mode};
  return (mode == 0 || mode == 1 || (mode == 2 && s != nullptr));
}

// Calls launch(radius, box) with the window stage's instance for `win`: the
// compile-time kMainR one for winsize 15 (box when every tap is 1.0f), else the
// runtime-radius one (radius 0), which also takes levels of one row or column,
// windows with a zero tap and a window with broadcast taps (window_broadcast).
// Both are std::integral_constant values.
template <typename Launch>
cudaError_t with_window_instance(const Window& win, int winsize, int h, int w, Launch launch) {
  using Main = std::integral_constant<int, kMainR>;
  using Runtime = std::integral_constant<int, 0>;
  if (winsize != 2 * kMainR + 1 || h == 1 || w == 1 || (win.v_int | win.v_pad | win.h_bcast))
    return launch(Runtime{}, std::false_type{});
  bool box = true;
  for (int k = 0; k < winsize; ++k) {
    if (win.w[k] == 0.0f) return launch(Runtime{}, std::false_type{});
    box = box && win.w[k] == 1.0f;
  }
  return box ? launch(Main{}, std::true_type{}) : launch(Main{}, std::false_type{});
}

// Calls launch(mode) with the flow's mode as a std::integral_constant.
template <typename Launch>
cudaError_t with_flow_mode(int mode, Launch launch) {
  if (mode == 1) return launch(std::integral_constant<int, 1>{});
  if (mode == 2) return launch(std::integral_constant<int, 2>{});
  return launch(std::integral_constant<int, 0>{});
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
// in one wave of kPolyMinBlocks blocks per SM, else 32-row tiles; at a
// narrow width (w + N < kPolyNarrow) the narrow variant, with 16-row tiles.
template <int N>
cudaError_t launch_poly_fixed(float* out, const float* img, int h, int w, const PolyTaps& pt,
                              int device, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  constexpr int kShort = kTile / 2;
  const dim3 short_grid = tile_grid(h, w, kShort);
  if (w + N < kPolyNarrow) {
    poly_exp_fixed_kernel<N, kShort, true><<<short_grid, PolyFixed<N, kShort>::kThreads, 0,
                                             stream>>>(img, out, h, w, vec, pt);
  } else if (static_cast<int>(short_grid.x * short_grid.y) <= kPolyMinBlocks * sms) {
    poly_exp_fixed_kernel<N, kShort, false><<<short_grid, PolyFixed<N, kShort>::kThreads, 0,
                                              stream>>>(img, out, h, w, vec, pt);
  } else {
    poly_exp_fixed_kernel<N, kTile, false><<<tile_grid(h, w), PolyFixed<N, kTile>::kThreads, 0,
                                             stream>>>(img, out, h, w, vec, pt);
  }
  return cudaGetLastError();
}

// K1's taps from the host; false for a poly_n out of range.
bool poly_taps_from_host(PolyTaps* pt, int n, const float* g, const float* xg,
                         const float* xxg, const float* ig) {
  if (n < 1 || n > kMaxPolyN) return false;
  for (int k = 0; k < 2 * n + 1; ++k) {
    pt->g[k] = g[k];
    pt->xg[k] = xg[k];
    pt->xxg[k] = xxg[k];
  }
  for (int k = 0; k < 4; ++k) pt->ig[k] = ig[k];
  return true;
}

// ops/poly_tiny.tiny_program (int32, PROGRAM_INTS) into a TinyProgram,
// checked: the variant count, the tile, kinds, operations (skips past tap
// 2n), and every variant index a sum reads.
bool tiny_program_from_host(TinyProgram* tp, const int* p, int n) {
  tp->nv = p[0];
  tp->tile_rows = p[1];
  tp->tile_cols = p[2];
  if (tp->nv < 1 || tp->nv > kTinyVariants || tp->tile_rows < 1 || tp->tile_cols < 1)
    return false;
  auto op_ok = [n](int op, int k) {
    return op >= kSkip && op <= kAdd && (k <= 2 * n || op == kSkip);
  };
  const int* at = p + 3;
  for (int v = 0; v < kTinyVariants; ++v, at += 1 + kTinyOps) {
    if (at[0] < 0 || at[0] > 2) return false;
    tp->vkind[v] = static_cast<signed char>(at[0]);
    for (int k = 0; k < kTinyOps; ++k) {
      if (!op_ok(at[1 + k], k)) return false;
      tp->vop[v][k] = static_cast<signed char>(at[1 + k]);
    }
  }
  for (int q = 0; q < 7; ++q, at += 5 + 2 * kTinyOps) {
    if (at[0] < 0 || at[0] > 2) return false;
    tp->skind[q] = static_cast<signed char>(at[0]);
    for (int k = 0; k < kTinyOps; ++k) {
      const int fix = at[1 + kTinyOps + k];
      if (!op_ok(at[1 + k], k) || fix < -1 || fix >= tp->nv) return false;
      tp->sop[q][k] = static_cast<signed char>(at[1 + k]);
      tp->sfix[q][k] = static_cast<signed char>(fix);
    }
    for (int f = 0; f < 4; ++f) {
      const int x = at[1 + 2 * kTinyOps + f];
      if (x < 0 || (f < 3 && x >= tp->nv)) return false;
      tp->sv[q][f] = x;
    }
  }
  return true;
}

}  // namespace

extern "C" {

// g, xg, xxg (2n+1 each) and ig (ig11, ig03, ig33, ig55) are HOST pointers.
// Images of at most n rows or columns take the tiny form, datmo_poly_exp_tiny.
int datmo_poly_exp(float* out, const float* img, int h, int w, int n, const float* g,
                   const float* xg, const float* xxg, const float* ig, int device,
                   void* stream) {
  PolyTaps pt{};
  if (h <= n || w <= n || !poly_taps_from_host(&pt, n, g, xg, xxg, ig))
    return cudaErrorInvalidValue;
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const auto s = static_cast<cudaStream_t>(stream);
  if (poly_taps_structural(pt, n)) {
    if (n == 5) return launch_poly_fixed<5>(out, img, h, w, pt, device, s);
    if (n == 7) return launch_poly_fixed<7>(out, img, h, w, pt, device, s);
  }
  poly_exp_kernel<<<tile_grid(h, w), dim3(kBlockX, kBlockY), 0, s>>>(img, out, h, w, n,
                                                                      w + n < kPolyNarrow, pt);
  return cudaGetLastError();
}

// K1's tiny form (h <= n or w <= n).  g, xg, xxg, ig as datmo_poly_exp's;
// program (HOST) is ops/poly_tiny.tiny_program.
int datmo_poly_exp_tiny(float* out, const float* img, int h, int w, int n, const float* g,
                        const float* xg, const float* xxg, const float* ig, const int* program,
                        int device, void* stream) {
  PolyTaps pt{};
  TinyProgram tp{};
  if (h < 1 || w < 1 || (h > n && w > n) || !poly_taps_from_host(&pt, n, g, xg, xxg, ig) ||
      !tiny_program_from_host(&tp, program, n))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * tp.tile_rows *
                      (tp.nv * min(w, tp.tile_cols + 2 * n) + 7 * tp.tile_cols);
  if (smem + sizeof(TinyProgram) + sizeof(float) * 3 * kTinyOps > kTinySmem)
    return cudaErrorInvalidValue;
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const dim3 grid((w + tp.tile_cols - 1) / tp.tile_cols, (h + tp.tile_rows - 1) / tp.tile_rows);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool structural = poly_taps_structural(pt, n);
  if (structural && n == 5) {
    poly_exp_tiny_kernel<5><<<grid, kTinyThreads, smem, s>>>(img, out, h, w, n, pt, tp);
  } else if (structural && n == 7) {
    poly_exp_tiny_kernel<7><<<grid, kTinyThreads, smem, s>>>(img, out, h, w, n, pt, tp);
  } else {
    poly_exp_tiny_kernel<0><<<grid, kTinyThreads, smem, s>>>(img, out, h, w, n, pt, tp);
  }
  return cudaGetLastError();
}

// taps (winsize) is a HOST pointer.  With oidet (else null) the numerators
// go to (odx, ody) and 1 / det to oidet; without it, the flow.
int datmo_blur_solve(float* odx, float* ody, float* oidet, const float* M, int h, int w,
                     const float* taps, int winsize, float scale, int device, void* stream) {
  Window win;
  if (h < 1 || w < 1 || !window_from_host(&win, taps, winsize)) return cudaErrorInvalidValue;
  window_broadcast(&win, winsize, h, w);
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const int r = winsize / 2;
  const bool bcast = (win.v_int | win.v_pad | win.h_bcast) != 0;
  return with_window_instance(win, winsize, h, w, [&](auto radius, auto box) {
    constexpr int kR = decltype(radius)::value;
    constexpr bool kBox = decltype(box)::value;
    auto kernel = blur_solve_kernel<kR, kBox, false>;
    if constexpr (kR == 0) {
      if (bcast) kernel = blur_solve_kernel<0, kBox, true>;
    }
    const size_t smem = window_smem_bytes<kR>(r);
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<tile_grid(h, w), dim3(kBlockX, kBlockY), smem, static_cast<cudaStream_t>(stream)>>>(
        M, odx, ody, oidet, h, w, r, win, scale);
    return cudaGetLastError();
  });
}

// taps (winsize) is a HOST pointer.  The flow in is (vx, vy) (mode 0), times
// s0 (mode 1) or times the plane s (mode 2); oidet as datmo_blur_solve's.
// Refuses the levels that K4 then K2 round otherwise (K3's header): under
// 2 rows or columns, at most kUniformMax of both, or with broadcast taps.
int datmo_fused_iteration(float* odx, float* ody, float* oidet, const float* R0,
                          const float* R1, const float* vx, const float* vy, const float* s,
                          float s0, int mode, int h, int w, const float* taps, int winsize,
                          float scale, int device, void* stream) {
  Window win;
  FlowIn flow;
  if (h < 2 || w < 2 || (h <= kUniformMax && w <= kUniformMax) ||
      !window_from_host(&win, taps, winsize) || !flow_from_host(&flow, vx, vy, s, s0, mode))
    return cudaErrorInvalidValue;
  window_broadcast(&win, winsize, h, w);
  if (win.v_int | win.v_pad | win.h_bcast) return cudaErrorInvalidValue;
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const int r = winsize / 2;
  const bool small = h < kFusedMinH || w < kFusedMinW;
  return with_window_instance(win, winsize, h, w, [&](auto radius, auto box) {
    return with_flow_mode(mode, [&](auto flow_mode) {
      constexpr int kR = decltype(radius)::value;
      constexpr bool kBox = decltype(box)::value;
      constexpr int kMode = decltype(flow_mode)::value;
      auto launch = [&](auto kernel, int tile_h, size_t smem) {
        cudaError_t err = set_smem(kernel, smem);
        if (err != cudaSuccess) return err;
        kernel<<<tile_grid(h, w, tile_h), dim3(kBlockX, kBlockY), smem,
                 static_cast<cudaStream_t>(stream)>>>(R0, R1, flow, odx, ody, oidet, h, w, r,
                                                      win, scale);
        return cudaGetLastError();
      };
      if constexpr (kR > 0) {
        if (small)
          return launch(fused_iteration_kernel<kR, kBox, kMode, kSmallTileH>, kSmallTileH,
                        window_smem_bytes<kR, kSmallTileH>(r));
      }
      return launch(fused_iteration_kernel<kR, kBox, kMode>, kTile, window_smem_bytes<kR>(r));
    });
  });
}

// All pointers are DEVICE pointers; the flow as datmo_fused_iteration's.  R0,
// the flow and M are the h rows from `start` of a grid of `total` rows, R1
// holds `halo` more rows above and below them; `sharded` for a rank's block of
// the row-sharded flow (a whole level: 0, 0, h, 0).
int datmo_warp_matrices(float* M, const float* R0, const float* R1, const float* vx,
                        const float* vy, const float* s, float s0, int mode, int h, int w,
                        int start, int halo, int total, int sharded, int device,
                        void* stream) {
  FlowIn flow;
  if (h < 1 || w < 1 || start < 0 || halo < 0 || start + h > total ||
      !flow_from_host(&flow, vx, vy, s, s0, mode))
    return cudaErrorInvalidValue;
  const Rows rows{start, halo, h + 2 * halo, total, sharded != 0};
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const size_t n = static_cast<size_t>(h) * w;
  const unsigned int blocks = static_cast<unsigned int>((n + kPixelThreads - 1) / kPixelThreads);
  const bool uniform = !rows.sharded && h * w > 1 && h <= kUniformMax && w <= kUniformMax;
  return with_flow_mode(mode, [&](auto flow_mode) {
    constexpr int kFlowMode = decltype(flow_mode)::value;
    const auto kernel = uniform ? warp_matrices_kernel<kFlowMode, true>
                                : warp_matrices_kernel<kFlowMode, false>;
    kernel<<<blocks, kPixelThreads, 0, static_cast<cudaStream_t>(stream)>>>(R0, R1, flow, rows, M,
                                                                           h, w);
    return cudaGetLastError();
  });
}

// All pointers are DEVICE pointers: R0 and R1 (5, h, w), qs (5) the planes'
// scales (datmo_corner_scale); the flow as datmo_fused_iteration's.
int datmo_warp_packed(float* M, const float* R0, const float* R1, const float* qs,
                      const float* vx, const float* vy, const float* s, float s0, int mode,
                      int h, int w, int device, void* stream) {
  FlowIn flow;
  if (h < 1 || w < 1 || !flow_from_host(&flow, vx, vy, s, s0, mode))
    return cudaErrorInvalidValue;
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const dim3 grid((w + kWarpSize - 1) / kWarpSize, (h + kPackedRows - 1) / kPackedRows);
  return with_flow_mode(mode, [&](auto flow_mode) {
    warp_packed_kernel<decltype(flow_mode)::value>
        <<<grid, dim3(kWarpSize, kPackedRows), 0, static_cast<cudaStream_t>(stream)>>>(
            R0, R1, qs, flow, M, h, w);
    return cudaGetLastError();
  });
}

// All pointers are DEVICE pointers: qs (5) out, R1 (5, h, w) in.
int datmo_corner_scale(float* qs, const float* R1, int h, int w, int device, void* stream) {
  if (h < 1 || w < 1) return cudaErrorInvalidValue;
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  corner_scale_kernel<<<5, kScaleThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      R1, qs, static_cast<size_t>(h) * w);
  return cudaGetLastError();
}

const char* datmo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
