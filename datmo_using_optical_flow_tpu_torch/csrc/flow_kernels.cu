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
// 32x32 output tile (blockDim 32x8, four rows per thread) and stage the tile plus
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
// Each C entry point launches on the stream it is given and returns
// cudaGetLastError(); the Python wrapper raises when that is not cudaSuccess.

#include <cuda_runtime.h>

#include <cstddef>

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

// Window sum of the five staged M planes, then the per-pixel 2x2 solve.
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
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int i = y0 + threadIdx.y + q * kBlockY;
    const int j = x0 + threadIdx.x;
    if (i < h && j < w) {
      const float g11 = acc[q][0] * scale;
      const float g12 = acc[q][1] * scale;
      const float g22 = acc[q][2] * scale;
      const float h1 = acc[q][3] * scale;
      const float h2 = acc[q][4] * scale;
      const float idet = 1.0f / (g11 * g22 - g12 * g12 + 1e-3f);
      odx[static_cast<size_t>(i) * w + j] = (g11 * h2 - g12 * h1) * idet;
      ody[static_cast<size_t>(i) * w + j] = (g22 * h1 - g12 * h2) * idet;
    }
  }
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
// dominates at 1080p.  Tiling: the block reads its 32x32 tile plus an n-pixel
// halo once into shared memory (edge-clamped, which is the plain version's edge
// padding of the image and of the row planes), keeps the three vertical
// correlations there, and writes only the five planes.  Skip rules as the plain
// version: xg's zero centre tap is skipped in the vertical pass, xxg's is kept;
// horizontal taps that are zero in float32 are skipped.
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
__global__ void __launch_bounds__(kBlockX * kBlockY)
blur_solve_kernel(const float* __restrict__ M, float* __restrict__ odx,
                  float* __restrict__ ody, int h, int w, int r, Window win, float scale) {
  extern __shared__ float smem[];
  const int e = kTile + 2 * r;
  float* ms = smem;
  float* vbuf = ms + 5 * e * e;
  float* taps = vbuf + kTile * e;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const size_t plane = static_cast<size_t>(h) * w;
  load_taps(taps, win, 2 * r + 1);
  for (int idx = tid; idx < e * e; idx += nthreads) {
    const int li = idx / e;
    const int lj = idx - li * e;
    const int gi = clampi(y0 - r + li, 0, h - 1);
    const int gj = clampi(x0 - r + lj, 0, w - 1);
    const size_t p = static_cast<size_t>(gi) * w + gj;
    for (int c = 0; c < 5; ++c) ms[c * e * e + idx] = M[c * plane + p];
  }
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
// winsize 15) is counted, so it leans compute- and shared-memory-bound.
// Tiling: the block computes M for its 32x32 tile plus a (win//2) halo into
// shared memory (42 KB at winsize 15; dynamic shared memory above 48 KB),
// M at a halo position outside the image is M at the clamped pixel, then the
// window sum and solve run from shared memory as in K2.
__global__ void __launch_bounds__(kBlockX * kBlockY)
fused_iteration_kernel(const float* __restrict__ R0, const float* __restrict__ R1,
                       const float* __restrict__ dx, const float* __restrict__ dy,
                       float* __restrict__ odx, float* __restrict__ ody, int h, int w,
                       int r, Window win, float scale) {
  extern __shared__ float smem[];
  const int e = kTile + 2 * r;
  float* ms = smem;
  float* vbuf = ms + 5 * e * e;
  float* taps = vbuf + kTile * e;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  load_taps(taps, win, 2 * r + 1);
  for (int idx = tid; idx < e * e; idx += nthreads) {
    const int li = idx / e;
    const int lj = idx - li * e;
    const int gi = clampi(y0 - r + li, 0, h - 1);
    const int gj = clampi(x0 - r + lj, 0, w - 1);
    warp_assemble(R0, R1, dx, dy, gi, gj, h, w, ms + idx, static_cast<size_t>(e) * e);
  }
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

size_t window_smem_bytes(int r) {
  const int e = kTile + 2 * r;
  return sizeof(float) * (5 * static_cast<size_t>(e) * e + kTile * e + kMaxTaps);
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

dim3 tile_grid(int h, int w) { return dim3((w + kTile - 1) / kTile, (h + kTile - 1) / kTile); }

}  // namespace

extern "C" {

// g, xg, xxg (2n+1 each) and ig (ig11, ig03, ig33, ig55) are HOST pointers.
int datmo_poly_exp(float* out, const float* img, int h, int w, int n, const float* g,
                   const float* xg, const float* xxg, const float* ig, void* stream) {
  if (h < 1 || w < 1 || n < 1 || n > kMaxPolyN) return cudaErrorInvalidValue;
  PolyTaps pt{};
  for (int k = 0; k < 2 * n + 1; ++k) {
    pt.g[k] = g[k];
    pt.xg[k] = xg[k];
    pt.xxg[k] = xxg[k];
  }
  for (int k = 0; k < 4; ++k) pt.ig[k] = ig[k];
  poly_exp_kernel<<<tile_grid(h, w), dim3(kBlockX, kBlockY), 0,
                    static_cast<cudaStream_t>(stream)>>>(img, out, h, w, n, pt);
  return cudaGetLastError();
}

// taps (winsize) is a HOST pointer.
int datmo_blur_solve(float* odx, float* ody, const float* M, int h, int w,
                     const float* taps, int winsize, float scale, void* stream) {
  Window win;
  if (h < 1 || w < 1 || !window_from_host(&win, taps, winsize)) return cudaErrorInvalidValue;
  const int r = winsize / 2;
  const size_t smem = window_smem_bytes(r);
  cudaError_t err = set_smem(blur_solve_kernel, smem);
  if (err != cudaSuccess) return err;
  blur_solve_kernel<<<tile_grid(h, w), dim3(kBlockX, kBlockY), smem,
                      static_cast<cudaStream_t>(stream)>>>(M, odx, ody, h, w, r, win, scale);
  return cudaGetLastError();
}

// taps (winsize) is a HOST pointer.
int datmo_fused_iteration(float* odx, float* ody, const float* R0, const float* R1,
                          const float* dx, const float* dy, int h, int w,
                          const float* taps, int winsize, float scale, void* stream) {
  Window win;
  if (h < 2 || w < 2 || !window_from_host(&win, taps, winsize)) return cudaErrorInvalidValue;
  const int r = winsize / 2;
  const size_t smem = window_smem_bytes(r);
  cudaError_t err = set_smem(fused_iteration_kernel, smem);
  if (err != cudaSuccess) return err;
  fused_iteration_kernel<<<tile_grid(h, w), dim3(kBlockX, kBlockY), smem,
                           static_cast<cudaStream_t>(stream)>>>(R0, R1, dx, dy, odx, ody, h,
                                                                w, r, win, scale);
  return cudaGetLastError();
}

// All pointers are DEVICE pointers.
int datmo_warp_matrices(float* M, const float* R0, const float* R1, const float* dx,
                        const float* dy, int h, int w, void* stream) {
  if (h < 2 || w < 2) return cudaErrorInvalidValue;
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
