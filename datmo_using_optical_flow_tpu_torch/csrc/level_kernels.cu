// K8: the pyramid's level images and the flow's bilinear upsample for Hopper
// (sm_90a), with a plain C interface.
//
//   datmo_level_images <- every level image of one frame in one launch: cv2's
//                         pre-blur then the bilinear resize (at the image's
//                         own size, the blur alone); one level for the
//                         per-level callers
//   datmo_resize       <- the bilinear resize of planes taken in pairs (the
//                         flow's dx and dy from two pointers, or a (..., H, W)
//                         stack), times a scale
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
// equals its plain version (ops/farneback.py: level_images_reference,
// level_image_reference, gaussian_blur_reference, resize_bilinear_reference)
// bit for bit.
//
// Bound: the bytes.  A frame's level images read the image once and write
// every level once; the arithmetic, with the blur evaluated only where the
// resize reads it, is a few instructions per source value
// (diagnostics/roofline.py: level_images).
//
// Design.  level_images_kernel runs a grouped grid: a tile table, built and
// uploaded once per shape by ops/level_kernels.py (level_plan), maps each
// block to one level and one rectangle of its outputs.  Tiles of every level
// run side by side in one launch, the most work per tile first, so the coarse
// levels' long chains overlap level 0's streaming.  Per tile, all in shared
// memory, no scratch in device memory:
//   1. where the tile's source window fits the plan's stage budget (level 0
//      and the fine levels), the window is copied in with cp.async
//      (__pipeline_memcpy_async; 16 bytes a copy where the window lies
//      inside the image, the plan aligning it to 4 values), reflect-101
//      applied as it is staged, so the window is indexed by padded positions
//      and no chain reflects again;
//   2. the vertical chains at the source rows the tile's outputs read, over
//      the padded columns its horizontal chains read, each computed once per
//      tile: a resized level's rows y0 and y1 = y0 + 1 as one pair of
//      interleaved chains that share their loads (chain2), a blur's four
//      neighbouring rows as four (chain4); from the window or, for a coarse
//      level whose window would be too large, straight from device memory,
//      each thread walking down kIlp columns at once so that kIlp loads are
//      in flight a tap (the image is L2-resident: 8.3 MB at 1080p against
//      50 MB of L2);
//   3. the horizontal chains (again chain2 at x0 and x1 = x0 + 1, chain4 for
//      a blur's four neighbouring outputs, stored as one 16-byte store) and
//      both lerps, from those chains.
// Tile shapes (level_plan): 32 x 128 outputs for a blur and up to 16 x 32 for
// a resized level, fewer rows until the level has two tiles per SM.  The
// largest dynamic footprint over the 1080p, from-points, 4K (91 taps) and
// 720p pyramids is 42,112 bytes (a staged tile of the 97x173 level; 640
// more of static taps), under the 48 KB of static reach, so
// cudaFuncSetAttribute runs only for a caller's shape whose plan asks for
// more.  __launch_bounds__(256, 4) holds the kernel to 64 registers: four
// blocks an SM, whichever path a block takes.
//
// resize_kernel: a block takes 8 output rows by 128 columns of one pair of
// planes, its int32 row and column tables in shared memory; each thread
// computes 4 adjacent outputs of both planes, reading its column tables once
// for both, and stores each plane's 4 as one 16-byte store where the row
// allows it (width % 4 == 0).  The source rows it reads are L2-resident and
// each value is read by several outputs through L1, so they are read from
// device memory: staged in shared memory they took longer.
//
// Each C entry point makes the given device current (device_guard.cuh),
// launches on the stream it is given and returns cudaGetLastError(); the
// Python wrapper (ops/level_kernels.py) raises when that is not cudaSuccess.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 127;  // the largest odd ksize taken (4K's last level: 91)
// The plan's layout (ops/level_kernels.py: TILE_INTS, LEVEL_INTS, the flags):
// tiles of kTileInts, then levels of kLevelInts, then the tables they name.
constexpr int kTileInts = 10;   // level, r0, nr, q0, nq, pc0, npc, ps0, nps, 0
constexpr int kLevelInts = 10;  // lh, lw, out, taps, count, rows, cols, wy, wx, flags
constexpr int kResize = 1;      // the level is resized (else the blur alone)
constexpr int kOneRow = 2;      // the image has one row: chain_one vertically
constexpr int kOneCol = 4;      // ... one column: chain_one horizontally
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use
constexpr int kStaticSmem = 5 * kMaxTaps;  // the taps, below; rounded up in Python

// The nonzero taps of a blur, ascending and contiguous (a Gaussian's taps
// are zero, where float32 underflows, only at its tails; ops/level_kernels.py
// checks it), in shared memory: the first one's offset from the centre, the
// weights, and whether another tap has the same weight.
struct Taps {
  int count;
  int lo;
  const float* w;
  const unsigned char* shared;
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
__device__ __forceinline__ float chain_one(const Taps& t, float x) {
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

// The correlation at padded position p of a line (load(q) reads padded
// position q), rounded as the compiled chain is.
template <typename Load>
__device__ __forceinline__ float chain(const Taps& t, int p, Load load) {
  const int p0 = p + t.lo;
  if (t.count == 1) return __fmul_rn(t.w[0], load(p0));
  float acc = __fmaf_rn(load(p0), t.w[0], __fmul_rn(t.w[1], load(p0 + 1)));
#pragma unroll 4
  for (int k = 2; k < t.count; ++k) acc = __fmaf_rn(load(p0 + k), t.w[k], acc);
  return acc;
}

// The chains at p and p + 1 together (a resize reads positions i0 and
// i0 + 1), each value loaded once for both and the two chains interleaved.
template <typename Load>
__device__ __forceinline__ void chain2(const Taps& t, int p, Load load, float& a0, float& a1) {
  const int p0 = p + t.lo;
  const float x = load(p0), y = load(p0 + 1);
  if (t.count == 1) {
    a0 = __fmul_rn(t.w[0], x);
    a1 = __fmul_rn(t.w[0], y);
    return;
  }
  float z = load(p0 + 2);
  a0 = __fmaf_rn(x, t.w[0], __fmul_rn(t.w[1], y));
  a1 = __fmaf_rn(y, t.w[0], __fmul_rn(t.w[1], z));
#pragma unroll 4
  for (int k = 2; k < t.count; ++k) {
    const float u = load(p0 + k + 1);
    a0 = __fmaf_rn(z, t.w[k], a0);
    a1 = __fmaf_rn(u, t.w[k], a1);
    z = u;
  }
}

// The chains at p, p + 1, p + 2 and p + 3 together (a blur's neighbouring
// outputs), each value loaded once for all four.
template <typename Load>
__device__ __forceinline__ void chain4(const Taps& t, int p, Load load, float (&a)[4]) {
  const int p0 = p + t.lo;
  float z0 = load(p0), z1 = load(p0 + 1), z2 = load(p0 + 2), z3 = load(p0 + 3);
  if (t.count == 1) {
    a[0] = __fmul_rn(t.w[0], z0);
    a[1] = __fmul_rn(t.w[0], z1);
    a[2] = __fmul_rn(t.w[0], z2);
    a[3] = __fmul_rn(t.w[0], z3);
    return;
  }
  const float z4 = load(p0 + 4);
  a[0] = __fmaf_rn(z0, t.w[0], __fmul_rn(t.w[1], z1));
  a[1] = __fmaf_rn(z1, t.w[0], __fmul_rn(t.w[1], z2));
  a[2] = __fmaf_rn(z2, t.w[0], __fmul_rn(t.w[1], z3));
  a[3] = __fmaf_rn(z3, t.w[0], __fmul_rn(t.w[1], z4));
  z0 = z2;
  z1 = z3;
  z2 = z4;
#pragma unroll 4
  for (int k = 2; k < t.count; ++k) {
    const float u = load(p0 + k + 3), wk = t.w[k];
    a[0] = __fmaf_rn(z0, wk, a[0]);
    a[1] = __fmaf_rn(z1, wk, a[1]);
    a[2] = __fmaf_rn(z2, wk, a[2]);
    a[3] = __fmaf_rn(u, wk, a[3]);
    z0 = z1;
    z1 = z2;
    z2 = u;
  }
}

constexpr int kIlp = 2;  // columns a thread walks at once from device memory

// The paired vertical chains (rows y and y + 1) at kIlp columns at once,
// from device memory: the coarse levels' long chains, with kIlp loads in
// flight a tap.  at(p) is the offset of padded row p, col[m] the columns
// (valid[m] false: not computed).
template <typename At>
__device__ __forceinline__ void chain2_cols(const Taps& t, int y, At at,
                                            const float* const (&col)[kIlp],
                                            const bool (&valid)[kIlp], float (&a)[kIlp],
                                            float (&b)[kIlp]) {
  const int p0 = y + t.lo;
  float x[kIlp], z[kIlp];
  const int64_t o0 = at(p0), o1 = at(p0 + 1);
#pragma unroll
  for (int m = 0; m < kIlp; ++m) {
    x[m] = valid[m] ? __ldg(col[m] + o0) : 0.0f;
    z[m] = valid[m] ? __ldg(col[m] + o1) : 0.0f;
  }
  if (t.count == 1) {
#pragma unroll
    for (int m = 0; m < kIlp; ++m) {
      a[m] = __fmul_rn(t.w[0], x[m]);
      b[m] = __fmul_rn(t.w[0], z[m]);
    }
    return;
  }
  const int64_t o2 = at(p0 + 2);
#pragma unroll
  for (int m = 0; m < kIlp; ++m) {
    const float u = valid[m] ? __ldg(col[m] + o2) : 0.0f;
    a[m] = __fmaf_rn(x[m], t.w[0], __fmul_rn(t.w[1], z[m]));
    b[m] = __fmaf_rn(z[m], t.w[0], __fmul_rn(t.w[1], u));
    z[m] = u;
  }
#pragma unroll 8  // the loads of 8 taps in flight: the chain waits on device memory
  for (int k = 2; k < t.count; ++k) {
    const int64_t ok = at(p0 + k + 1);
    const float wk = t.w[k];
#pragma unroll
    for (int m = 0; m < kIlp; ++m) {
      const float u = valid[m] ? __ldg(col[m] + ok) : 0.0f;
      a[m] = __fmaf_rn(z[m], wk, a[m]);
      b[m] = __fmaf_rn(u, wk, b[m]);
      z[m] = u;
    }
  }
}

// The vertical chain at row y (and at y + 1 into b when paired).
template <typename Load>
__device__ __forceinline__ void vertical(const Taps& t, bool one_row, bool pair, int y, Load load,
                                         float& a, float& b) {
  if (one_row) {
    a = b = chain_one(t, load(y));
  } else if (pair) {
    chain2(t, y, load, a, b);
  } else {
    a = chain(t, y, load);
  }
}

// f(j, c) for every (j, c) of a rows x cols grid in row-major order, the
// block's threads taking every kThreads-th pair: one division a call, none a
// pair.
template <typename F>
__device__ __forceinline__ void for_each_row_major(int rows, int cols, F f) {
  const int dj = kThreads / cols, dc = kThreads - dj * cols;
  int j = threadIdx.x / cols, c = threadIdx.x - j * cols;
  while (j < rows) {
    f(j, c);
    j += dj;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++j;
    }
  }
}

// fma(a, 1 - w, b * w): one axis of the resize.
__device__ __forceinline__ float lerp(float a, float b, float w) {
  return __fmaf_rn(a, __fsub_rn(1.0f, w), __fmul_rn(b, w));
}

// Every level image of img (h, w) that the plan's tiles name, into out.
// Grid: one block per tile; dynamic shared memory: the plan's largest tile.
__global__ void __launch_bounds__(kThreads, 4)  // 64 registers: four blocks an SM
level_images_kernel(float* __restrict__ out, const float* __restrict__ img, int h, int w,
                    const int* __restrict__ plan, int ntiles) {
  extern __shared__ float smem[];
  __shared__ float s_w[kMaxTaps];
  __shared__ unsigned char s_shared[kMaxTaps];

  const int* tile = plan + static_cast<int64_t>(blockIdx.x) * kTileInts;
  const int r0 = tile[1], nr = tile[2], q0 = tile[3], nq = tile[4];
  const int pc0 = tile[5], npc = tile[6], ps0 = tile[7], nps = tile[8];
  float* S = smem;               // (nps, npc): the source window, when staged
  float* V = smem + nps * npc;   // (nv, npc): the vertical chains, y0 rows then y1 rows
  if (nps > 0) {  // in flight while the level and its taps are read
    if (pc0 >= 0 && pc0 + npc <= w && w % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0) {
      // columns inside the image: 16-byte copies (the plan aligns pc0 and
      // npc to 4 values)
      for_each_row_major(nps, npc / 4, [&](int a, int k) {
        __pipeline_memcpy_async(
            S + a * npc + 4 * k,
            img + static_cast<int64_t>(reflect101(ps0 + a, h)) * w + pc0 + 4 * k,
            4 * sizeof(float));
      });
    } else {
      for_each_row_major(nps, npc, [&](int a, int c) {
        __pipeline_memcpy_async(
            S + a * npc + c,
            img + static_cast<int64_t>(reflect101(ps0 + a, h)) * w + reflect101(pc0 + c, w),
            sizeof(float));
      });
    }
    __pipeline_commit();
  }
  const int* lv = plan + static_cast<int64_t>(ntiles) * kTileInts + tile[0] * kLevelInts;
  const int lh = lv[0], lw = lv[1], count = lv[4], flags = lv[9];
  const int* taps = plan + lv[3];  // offsets, weight bits, shared flags
  for (int k = threadIdx.x; k < count; k += kThreads) {
    s_w[k] = __int_as_float(taps[count + k]);
    s_shared[k] = static_cast<unsigned char>(taps[2 * count + k]);
  }
  const bool resize = flags & kResize, one_row = flags & kOneRow, one_col = flags & kOneCol;
  const int nv = resize ? 2 * nr : nr;
  if (nps > 0) __pipeline_wait_prior(0);
  __syncthreads();  // the taps and the window
  const Taps t{count, taps[0], s_w, s_shared};
  const int* rows = plan + lv[5];  // y0 (lh values), then y1 (lh): y1 = y0 + 1 when h > 1

  // a resized level's rows y0 and y1 = y0 + 1 of one column in one item; a
  // blur's four neighbouring rows
  const bool pair_rows = resize && !one_row;
  const int reach = t.lo + count - 1 + (pair_rows ? 1 : 0);  // the last row read, from y
  auto item = [&](int j, int c) {
    const int y = !resize ? r0 + j : rows[j < nr ? r0 + j : lh + r0 + j - nr];
    float a, b;
    if (nps > 0) {
      const float* col = S + c;
      vertical(t, one_row, pair_rows, y, [&](int p) { return col[(p - ps0) * npc]; }, a, b);
    } else {
      const float* col = img + reflect101(pc0 + c, w);
      if (one_row || (y + t.lo >= 0 && y + reach < h)) {
        vertical(t, one_row, pair_rows, y,
                 [&](int p) { return __ldg(col + static_cast<int64_t>(p) * w); }, a, b);
      } else {
        vertical(t, one_row, pair_rows, y, [&](int p) {
          return __ldg(col + static_cast<int64_t>(reflect101(p, h)) * w);
        }, a, b);
      }
    }
    V[j * npc + c] = a;
    if (pair_rows) V[(nr + j) * npc + c] = b;
  };
  if (!resize && !one_row && nps > 0) {
    for_each_row_major((nr + 3) / 4, npc, [&](int g, int c) {
      if (4 * g + 4 > nr) {
        for (int j = 4 * g; j < nr; ++j) item(j, c);
        return;
      }
      const float* col = S + c;
      float a[4];
      chain4(t, r0 + 4 * g, [&](int p) { return col[(p - ps0) * npc]; }, a);
      for (int m = 0; m < 4; ++m) V[(4 * g + m) * npc + c] = a[m];
    });
  } else if (pair_rows && nps == 0) {
    // from device memory: a thread walks down kIlp columns at once, whose
    // rows the next chain reads again while they are in L1
    for (int c = threadIdx.x; c < npc; c += kIlp * kThreads) {
      const float* col[kIlp];
      bool valid[kIlp];
#pragma unroll
      for (int m = 0; m < kIlp; ++m) {
        valid[m] = c + m * kThreads < npc;
        col[m] = img + reflect101(pc0 + (valid[m] ? c + m * kThreads : c), w);
      }
      for (int j = 0; j < nr; ++j) {
        const int y = rows[r0 + j];
        float a[kIlp], b[kIlp];
        if (y + t.lo >= 0 && y + reach < h) {
          chain2_cols(t, y, [&](int p) { return static_cast<int64_t>(p) * w; }, col, valid, a, b);
        } else {
          chain2_cols(t, y, [&](int p) { return static_cast<int64_t>(reflect101(p, h)) * w; },
                      col, valid, a, b);
        }
#pragma unroll
        for (int m = 0; m < kIlp; ++m) {
          if (valid[m]) {
            V[j * npc + c + m * kThreads] = a[m];
            V[(nr + j) * npc + c + m * kThreads] = b[m];
          }
        }
      }
    }
  } else {
    for_each_row_major(pair_rows ? nr : nv, npc, item);
  }
  __syncthreads();

  // the horizontal chain of V row j at padded column c
  auto hchain = [&](int j, int c) {
    const float* row = V + j * npc;
    if (one_col) return chain_one(t, row[c - pc0]);
    return chain(t, c, [&](int p) { return row[p - pc0]; });
  };
  float* dst = out + lv[2];
  const int* cols = plan + lv[6];  // x0 (lw values), then x1 (lw): x1 = x0 + 1 when w > 1
  const int* wy = plan + lv[7];
  const int* wx = plan + lv[8];
  if (!resize && !one_col) {  // a blur: four neighbouring outputs an item
    const bool vec = lw % 4 == 0;  // the level's offset and q0 are multiples of 4
    for_each_row_major(nr, (nq + 3) / 4, [&](int rr, int g) {
      const int r = r0 + rr, q = q0 + 4 * g;
      float* o = dst + static_cast<int64_t>(r) * lw + q;
      if (q + 4 > q0 + nq) {
        for (int k = 0; q + k < q0 + nq; ++k) o[k] = hchain(rr, q + k);
        return;
      }
      const float* row = V + rr * npc;
      float a[4];
      chain4(t, q, [&](int p) { return row[p - pc0]; }, a);
      if (vec) {
        *reinterpret_cast<float4*>(o) = make_float4(a[0], a[1], a[2], a[3]);
      } else {
        for (int k = 0; k < 4; ++k) o[k] = a[k];
      }
    });
    return;
  }
  for_each_row_major(nr, nq, [&](int rr, int qq) {
    const int r = r0 + rr, q = q0 + qq;
    float o;
    if (!resize) {
      o = hchain(rr, q);
    } else {
      const int c0 = cols[q];
      const float wr = __int_as_float(wy[r]);
      float a0, a1, b0, b1;  // rows y0 and y1 at columns x0 and x1
      if (one_col) {
        a0 = a1 = hchain(rr, c0);
        b0 = b1 = hchain(nr + rr, c0);
      } else {
        const float* ra = V + rr * npc;
        const float* rb = V + (nr + rr) * npc;
        chain2(t, c0, [&](int p) { return ra[p - pc0]; }, a0, a1);
        chain2(t, c0, [&](int p) { return rb[p - pc0]; }, b0, b1);
      }
      o = lerp(lerp(a0, b0, wr), lerp(a1, b1, wr), __int_as_float(wx[q]));
    }
    dst[static_cast<int64_t>(r) * lw + q] = o;
  });
}

constexpr int kRows = 8;      // a resize block's output rows
constexpr int kCols = 128;    // ... and columns: 32 threads a row, 4 outputs each

// out (planes, oh, ow) = the bilinear resize of planes (h, w), times scale
// unless it is 1: plane 2k from a + k * pair_stride, plane 2k + 1 from b + k *
// pair_stride.  table: int32 y0, y1 (oh each), x0, x1 (ow each), then the
// float32 bits of wy (oh) and wx (ow).  Grid: (column blocks, row blocks,
// pairs of planes).
__global__ void __launch_bounds__(kThreads)
resize_kernel(float* __restrict__ out, const float* __restrict__ a, const float* __restrict__ b,
              int64_t pair_stride, int planes, int h, int w, int oh, int ow,
              const int* __restrict__ table, float scale) {
  __shared__ int sy[2][kRows];
  __shared__ float swy[kRows];
  __shared__ int sx[2][kCols];
  __shared__ float swx[kCols];
  const int r0 = blockIdx.y * kRows, q0 = blockIdx.x * kCols;
  const int nr = min(kRows, oh - r0), nq = min(kCols, ow - q0);
  const int64_t pair = blockIdx.z;
  const int np = 2 * pair + 1 < planes ? 2 : 1;
  const float* src[2] = {a + pair * pair_stride, b + pair * pair_stride};
  for (int i = threadIdx.x; i < nq; i += kThreads) {
    sx[0][i] = table[2 * oh + q0 + i];
    sx[1][i] = table[2 * oh + ow + q0 + i];
    swx[i] = __int_as_float(table[2 * oh + 2 * ow + oh + q0 + i]);
  }
  if (threadIdx.x < nr) {
    sy[0][threadIdx.x] = table[r0 + threadIdx.x];
    sy[1][threadIdx.x] = table[oh + r0 + threadIdx.x];
    swy[threadIdx.x] = __int_as_float(table[2 * oh + 2 * ow + r0 + threadIdx.x]);
  }
  __syncthreads();
  const int rr = threadIdx.x / 32, qq = 4 * (threadIdx.x % 32);
  if (rr >= nr || qq >= nq) return;
  const int y0 = sy[0][rr], y1 = sy[1][rr];
  const float wr = swy[rr];
  const int n = min(4, nq - qq);
  float o[2][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k < n) {
      const int c0 = sx[0][qq + k], c1 = sx[1][qq + k];
      const float wc = swx[qq + k];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (p < np) {
          const float* ra = src[p] + static_cast<int64_t>(y0) * w;
          const float* rb = src[p] + static_cast<int64_t>(y1) * w;
          const float v0 = lerp(__ldg(ra + c0), __ldg(rb + c0), wr);
          const float v1 = lerp(__ldg(ra + c1), __ldg(rb + c1), wr);
          const float v = lerp(v0, v1, wc);
          o[p][k] = scale == 1.0f ? v : __fmul_rn(v, scale);
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if (p >= np) break;
    float* dst = out + ((2 * pair + p) * oh + r0 + rr) * static_cast<int64_t>(ow) + q0 + qq;
    if (n == 4 && ow % 4 == 0) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[p][0], o[p][1], o[p][2], o[p][3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < n) dst[k] = o[p][k];
    }
  }
}

constexpr int kMaxGrid = 65535;  // gridDim.y and gridDim.z

}  // namespace

extern "C" {

// out and img are DEVICE pointers to float32, img (h, w); plan a DEVICE int32
// array of ntiles tiles, their levels and tables (ops/level_kernels.py:
// level_plan), whose every level's image goes to out at its offset; smem the
// plan's bytes of dynamic shared memory a block.
int datmo_level_images(float* out, const float* img, int h, int w, const int* plan,
                       int ntiles, int smem, int device, void* stream) {
  if (h < 1 || w < 1 || ntiles < 1 || smem < 0 || smem + kStaticSmem > kMaxSmem)
    return cudaErrorInvalidValue;
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        level_images_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  level_images_kernel<<<ntiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      out, img, h, w, plan, ntiles);
  return cudaGetLastError();
}

// out (planes, oh, ow), a and b are DEVICE pointers to float32 (see
// resize_kernel for which planes a and b name); table a DEVICE int32 array
// as resize_kernel reads it (ops/level_kernels.py: resize_plan).
int datmo_resize(float* out, const float* a, const float* b, int64_t pair_stride, int planes,
                 int h, int w, int oh, int ow, const int* table, float scale, int device,
                 void* stream) {
  if (planes < 1 || h < 1 || w < 1 || oh < 1 || ow < 1 || (planes + 1) / 2 > kMaxGrid ||
      (oh + kRows - 1) / kRows > kMaxGrid || (planes > 1 && b == nullptr))
    return cudaErrorInvalidValue;
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const dim3 grid((ow + kCols - 1) / kCols, (oh + kRows - 1) / kRows, (planes + 1) / 2);
  resize_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, a, b, pair_stride, planes, h, w, oh, ow, table, scale);
  return cudaGetLastError();
}

}  // extern "C"
