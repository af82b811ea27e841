// Exact 1-NN sweep with spatial tile pruning for Hopper (sm_90a), plain C interface.
//
//   nn_sweep_kernel  <- ops/nn_pallas.py::nearest_neighbors_pallas (_kernel, _kernel_body)
//
// Held to its plain PyTorch version, ops/nn_kernels.py::_sweep_reference, which
// does the same float32 operations in the same order.
//
// Design.  One CTA per 256-row source block, one thread per row.  The block's
// row of the pruning table (squared lower bounds, ascending, and the matching
// tile order) is read from global memory one entry per visited tile.  Each
// visited tile's 256 targets are staged in shared memory, recentred on the
// block's row 0 once per tile, and every thread then scans them for its own row
// (broadcast reads).  The block stops at the first tile whose bound exceeds
// bmax = min(max over the block's rows of the running best, cap2); bmax is a
// CTA-wide max, taken with warp shuffles and a shared-memory pass, so every
// thread takes the same break.  A block whose active count is 0 writes the
// constant outputs and exits.
//
// Bound on this card: the scan is ~12 float32 operations per (row, target)
// pair with -fmad=false, with no tensor cores (the distances must be exact
// float32: TF32 would move winners at the 0.02 m ICP gate), so the time is the
// number of tiles the pruning leaves each block.  Staging a tile costs one
// coalesced 20-byte-per-thread load.
//
// Arithmetic is the plain version's: sn = (sx*sx + sy*sy) + sz*sz, the same for
// the recentred target norm, cross = (sx*tx + sy*ty) + sz*tz, d2 = tn - 2*cross
// (sn added back after the reductions).  Ties go to the lowest original index;
// min, max and counts are exact in any order.  The library is built with
// -fmad=false (kernels/build.py), so kernel and plain version agree bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;       // source rows per CTA == targets per tile
constexpr int kWarps = kBlock / 32;
constexpr int kBigI = 1 << 30;
constexpr float kHuge = 3e38f;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Max over the CTA; every thread gets the result.  red holds kWarps floats.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) m = fmaxf(m, red[i]);
  __syncthreads();  // red is reused by the next call
  return m;
}

__global__ void __launch_bounds__(kBlock)
nn_sweep_kernel(int* __restrict__ out_idx, float* __restrict__ out_d2,
                float* __restrict__ out_lo, float* __restrict__ out_d2nd,
                float* __restrict__ out_w, const float* __restrict__ src,
                const int* __restrict__ block_counts, const float* __restrict__ cap2_ptr,
                const float* __restrict__ lb2, const int* __restrict__ torder, int mt_pad,
                const float* __restrict__ packed, const float* __restrict__ tn_all,
                const int* __restrict__ tidx_all, int m_tiles, float alpha,
                float one_minus_alpha) {
  __shared__ float s_tx[kBlock], s_ty[kBlock], s_tz[kBlock];     // raw coords
  __shared__ float s_px[kBlock], s_py[kBlock], s_pz[kBlock];     // recentred
  __shared__ float s_tn[kBlock];                                  // recentred |t|^2 or inf
  __shared__ int s_id[kBlock];
  __shared__ float s_red[kWarps];

  const int b = blockIdx.x;
  const int r = threadIdx.x;
  const int64_t row = static_cast<int64_t>(b) * kBlock + r;
  const float INF = inf_f();

  if (block_counts[b] <= 0) {  // uniform over the CTA
    out_idx[row] = 0;
    out_d2[row] = INF;
    out_lo[row] = INF;
    out_d2nd[row] = INF;
    out_w[row * 3 + 0] = 0.0f;
    out_w[row * 3 + 1] = 0.0f;
    out_w[row * 3 + 2] = 0.0f;
    return;
  }

  const int64_t b0 = static_cast<int64_t>(b) * kBlock * 3;
  const float cx = src[b0 + 0], cy = src[b0 + 1], cz = src[b0 + 2];
  const float sx = src[row * 3 + 0] - cx;
  const float sy = src[row * 3 + 1] - cy;
  const float sz = src[row * 3 + 2] - cz;
  const float sn = (sx * sx + sy * sy) + sz * sz;
  const float cap2 = *cap2_ptr;
  const float* lb_row = lb2 + static_cast<int64_t>(b) * mt_pad;
  const int* to_row = torder + static_cast<int64_t>(b) * mt_pad;

  float bd = INF, bl = INF, s1 = INF, s2 = INF, sm2 = INF;
  int bi = kBigI, s1t = -1, bti = -2;
  float wx = 0.0f, wy = 0.0f, wz = 0.0f;
  float bmax = cap2;

  int j = 0;
  for (; j < m_tiles; ++j) {
    if (!(lb_row[j] <= bmax)) break;  // bmax is CTA-uniform: every thread breaks here
    const int jt = to_row[j];
    const int64_t t0 = static_cast<int64_t>(jt) * kBlock;
    {
      const float x = packed[(t0 * 8) + 0 * kBlock + r];
      const float y = packed[(t0 * 8) + 1 * kBlock + r];
      const float z = packed[(t0 * 8) + 2 * kBlock + r];
      const bool valid = tn_all[t0 + r] < kHuge;
      const float px = x - cx, py = y - cy, pz = z - cz;
      const float tpn = (px * px + py * py) + pz * pz;
      s_tx[r] = x;
      s_ty[r] = y;
      s_tz[r] = z;
      s_px[r] = px;
      s_py[r] = py;
      s_pz[r] = pz;
      s_tn[r] = valid ? tpn : INF;
      s_id[r] = tidx_all[t0 + r];
      // block_max's barrier also publishes the staged tile
      const float maxtpn = block_max(valid ? tpn : 0.0f, s_red);

      // one pass: minimum, lowest index among minima, their count, and the
      // smallest value different from the minimum
      float m1 = INF, m2 = INF;
      int i1 = kBigI, p1 = 0, cnt = 0;
      for (int t = 0; t < kBlock; ++t) {
        const float cross = (sx * s_px[t] + sy * s_py[t]) + sz * s_pz[t];
        const float d = s_tn[t] - 2.0f * cross;
        const int id = s_id[t];
        if (d < m1) {
          m2 = m1;
          m1 = d;
          i1 = id;
          p1 = t;
          cnt = 1;
        } else if (d == m1) {
          ++cnt;
          if (id < i1) {
            i1 = id;
            p1 = t;
          }
        } else {
          m2 = fminf(m2, d);
        }
      }
      const float td = m1;
      const int ti = i1;
      const bool finite = td < kHuge;
      const bool take = (td < bd) || ((td == bd) && finite && (ti < bi));
      const float tl = td - alpha * maxtpn;
      const float t2 = cnt > 1 ? td : m2;
      sm2 = fminf(sm2, t2 - alpha * maxtpn);
      const bool is_new_min = tl < s1;
      s2 = is_new_min ? s1 : fminf(s2, tl);
      s1t = is_new_min ? jt : s1t;
      s1 = is_new_min ? tl : s1;
      if (take) {
        bti = jt;
        bi = ti;
        bd = td;
        wx = s_tx[p1];
        wy = s_ty[p1];
        wz = s_tz[p1];
      }
      bl = fminf(bl, tl);
      // this barrier also keeps the tile in shared memory until every thread
      // has scanned it
      bmax = fminf(block_max(bd + sn, s_red), cap2);
    }
  }

  out_idx[row] = bi == kBigI ? 0 : bi;
  out_d2[row] = fmaxf(bd + sn, 0.0f);
  out_lo[row] = fmaxf(fminf((bl + one_minus_alpha * sn) - alpha, cap2), 0.0f);
  const float floor_abs = j < m_tiles ? lb_row[min(j, m_tiles - 1)] : INF;
  const float other_min = bti == s1t ? s2 : s1;
  const float second = fminf(other_min, sm2);
  out_d2nd[row] = fmaxf(fminf((second + one_minus_alpha * sn) - alpha, floor_abs), 0.0f);
  out_w[row * 3 + 0] = wx;
  out_w[row * 3 + 1] = wy;
  out_w[row * 3 + 2] = wz;
}

}  // namespace

extern "C" {

// All pointers are DEVICE pointers; src is (n_blocks * 256, 3), lb2/torder are
// (n_blocks, mt_pad), packed (m_tiles, 8, 256), tn and tidx (m_tiles, 256).
int datmo_nn_sweep(int* out_idx, float* out_d2, float* out_lo, float* out_d2nd, float* out_w,
                   const float* src, const int* block_counts, const float* cap2,
                   const float* lb2, const int* torder, int mt_pad, const float* packed,
                   const float* tn, const int* tidx, int n_blocks, int m_tiles, float alpha,
                   float one_minus_alpha, void* stream) {
  if (n_blocks < 1 || m_tiles < 1 || mt_pad < m_tiles) return cudaErrorInvalidValue;
  nn_sweep_kernel<<<n_blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      out_idx, out_d2, out_lo, out_d2nd, out_w, src, block_counts, cap2, lb2, torder, mt_pad,
      packed, tn, tidx, m_tiles, alpha, one_minus_alpha);
  return cudaGetLastError();
}

}  // extern "C"
