// Exact 1-NN sweep with spatial tile pruning for Hopper (sm_90a), plain C interface.
//
//   nn_sweep_kernel  <- ops/nn_pallas.py::nearest_neighbors_pallas (_kernel, _kernel_body)
//
// Held to its plain PyTorch version, ops/nn_kernels.py::_sweep_reference at
// chunk=1 (the serial definition: one 256-row source block walks its tiles in
// ascending-bound order and stops at the first tile whose bound exceeds
// bmax = min(max over the block's rows of the running best, cap2)), which
// does the same float32 operations in the same order.
//
// Design.  A thread-block cluster of C CTAs serves one source block, one
// thread per row in every CTA.  The block's row of the pruning table (squared
// lower bounds and tile order) is copied to each CTA's shared memory once.  At
// step s, the CTA of rank k stages tile torder[s*C + k] (recentred on the
// block's row 0, one float4 per target: x, y, z and |p|^2, +inf for an
// invalid target) and scans it for all 256 rows, unless that tile's bound
// already exceeds the bmax known at the start of the step (bmax never grows,
// so the replay would refuse it).  Each row's tile summary (its minimum, the
// winner's original index and raw coordinates, and the two bound terms) goes
// to the CTA's shared memory.  After cluster.sync() every CTA replays the C
// summaries in tile order, reading its peers' shared memory (distributed
// shared memory): pass 1 takes the running best after each tile as if every
// tile were taken, one CTA-wide max gives bmax after each, the stop is the
// first tile whose bound exceeds bmax before it, and pass 2 applies the tiles
// before the stop with the serial per-tile update.  Every CTA replays the same
// values, so all take the same stop and run the same number of cluster.sync()
// calls; one more before exit keeps each CTA's summaries alive until its peers
// have read them (they are double-buffered between steps), and rank 0 writes
// the outputs.  A block whose active count is 0 writes the constant outputs
// (rank 0) and exits at once.  The next step's tile is loaded into registers
// while the current one is scanned.
//
// Bound on this card: ~10 float32 operations per (row, target) pair, no tensor
// cores (the distances must be exact float32: TF32 would move winners at the
// 0.02 m ICP gate), so the time is the tiles the pruning leaves each block; in
// ICP's sparse rounds one mixed block may walk nearly every tile, and the
// cluster splits that walk over C SMs.  The inner loop reads one 16-byte
// broadcast per pair and keeps, with no branch, the minimum, its first
// position and the second smallest value counting repeats (the plain
// version's "minimum if it occurs twice, else the smallest other value"); the
// original index is read once per row and tile, and a row whose minimum is
// tied rescans the tile for the lowest index among the ties.  At C = 1 (one
// CTA per block, no split) the uncapped 102,400^2 sweep at GMFA's reference
// load takes 0.65 ms, against 1.20 ms for the one-CTA kernel with five shared
// loads and a compare-and-branch chain per pair that this one replaced
// (chip_smoke.py, H100 80GB HBM3 at 700 W).
//
// Arithmetic is the plain version's: sn = (sx*sx + sy*sy) + sz*sz, the same for
// the recentred target norm, cross = (sx*px + sy*py) + sz*pz, d = tn - 2*cross
// (sn added back after the reductions).  Ties go to the lowest original index;
// min, max and counts are exact in any order.  The library is built with
// -fmad=false (kernels/build.py), so kernel and plain version agree bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;       // source rows per block == targets per tile
constexpr int kWarps = kBlock / 32;
constexpr int kMaxTiles = 1024;   // MAX_TARGET / 256 (ops/nn_kernels.py)
constexpr int kBigI = 1 << 30;
constexpr float kHuge = 3e38f;
// CTAs per source block, one size for each kind of query, kept from the sizes
// 1, 2, 4, 8 and 16 by K5's device time per GMFA step at reference load
// (chip_smoke.py, on an H100 80GB HBM3 at 700 W; PERF.md).  Full sweeps (the
// classification sweep and ICP's final evaluation: every block live, mean 18
// and max 67 of 400 tiles) gain nothing past C = 4: their 2 per step took
// 1.97, 1.29, 0.98, 1.04 and 1.62 ms at C = 1, 2, 4, 8 and 16, the scans
// past each block's stop costing more as C grows.  ICP's active sweeps, where
// a few mixed blocks walk up to 399 tiles, gain up to C = 16: their 30 per
// step took 69.9, 39.5, 22.6, 16.7 and 13.2 ms.
constexpr int kClusterFull = 4;
constexpr int kClusterActive = 16;
// Registers are bounded for 3 CTAs per SM (80 each).  Unbounded, the replay's
// unrolled peer loads give the C = 16 instance over 100 registers and 2 CTAs
// per SM; bounded, it spills a few (ptxas -v).
constexpr int kMinBlocksPerSm = 3;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Max over the CTA of each v[k]; every thread gets the K results in v.  One
// barrier: two calls on the same red must be separated by another barrier.
template <int K>
__device__ __forceinline__ void block_max(float (&v)[K], float* red) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float x = v[k];
    for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    if ((threadIdx.x & 31) == 0) red[k * kWarps + warp] = x;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float m = red[k * kWarps];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) m = fmaxf(m, red[k * kWarps + i]);
    v[k] = m;
  }
}

struct Target {  // this thread's target of a tile, as stored in the index
  float x, y, z, tn;
  int id;
};

__device__ __forceinline__ Target load_target(const float* __restrict__ packed,
                                              const float* __restrict__ tn_all,
                                              const int* __restrict__ tidx_all,
                                              const int* s_to, int j, int m_tiles, int r) {
  Target t{0.0f, 0.0f, 0.0f, 0.0f, 0};
  if (j < m_tiles) {
    const int64_t t0 = static_cast<int64_t>(s_to[j]) * kBlock;
    t.x = packed[(t0 * 8) + 0 * kBlock + r];
    t.y = packed[(t0 * 8) + 1 * kBlock + r];
    t.z = packed[(t0 * 8) + 2 * kBlock + r];
    t.tn = tn_all[t0 + r];
    t.id = tidx_all[t0 + r];
  }
  return t;
}

template <int C>
__global__ void __launch_bounds__(kBlock, kMinBlocksPerSm)
nn_sweep_kernel(int* __restrict__ out_idx, float* __restrict__ out_d2,
                float* __restrict__ out_lo, float* __restrict__ out_d2nd,
                float* __restrict__ out_w, const float* __restrict__ src,
                const int* __restrict__ block_counts, const float* __restrict__ cap2_ptr,
                const float* __restrict__ lb2, const int* __restrict__ torder, int mt_pad,
                const float* __restrict__ packed, const float* __restrict__ tn_all,
                const int* __restrict__ tidx_all, int m_tiles, float alpha,
                float one_minus_alpha) {
  __shared__ float4 s_p[kBlock];         // recentred x, y, z, |p|^2 (+inf: invalid)
  __shared__ float4 s_raw[kBlock];       // raw x, y, z
  __shared__ int s_id[kBlock];
  __shared__ float s_lb[kMaxTiles];      // the block's row of the table
  __shared__ int s_to[kMaxTiles];
  __shared__ float2 s_best[2][kBlock];   // per row: td, ti (bits); read by peers
  __shared__ float2 s_bnd[2][kBlock];    // per row: tl, t2l
  __shared__ float4 s_win[2][kBlock];    // per row: the tile winner's raw x, y, z
  __shared__ float s_red[C * kWarps];
  __shared__ float s_red1[kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  const int r = threadIdx.x;
  const int64_t row = static_cast<int64_t>(b) * kBlock + r;
  const float INF = inf_f();

  if (block_counts[b] <= 0) {  // uniform over the cluster
    if (rank == 0) {
      out_idx[row] = 0;
      out_d2[row] = INF;
      out_lo[row] = INF;
      out_d2nd[row] = INF;
      out_w[row * 3 + 0] = 0.0f;
      out_w[row * 3 + 1] = 0.0f;
      out_w[row * 3 + 2] = 0.0f;
    }
    return;
  }

  const int64_t b0 = static_cast<int64_t>(b) * kBlock * 3;
  const float cx = src[b0 + 0], cy = src[b0 + 1], cz = src[b0 + 2];
  const float sx = src[row * 3 + 0] - cx;
  const float sy = src[row * 3 + 1] - cy;
  const float sz = src[row * 3 + 2] - cz;
  const float sn = (sx * sx + sy * sy) + sz * sz;
  const float cap2 = *cap2_ptr;
  for (int i = r; i < m_tiles; i += kBlock) {
    s_lb[i] = lb2[static_cast<int64_t>(b) * mt_pad + i];
    s_to[i] = torder[static_cast<int64_t>(b) * mt_pad + i];
  }
  __syncthreads();

  float bd = INF, bl = INF, s1 = INF, s2 = INF, sm2 = INF;
  int bi = kBigI, s1t = -1, bti = -2;
  float wx = 0.0f, wy = 0.0f, wz = 0.0f;
  float bmax = cap2;
  int j_end = m_tiles;  // the first tile the block refused (m_tiles: none)

  Target nxt = load_target(packed, tn_all, tidx_all, s_to, rank, m_tiles, r);
  int slot = 0;
  for (int j0 = 0; j0 < m_tiles; j0 += C, slot ^= 1) {
    const int jm = j0 + rank;
    if (jm < m_tiles && s_lb[jm] <= bmax) {  // bmax is cluster-uniform
      const Target cur = nxt;
      const bool valid = cur.tn < kHuge;
      const float px = cur.x - cx, py = cur.y - cy, pz = cur.z - cz;
      const float tpn = (px * px + py * py) + pz * pz;
      s_p[r] = make_float4(px, py, pz, valid ? tpn : INF);
      s_raw[r] = make_float4(cur.x, cur.y, cur.z, 0.0f);
      s_id[r] = cur.id;
      float maxtpn[1] = {valid ? tpn : 0.0f};
      block_max<1>(maxtpn, s_red1);  // its barrier also publishes the staged tile
      nxt = load_target(packed, tn_all, tidx_all, s_to, jm + C, m_tiles, r);

      // one pass: the minimum, its first position, the second smallest value
      // counting repeats (= the minimum when it occurs twice), and whether
      // the minimum is tied
      float m1 = INF, m2 = INF;
      int p1 = 0;
      bool tie = false;
#pragma unroll 8
      for (int t = 0; t < kBlock; ++t) {
        const float4 q = s_p[t];
        const float cross = (sx * q.x + sy * q.y) + sz * q.z;
        const float d = q.w - 2.0f * cross;
        const bool lt = d < m1;
        tie = lt ? false : (tie || d == m1);
        m2 = fminf(m2, fmaxf(m1, d));
        p1 = lt ? t : p1;
        m1 = fminf(m1, d);
      }
      int i1 = s_id[p1];
      if (tie) {  // rare: the lowest original index among the equal minima wins
        for (int t = p1 + 1; t < kBlock; ++t) {
          const float4 q = s_p[t];
          const float cross = (sx * q.x + sy * q.y) + sz * q.z;
          const float d = q.w - 2.0f * cross;
          if (d == m1 && s_id[t] < i1) {
            i1 = s_id[t];
            p1 = t;
          }
        }
      }
      const float am = alpha * maxtpn[0];
      s_best[slot][r] = make_float2(m1, __int_as_float(i1));
      s_bnd[slot][r] = make_float2(m1 - am, m2 - am);
      s_win[slot][r] = s_raw[p1];
    } else {
      nxt = load_target(packed, tn_all, tidx_all, s_to, jm + C, m_tiles, r);
    }
    cluster.sync();  // publishes the summaries; also a CTA-wide barrier

    // pass 1: each row's best after each tile of the step, were all taken
    float v[C];
    {
      float bd_t = bd;
      int bi_t = bi;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const float2 s = cluster.map_shared_rank(&s_best[slot][0], k)[r];
        const float td = s.x;
        const int ti = __float_as_int(s.y);
        const bool take = (td < bd_t) || ((td == bd_t) && (td < kHuge) && (ti < bi_t));
        if (take) {
          bd_t = td;
          bi_t = ti;
        }
        v[k] = bd_t + sn;
      }
    }
    block_max<C>(v, s_red);
    // the stop: the first tile whose bound exceeds bmax before it
    int k_stop = C;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      if (k_stop == C) {
        const int j = j0 + k;
        if (j >= m_tiles || !(s_lb[j] <= bmax)) {
          k_stop = k;
        } else {
          bmax = fminf(v[k], cap2);
        }
      }
    }
    // pass 2: the serial per-tile update for the tiles before the stop
#pragma unroll
    for (int k = 0; k < C; ++k) {
      if (k < k_stop) {
        const float2 s = cluster.map_shared_rank(&s_best[slot][0], k)[r];
        const float2 sb = cluster.map_shared_rank(&s_bnd[slot][0], k)[r];
        const int jt = s_to[j0 + k];
        const float td = s.x;
        const int ti = __float_as_int(s.y);
        const float tl = sb.x;
        const bool finite = td < kHuge;
        const bool take = (td < bd) || ((td == bd) && finite && (ti < bi));
        sm2 = fminf(sm2, sb.y);
        const bool is_new_min = tl < s1;
        s2 = is_new_min ? s1 : fminf(s2, tl);
        s1t = is_new_min ? jt : s1t;
        s1 = is_new_min ? tl : s1;
        if (take) {
          const float4 w = cluster.map_shared_rank(&s_win[slot][0], k)[r];
          bti = jt;
          bi = ti;
          bd = td;
          wx = w.x;
          wy = w.y;
          wz = w.z;
        }
        bl = fminf(bl, tl);
      }
    }
    if (k_stop < C) {
      j_end = j0 + k_stop;
      break;
    }
  }
  cluster.sync();  // no CTA exits while a peer may still read its summaries
  if (rank != 0) return;

  out_idx[row] = bi == kBigI ? 0 : bi;
  out_d2[row] = fmaxf(bd + sn, 0.0f);
  out_lo[row] = fmaxf(fminf((bl + one_minus_alpha * sn) - alpha, cap2), 0.0f);
  const float floor_abs = j_end < m_tiles ? s_lb[j_end] : INF;
  const float other_min = bti == s1t ? s2 : s1;
  const float second = fminf(other_min, sm2);
  out_d2nd[row] = fmaxf(fminf((second + one_minus_alpha * sn) - alpha, floor_abs), 0.0f);
  out_w[row * 3 + 0] = wx;
  out_w[row * 3 + 1] = wy;
  out_w[row * 3 + 2] = wz;
}

struct SweepArgs {
  int* out_idx;
  float* out_d2;
  float* out_lo;
  float* out_d2nd;
  float* out_w;
  const float* src;
  const int* block_counts;
  const float* cap2;
  const float* lb2;
  const int* torder;
  int mt_pad;
  const float* packed;
  const float* tn;
  const int* tidx;
  int n_blocks;
  int m_tiles;
  float alpha;
  float one_minus_alpha;
};

template <int C>
cudaError_t launch_sweep(const SweepArgs& a, cudaStream_t stream) {
  if (C > 8) {  // 16 CTAs per cluster is past the portable size of 8
    const cudaError_t err = cudaFuncSetAttribute(
        nn_sweep_kernel<C>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(a.n_blocks) * C);
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, nn_sweep_kernel<C>, a.out_idx, a.out_d2, a.out_lo, a.out_d2nd, a.out_w, a.src,
      a.block_counts, a.cap2, a.lb2, a.torder, a.mt_pad, a.packed, a.tn, a.tidx, a.m_tiles,
      a.alpha, a.one_minus_alpha);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

cudaError_t sweep(const SweepArgs& a, int cluster, int device, void* stream) {
  if (a.n_blocks < 1 || a.m_tiles < 1 || a.m_tiles > kMaxTiles || a.mt_pad < a.m_tiles) {
    return cudaErrorInvalidValue;
  }
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cluster) {
    case 1: return launch_sweep<1>(a, s);
    case 2: return launch_sweep<2>(a, s);
    case 4: return launch_sweep<4>(a, s);
    case 8: return launch_sweep<8>(a, s);
    case 16: return launch_sweep<16>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// All pointers are DEVICE pointers; src is (n_blocks * 256, 3), lb2/torder are
// (n_blocks, mt_pad), packed (m_tiles, 8, 256), tn and tidx (m_tiles, 256);
// m_tiles <= 1024.  A full query (every block owed a result) launches
// kClusterFull CTAs per source block; an active query (ICP's sweep of the rows
// that need one) kClusterActive.
int datmo_nn_sweep(int* out_idx, float* out_d2, float* out_lo, float* out_d2nd, float* out_w,
                   const float* src, const int* block_counts, const float* cap2,
                   const float* lb2, const int* torder, int mt_pad, const float* packed,
                   const float* tn, const int* tidx, int n_blocks, int m_tiles, float alpha,
                   float one_minus_alpha, int device, void* stream) {
  const SweepArgs a{out_idx, out_d2, out_lo, out_d2nd, out_w, src, block_counts, cap2, lb2,
                    torder, mt_pad, packed, tn, tidx, n_blocks, m_tiles, alpha,
                    one_minus_alpha};
  return sweep(a, kClusterFull, device, stream);
}

int datmo_nn_sweep_active(int* out_idx, float* out_d2, float* out_lo, float* out_d2nd,
                          float* out_w, const float* src, const int* block_counts,
                          const float* cap2, const float* lb2, const int* torder, int mt_pad,
                          const float* packed, const float* tn, const int* tidx, int n_blocks,
                          int m_tiles, float alpha, float one_minus_alpha, int device,
                          void* stream) {
  const SweepArgs a{out_idx, out_d2, out_lo, out_d2nd, out_w, src, block_counts, cap2, lb2,
                    torder, mt_pad, packed, tn, tidx, n_blocks, m_tiles, alpha,
                    one_minus_alpha};
  return sweep(a, kClusterActive, device, stream);
}

// The same sweep with `cluster` (1, 2, 4, 8 or 16) CTAs per source block, for
// measuring the cluster size; the port's path calls the two entries above.
int datmo_nn_sweep_sized(int* out_idx, float* out_d2, float* out_lo, float* out_d2nd,
                         float* out_w, const float* src, const int* block_counts,
                         const float* cap2, const float* lb2, const int* torder, int mt_pad,
                         const float* packed, const float* tn, const int* tidx, int n_blocks,
                         int m_tiles, float alpha, float one_minus_alpha, int cluster,
                         int device, void* stream) {
  const SweepArgs a{out_idx, out_d2, out_lo, out_d2nd, out_w, src, block_counts, cap2, lb2,
                    torder, mt_pad, packed, tn, tidx, n_blocks, m_tiles, alpha,
                    one_minus_alpha};
  return sweep(a, cluster, device, stream);
}

}  // extern "C"
