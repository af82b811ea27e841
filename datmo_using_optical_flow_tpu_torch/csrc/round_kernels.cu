// Once-rounded float32 arithmetic for Hopper (sm_90a), with a plain C interface.
//
//   fma32_kernel            <- XLA's contraction of a * b + c (no Pallas kernel: e.g.
//                              the flow magnitude, datmo_using_optical_flow_tpu/models/
//                              optical_flow_datmo.py:601, and the threefry draws'
//                              polynomials)
//   transform_points_kernel <- XLA's fused dot + add of ICP's transform (no Pallas
//                              kernel: datmo_using_optical_flow_tpu/ops/icp.py:375,
//                              points @ transformation[:3, :3].T + transformation[:3, 3],
//                              and the same expression inlined at ops/icp.py:101,117)
//   sumsq_kernel            <- XLA's contraction of jnp.sum(d * d, axis=-1), d = a - b,
//                              over a short last axis, with its correctly rounded root
//                              when asked (e.g. tracker A's association distance,
//                              models/tracker_a.py:169, and GMFA's cost matrix,
//                              models/gmfa.py:586-587): XLA fuses the subtraction, the
//                              sum and the root into one loop, and so does this kernel;
//                              without b it squares a itself
//
// The JAX package's compiled code fuses these multiply-adds and rounds each
// once; the port's plain versions (utils/ordered.py: fma32_reference,
// sumsq_reference; ops/round_kernels.transform_points_reference) reach the
// same float32 results through exact float64 products and a sum rounded to
// odd, a dozen elementwise torch ops per fma.  Here each is one instruction:
// __fmaf_rn rounds the fused product-sum once and __fsqrt_rn is the correctly
// rounded root, so a kernel equals its plain version bit for bit (infinities
// and NaNs included) with denormals kept (no -ftz).
//
// All three are elementwise, so their bound on the H100 is the bytes they
// move.  fma32 reads each tensor operand through its element strides over the
// broadcast output (up to three axes, stride 0 along a broadcast axis), so an
// expanded view is never copied; where every tensor operand is contiguous
// with the output's shape it takes the flat path, one index for all.
// transform_points reads the (N, 3) points through their strides and the 4x4
// transform from device memory (ICP's transform arrives there from pinned
// memory without a wait, so the host never reads it), each block once into
// shared memory, and writes (N, 3) contiguous: one thread per output value,
// so the stores are coalesced and a warp's loads of its ~11 points share
// their sectors.  It is the whole of XLA's fusion in one launch, where the
// port made four calls (a product, two fma32 that each copied two broadcast
// operands to full size, an add): 8 device records.  sumsq reads the distinct
// values of a and b (either may broadcast: both are read through their
// strides) and writes one per row.  At the call sites' sizes (64 to 307,200
// values) a call is launch time, so the design is about the host: one launch
// where the callers made several, no copy, one allocation, the launch
// arguments worked out once per signature by the wrapper.
//
// Each C entry point makes the given device current (device_guard.cuh), launches
// on the stream it is given and returns cudaGetLastError(); the Python wrapper
// (ops/round_kernels.py) raises when that is not cudaSuccess.

#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;

// Element strides of an operand over a broadcast shape of three axes: the
// output's (n0, n1, n2) for fma32, the rows and the component (n0, n1, k)
// for sumsq.  0 along an axis the operand broadcasts.
struct Strides3 {
  int64_t s0, s1, s2;
};

// out[i] = fma(a, b, c) rounded once at element i of the broadcast shape
// (n0, n1, n2), out contiguous, n = n0 * n1 * n2; b and c are arrays or,
// where their pointer is null, the scalars bs and cs.  kFlat: every array is
// contiguous with the output's shape, read at i itself.  With root, out[i]
// is its root.
template <bool kFlat>
__global__ void __launch_bounds__(kThreads)
fma32_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ c, Strides3 sa, Strides3 sb, Strides3 sc, float bs,
             float cs, int root, float* __restrict__ out, int64_t n, int64_t n1, int64_t n2) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  int64_t ia = i, ib = i, ic = i;
  if (!kFlat) {
    const int64_t i01 = i / n2, i2 = i - i01 * n2;
    const int64_t i0 = i01 / n1, i1 = i01 - i0 * n1;
    ia = i0 * sa.s0 + i1 * sa.s1 + i2 * sa.s2;
    ib = i0 * sb.s0 + i1 * sb.s1 + i2 * sb.s2;
    ic = i0 * sc.s0 + i1 * sc.s1 + i2 * sc.s2;
  }
  const float r = __fmaf_rn(a[ia], b ? b[ib] : bs, c ? c[ic] : cs);
  out[i] = root ? __fsqrt_rn(r) : r;
}

// out[q, j] = fma(z, R[j][2], fma(y, R[j][1], x * R[j][0])) + t[j], each step
// rounded once, for the point (x, y, z) = p[q, 0..2] (element strides sp0,
// sp1) and the 4x4 transform m (element strides sm0, sm1; R = m[:3, :3], t =
// m[:3, 3]): the order of ops/icp.transform_points' plain version.  out is
// (N, 3) contiguous, n3 = 3 N, one thread per value.
__global__ void __launch_bounds__(kThreads)
transform_points_kernel(const float* __restrict__ p, const float* __restrict__ m, int64_t sp0,
                        int64_t sp1, int64_t sm0, int64_t sm1, float* __restrict__ out,
                        int64_t n3) {
  __shared__ float rt[12];  // row j of [R | t] at rt[4 j .. 4 j + 3]
  if (threadIdx.x < 12) rt[threadIdx.x] = m[(threadIdx.x >> 2) * sm0 + (threadIdx.x & 3) * sm1];
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n3) return;
  const int64_t q = i / 3;
  const float* r = rt + 4 * static_cast<int>(i - q * 3);
  const float* pq = p + q * sp0;
  const float x = pq[0], y = pq[sp1], z = pq[2 * sp1];
  out[i] = __fadd_rn(__fmaf_rn(z, r[2], __fmaf_rn(y, r[1], __fmul_rn(x, r[0]))), r[3]);
}

// out[i0, i1] = fma(d[k-1], d[k-1], ... fma(d[1], d[1], d[0] * d[0])), each step
// rounded once, d[j] = a[i0, i1, j] - b[i0, i1, j] rounded to float32 (d = a
// where b is null); with root, its correctly rounded root.  out is (n0, n1),
// contiguous; n = n0 * n1.
__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const float* __restrict__ a, const float* __restrict__ b, Strides3 sa,
             Strides3 sb, int k, int root, float* __restrict__ out, int64_t n, int64_t n1) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t i0 = i / n1, i1 = i - i0 * n1;
  const float* ra = a + i0 * sa.s0 + i1 * sa.s1;
  const float* rb = b ? b + i0 * sb.s0 + i1 * sb.s1 : nullptr;
  float d = b ? __fsub_rn(ra[0], rb[0]) : ra[0];
  float acc = __fmul_rn(d, d);
  for (int j = 1; j < k; ++j) {
    d = b ? __fsub_rn(ra[j * sa.s2], rb[j * sb.s2]) : ra[j * sa.s2];
    acc = __fmaf_rn(d, d, acc);
  }
  out[i] = root ? __fsqrt_rn(acc) : acc;
}

unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// a, b, c and out are DEVICE pointers; b or c may be null, and then the scalar
// bs or cs stands for every element.  a, b and c are read at element strides
// (s*0, s*1, s*2) over the broadcast shape (n0, n1, n2), or, with flat, at
// the output's own index (every array contiguous with the output's shape; the
// strides are not read).  out is n0 * n1 * n2 contiguous values.
int datmo_fma32(float* out, const float* a, const float* b, const float* c, float bs,
                float cs, int root, int64_t n0, int64_t n1, int64_t n2, int64_t sa0,
                int64_t sa1, int64_t sa2, int64_t sb0, int64_t sb1, int64_t sb2, int64_t sc0,
                int64_t sc1, int64_t sc2, int flat, int device, void* stream) {
  if (n0 < 1 || n1 < 1 || n2 < 1) return cudaErrorInvalidValue;
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const int64_t n = n0 * n1 * n2;
  const Strides3 sa{sa0, sa1, sa2}, sb{sb0, sb1, sb2}, sc{sc0, sc1, sc2};
  const auto s = static_cast<cudaStream_t>(stream);
  if (flat) {
    fma32_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(a, b, c, sa, sb, sc, bs, cs, root,
                                                          out, n, n1, n2);
  } else {
    fma32_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(a, b, c, sa, sb, sc, bs, cs, root,
                                                           out, n, n1, n2);
  }
  return cudaGetLastError();
}

// points, transform and out are DEVICE pointers: points (n, 3) at element
// strides (sp0, sp1), the 4x4 transform at (sm0, sm1), out (n, 3) contiguous.
int datmo_transform_points(float* out, const float* points, const float* transform, int64_t n,
                           int64_t sp0, int64_t sp1, int64_t sm0, int64_t sm1, int device,
                           void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const int64_t n3 = 3 * n;
  transform_points_kernel<<<blocks_for(n3), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      points, transform, sp0, sp1, sm0, sm1, out, n3);
  return cudaGetLastError();
}

// a, b (or null) and out are DEVICE pointers; a and b are read at element
// strides (sa0, sa1, sak) and (sb0, sb1, sbk) over the broadcast shape (n0, n1,
// k), out is n0 * n1 contiguous values.
int datmo_sumsq(float* out, const float* a, const float* b, int k, int root, int64_t n0,
                int64_t n1, int64_t sa0, int64_t sa1, int64_t sak, int64_t sb0, int64_t sb1,
                int64_t sbk, int device, void* stream) {
  if (n0 < 1 || n1 < 1 || k < 1) return cudaErrorInvalidValue;
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const int64_t n = n0 * n1;
  sumsq_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, Strides3{sa0, sa1, sak}, Strides3{sb0, sb1, sbk}, k, root, out, n, n1);
  return cudaGetLastError();
}

}  // extern "C"
