// Once-rounded float32 arithmetic for Hopper (sm_90a), with a plain C interface.
//
//   fma32_kernel  <- XLA's contraction of a * b + c (no Pallas kernel: e.g. the
//                    flow magnitude, datmo_using_optical_flow_tpu/models/
//                    optical_flow_datmo.py:601, and the rotation of ops/icp.py)
//   sumsq_kernel  <- XLA's contraction of jnp.sum(d * d, axis=-1), d = a - b, over a
//                    short last axis, with its correctly rounded root when asked
//                    (e.g. tracker A's association distance, models/tracker_a.py:169,
//                    and GMFA's cost matrix, models/gmfa.py:586-587): XLA fuses the
//                    subtraction, the sum and the root into one loop, and so does
//                    this kernel; without b it squares a itself
//
// The JAX package's compiled code fuses these multiply-adds and rounds each
// once; the port's plain versions (utils/ordered.py: fma32_reference,
// sumsq_reference) reach the same float32 results through exact float64
// products and a sum rounded to odd, a dozen elementwise torch ops per fma.
// Here each is one instruction: __fmaf_rn rounds the fused product-sum once and
// __fsqrt_rn is the correctly rounded root, so a kernel equals its plain version
// bit for bit (infinities and NaNs included) with denormals kept (no -ftz).
//
// Both are elementwise, so their bound on the H100 is the bytes they move:
// fma32 reads up to three values and writes one per element over contiguous
// arrays; sumsq reads the distinct values of a and b (either may broadcast:
// both are read through their strides, so an expanded view is never copied)
// and writes one per row.  At the call sites' sizes (64 to 160,000 rows) a
// call is launch time, so the design is about the host: one launch where the
// callers made two (the subtraction, then the sum), no copy, one allocation.
//
// Each C entry point makes the given device current (device_guard.cuh), launches
// on the stream it is given and returns cudaGetLastError(); the Python wrapper
// (ops/round_kernels.py) raises when that is not cudaSuccess.

#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;

// out[i] = fma(a[i], b, c) rounded once; b and c are arrays or, where their
// pointer is null, the scalars bs and cs.  With root, out[i] is its root.
__global__ void __launch_bounds__(kThreads)
fma32_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ c, float bs, float cs, int root,
             float* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float r = __fmaf_rn(a[i], b ? b[i] : bs, c ? c[i] : cs);
  out[i] = root ? __fsqrt_rn(r) : r;
}

// Element strides of an operand of sumsq over its broadcast shape
// (n0, n1, k): rows i0, i1 and the component j.
struct RowStrides {
  int64_t s0, s1, sk;
};

// out[i0, i1] = fma(d[k-1], d[k-1], ... fma(d[1], d[1], d[0] * d[0])), each step
// rounded once, d[j] = a[i0, i1, j] - b[i0, i1, j] rounded to float32 (d = a
// where b is null); with root, its correctly rounded root.  out is (n0, n1),
// contiguous; n = n0 * n1.
__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const float* __restrict__ a, const float* __restrict__ b, RowStrides sa,
             RowStrides sb, int k, int root, float* __restrict__ out, int64_t n, int64_t n1) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t i0 = i / n1, i1 = i - i0 * n1;
  const float* ra = a + i0 * sa.s0 + i1 * sa.s1;
  const float* rb = b ? b + i0 * sb.s0 + i1 * sb.s1 : nullptr;
  float d = b ? __fsub_rn(ra[0], rb[0]) : ra[0];
  float acc = __fmul_rn(d, d);
  for (int j = 1; j < k; ++j) {
    d = b ? __fsub_rn(ra[j * sa.sk], rb[j * sb.sk]) : ra[j * sa.sk];
    acc = __fmaf_rn(d, d, acc);
  }
  out[i] = root ? __fsqrt_rn(acc) : acc;
}

unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// a, b, c and out are DEVICE pointers to n float32 values; b or c may be null,
// and then the scalar bs or cs stands for every element.
int datmo_fma32(float* out, const float* a, const float* b, const float* c, float bs,
                float cs, int root, int64_t n, int device, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  fma32_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, bs, cs, root, out, n);
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
      a, b, RowStrides{sa0, sa1, sak}, RowStrides{sb0, sb1, sbk}, k, root, out, n, n1);
  return cudaGetLastError();
}

}  // extern "C"
