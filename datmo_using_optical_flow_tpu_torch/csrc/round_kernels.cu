// Once-rounded float32 arithmetic for Hopper (sm_90a), with a plain C interface.
//
//   fma32_kernel  <- XLA's contraction of a * b + c (no Pallas kernel: e.g. the
//                    flow magnitude, datmo_using_optical_flow_tpu/models/
//                    optical_flow_datmo.py:601, and the rotation of ops/icp.py)
//   sumsq_kernel  <- XLA's contraction of jnp.sum(v * v, axis=-1) over a short
//                    last axis, with its correctly rounded root when asked (e.g.
//                    tracker A's association distance, models/tracker_a.py:169)
//
// The JAX package's compiled code fuses these multiply-adds and rounds each
// once; the port's plain versions (utils/ordered.py: fma32_reference,
// sumsq_reference) reach the same float32 results through exact float64
// products and a sum rounded to odd, a dozen elementwise torch ops per fma.
// Here each is one instruction: __fmaf_rn rounds the fused product-sum once and
// __fsqrt_rn is the correctly rounded root, so a kernel equals its plain version
// bit for bit (infinities and NaNs included) with denormals kept (no -ftz).
//
// Both are elementwise over contiguous float32 arrays, so their bound on the
// H100 is the bytes they move: fma32 reads up to three values and writes one per
// element, sumsq reads k and writes one per row.
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

// out[i] = fma(v[i, k-1], v[i, k-1], ... fma(v[i, 1], v[i, 1], v[i, 0] * v[i, 0])),
// each step rounded once; with root, its correctly rounded root.
__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const float* __restrict__ v, int k, int root, float* __restrict__ out,
             int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* row = v + i * k;
  float acc = __fmul_rn(row[0], row[0]);
  for (int j = 1; j < k; ++j) acc = __fmaf_rn(row[j], row[j], acc);
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

// v is a DEVICE pointer to n rows of k float32 values (row-major), out to n.
int datmo_sumsq(float* out, const float* v, int k, int root, int64_t n, int device,
                void* stream) {
  if (n < 1 || k < 1) return cudaErrorInvalidValue;
  datmo::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  sumsq_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, k, root, out, n);
  return cudaGetLastError();
}

}  // extern "C"
