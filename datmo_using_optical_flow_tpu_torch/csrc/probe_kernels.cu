// Launch-cost probe for Hopper (sm_90a), with a plain C interface.
//
//   tiny_kernel  <- benchmarks/diag_icp_body.py::tiny_pallas (body _k)
//
// out = x + 1.0f, one thread per element.  The TPU kernel is the ICP-round
// diagnostic's measure of what one kernel launch costs inside a loop step; this
// is the same probe on the card (diagnostics/icp_body.py), held to its plain
// version ops/probe_kernels.py::tiny_reference (bit-equal: one rounded add).
// Bound on the H100: at the probe's (8, 128) float32 block it moves 8 KB and
// does 1,024 adds, ~2.4 ns of memory time, so its time is the launch's.
//
// The C entry point launches on the stream it is given and returns
// cudaGetLastError(); the Python wrapper raises when that is not cudaSuccess.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
tiny_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) out[i] = x[i] + 1.0f;
}

}  // namespace

extern "C" {

// x and out are DEVICE pointers to n float32 values.
int datmo_tiny(float* out, const float* x, int64_t n, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  tiny_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return cudaGetLastError();
}

}  // extern "C"
