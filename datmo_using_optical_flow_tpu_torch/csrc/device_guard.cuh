// The device guard every C entry point of the port's kernels takes first.
//
// The Python wrappers pass the index of the device their tensors lie on; the
// guard makes it current (cudaSetDevice only when it is not already) and puts
// the caller's device back when the entry returns, so no Python device context
// is needed around a launch.  An entry returns guard.err when it is not
// cudaSuccess, and cudaGetLastError() after its launch otherwise.

#pragma once

#include <cuda_runtime.h>

namespace datmo {

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev_);
    if (err == cudaSuccess && prev_ != device) {
      err = cudaSetDevice(device);
      switched_ = err == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  cudaError_t err;

 private:
  int prev_ = 0;
  bool switched_ = false;
};

}  // namespace datmo
