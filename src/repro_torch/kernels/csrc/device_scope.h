// The card a kernel launcher runs on, for the launcher's scope only.
//
// A launcher takes the card's index from its caller and makes it current
// for the launch; the thread's card before the call is made current again
// when the scope ends, on every return path, so that a launch on card i
// leaves later CUDA calls of the thread (and torch's "cuda" device) where
// they were.
//
//   DeviceScope scope(device);
//   if (scope.error() != cudaSuccess) return scope.error();
#pragma once

#include <cuda_runtime.h>

class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ != cudaSuccess) return;
    restore_ = prev_ != device;
    if (restore_) {
      err_ = cudaSetDevice(device);
      restore_ = err_ == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (restore_) cudaSetDevice(prev_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;

  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool restore_ = false;
  cudaError_t err_;
};
