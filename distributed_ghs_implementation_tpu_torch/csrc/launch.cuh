// The launch preamble every ghs_* launcher shares.
//
// The wrapper passes the device its tensors lie on and PyTorch's current
// stream of that device. A launch on a stream of one device while another
// device is current fails with "invalid resource handle", so the launcher
// makes the tensors' device current for the launch and puts the previous
// one back, as PyTorch's own device guard does. Reading the current device
// is cheap and setting it is not, so it sets only where the two differ: on
// a machine with one card, never.

#pragma once

#include <cuda_runtime.h>

namespace ghs {

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    int current = 0;
    error_ = cudaGetDevice(&current);
    if (error_ == cudaSuccess && current != device) {
      error_ = cudaSetDevice(device);
      if (error_ == cudaSuccess) previous_ = current;
    }
  }
  ~DeviceGuard() {
    if (previous_ >= 0) cudaSetDevice(previous_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  cudaError_t error() const { return error_; }

 private:
  cudaError_t error_ = cudaSuccess;
  int previous_ = -1;
};

}  // namespace ghs
