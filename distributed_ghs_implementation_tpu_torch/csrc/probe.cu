// K4 probe: the load-time self-check, a gather out[i] = table[idx[i]].
//
// Replaces the capability probe _probe (distributed_ghs_implementation_tpu/
// ops/pallas_kernels.py:210, pallas_call :225): table int32[256], idx
// int32[2,128] filled with 3, expects 3 everywhere. In the port it is a
// self-check of the freshly loaded library, never a selector.
//
// Bound on the H100: its 3 KB move in well under a microsecond, so the time
// of a call is the time of the launch path from Python to the card, which
// every wrapper shares: the checks, the output's allocation, the stream
// handle, the call into the extension module (bindings.cpp) and the launch
// itself. That path is what the design trims (ops/kernels.py): attribute
// checks, the raw stream handle, a METH_FASTCALL binding instead of ctypes,
// and a device guard that sets the device only where it differs
// (launch.cuh).

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

__global__ void probe_kernel(const int32_t* __restrict__ table,
                             const int32_t* __restrict__ idx,
                             int32_t* __restrict__ out, long long count) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count; i += stride) {
    out[i] = __ldg(table + __ldg(idx + i));
  }
}

}  // namespace

extern "C" int ghs_probe(int device, const void* table, const void* idx, void* out,
                         long long count, void* stream) {
  const ghs::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const long long blocks = (count + 255) / 256;
  const unsigned grid = (unsigned)(blocks < 1024 ? blocks : 1024);
  probe_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)table, (const int32_t*)idx, (int32_t*)out, count);
  return (int)cudaGetLastError();
}

extern "C" const char* ghs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
