// K2 gather_key: the flat minimum-outgoing-edge front half.
//
// Replaces fused_gather_key (distributed_ghs_implementation_tpu/ops/
// pallas_kernels.py:492, body _gather_key_kernel :432). Per directed slot i:
//   fsrc[i] = fragment[src[i]]
//   key[i]  = fragment[src[i]] != fragment[dst[i]] ? rank[i] : INT32_MAX
// The per-fragment segment_min over (key, fsrc) stays a separate op, as it
// stayed outside the kernel on the TPU.
//
// Bound on the H100: bytes. Each slot streams 12 B in (src, dst, rank) and
// 8 B out (fsrc, key); the fragment table (4 B a vertex, 1 MB at 2^18
// vertices) is read at random but stays in the 50 MB L2. The design streams
// the slot arrays with one thread per slot in a grid-stride loop and sends
// the two table gathers through the read-only path (__ldg), so the table is
// served from L2 and the streams run at device-memory rate.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;  // 32 blocks per SM: a grid-stride loop covers the rest

__global__ void gather_key_kernel(const int32_t* __restrict__ fragment,
                                  const int32_t* __restrict__ src,
                                  const int32_t* __restrict__ dst,
                                  const int32_t* __restrict__ rank,
                                  int32_t* __restrict__ fsrc,
                                  int32_t* __restrict__ key,
                                  long long e) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < e; i += stride) {
    const int32_t fs = __ldg(fragment + __ldg(src + i));
    const int32_t fd = __ldg(fragment + __ldg(dst + i));
    fsrc[i] = fs;
    key[i] = fs != fd ? __ldg(rank + i) : INT_MAX;
  }
}

}  // namespace

extern "C" int ghs_gather_key(int device, const void* fragment, const void* src,
                              const void* dst, const void* rank, void* fsrc, void* key,
                              long long e, void* stream) {
  const ghs::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const long long blocks = (e + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  gather_key_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)fragment, (const int32_t*)src, (const int32_t*)dst,
      (const int32_t*)rank, (int32_t*)fsrc, (int32_t*)key, e);
  return (int)cudaGetLastError();
}
