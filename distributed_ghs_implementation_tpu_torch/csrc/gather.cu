// K5 gather: the random gather out[i] = table[idx[i]] of the gather
// microbenchmark (gather_probe.py).
//
// Replaces pallas_gather (tools/test_pallas_gather.py:46, body gather_kernel
// :40): table int32[2^20] held whole, idx int32[2^24] and [2^26]. The TPU
// kernel held the table in VMEM and cut idx into blocks of 512 x 128; on the
// H100 the 4 MB table stays in the 50 MB L2 instead.
//
// Bound on the H100: bytes, 8 B an index (idx read, out written) plus the
// table read once: 138 MB at 2^24, 0.041 ms at 3.35 TB/s. Each random 4 B
// gather costs a 32 B L2 sector, so the L2 may set the pace rather than
// device memory; what helps is many gathers in flight. So a thread reads
// idx four at a time as int4, issues four independent __ldg gathers and
// stores one int4, in a grid-stride loop. A tail that is not a multiple of
// 4 is done one element a thread inside the same launch; pointers that are
// not 16-byte aligned take a one-element loop throughout.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;

__global__ void gather_vec4_kernel(const int32_t* __restrict__ table,
                                   const int32_t* __restrict__ idx,
                                   int32_t* __restrict__ out, long long count) {
  const long long count4 = count >> 2;
  const int4* __restrict__ idx4 = reinterpret_cast<const int4*>(idx);
  int4* __restrict__ out4 = reinterpret_cast<int4*>(out);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = tid; i < count4; i += stride) {
    const int4 k = __ldg(idx4 + i);
    int4 v;
    v.x = __ldg(table + k.x);
    v.y = __ldg(table + k.y);
    v.z = __ldg(table + k.z);
    v.w = __ldg(table + k.w);
    out4[i] = v;
  }
  const long long t = count4 * 4 + tid;  // the tail: at most 3 elements
  if (t < count) out[t] = __ldg(table + __ldg(idx + t));
}

__global__ void gather_scalar_kernel(const int32_t* __restrict__ table,
                                     const int32_t* __restrict__ idx,
                                     int32_t* __restrict__ out, long long count) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count; i += stride) {
    out[i] = __ldg(table + __ldg(idx + i));
  }
}

}  // namespace

extern "C" int ghs_gather(int device, const void* table, const void* idx, void* out,
                          long long count, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = ((uintptr_t)idx % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const long long items = aligned ? (count + 3) / 4 : count;
  const long long blocks = (items + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  if (aligned) {
    gather_vec4_kernel<<<grid, kThreads, 0, s>>>(
        (const int32_t*)table, (const int32_t*)idx, (int32_t*)out, count);
  } else {
    gather_scalar_kernel<<<grid, kThreads, 0, s>>>(
        (const int32_t*)table, (const int32_t*)idx, (int32_t*)out, count);
  }
  return (int)cudaGetLastError();
}
