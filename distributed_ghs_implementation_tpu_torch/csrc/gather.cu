// K5 gather: the random gather out[i] = table[idx[i]] of the gather
// microbenchmark (gather_probe.py).
//
// Replaces pallas_gather (tools/test_pallas_gather.py:46, body gather_kernel
// :40): table int32[2^20] held whole, idx int32[2^24] and [2^26]. The TPU
// kernel held the table in VMEM and cut idx into blocks of 512 x 128; on the
// H100 the 4 MB table stays in the 50 MB L2 instead.
//
// Bound on the H100: the bytes bound is 8 B an index (idx read, out written)
// plus the table read once, 0.041 ms at 2^24 over 3.35 TB/s. What sets the
// pace is the L2: each random 4 B read of the table costs a whole 32 B L2
// sector, so 2^24 reads move 537 MB of sectors, and the L1 (256 KB an SM
// against a 4 MB table) catches few of them. torch.index_select runs at the
// same rate of sectors. The design keeps as many sector requests in flight
// as it can and moves the streamed bytes in whole sectors:
// - A thread loads two int4 of idx, issues eight independent table loads
//   and stores two int4. A warp's two index loads each cover 512 contiguous
//   bytes (the j-th int4 of a thread lies j * kThreads int4 past its first);
//   with a thread's two int4 side by side instead, it ran slower.
// - idx is loaded and out stored with the evict-first hint (__ldcs, __stcs)
//   so that they pass through; the table goes through __ldg. An L2
//   evict_last policy on the table loads, and giving the kernel the whole L1
//   (carveout 0), were measured and did not help: the 4 MB table keeps its
//   place in the 50 MB L2 without them. Nothing device-wide is set: no
//   persisting-L2 limit, no access-policy window.
// - One block for every 2,048 indices. A persistent grid of SMs x resident
//   blocks (from the occupancy API), walking the vector in a loop, was
//   measured slower at 2^24 and at 2^26, perhaps because its last turn
//   leaves SMs idle; the loop stays only for vectors past kMaxGrid blocks.
//   Indices are long long, so 2^26 and more cannot overflow.
// The tail past the last whole int4 (at most 3 elements) is done one element
// a thread in the same launch, and pointers that are not 16-byte aligned (a
// view at an odd offset) take a one-element loop throughout.

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 2;  // int4 of idx a thread takes each turn: 8 gathers in flight
constexpr long long kChunk = (long long)kVecs * kThreads;  // int4 a block takes each turn
constexpr long long kMaxGrid = 1 << 20;

__global__ void __launch_bounds__(kThreads)
    gather_vec_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ idx,
                      int32_t* __restrict__ out, long long count) {
  const long long nvec = count >> 2;
  const int4* __restrict__ idx4 = reinterpret_cast<const int4*>(idx);
  int4* __restrict__ out4 = reinterpret_cast<int4*>(out);
  for (long long base = (long long)blockIdx.x * kChunk; base < nvec;
       base += (long long)gridDim.x * kChunk) {
    const bool whole = base + kChunk <= nvec;  // the same for the whole block
    long long pos[kVecs];
    int4 k[kVecs];
    int4 v[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) pos[j] = base + (long long)j * kThreads + threadIdx.x;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      if (whole || pos[j] < nvec) k[j] = __ldcs(idx4 + pos[j]);
    }
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      if (whole || pos[j] < nvec) {
        v[j].x = __ldg(table + k[j].x);
        v[j].y = __ldg(table + k[j].y);
        v[j].z = __ldg(table + k[j].z);
        v[j].w = __ldg(table + k[j].w);
      }
    }
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      if (whole || pos[j] < nvec) __stcs(out4 + pos[j], v[j]);
    }
  }
  // The tail: at most 3 elements past the last int4, one a thread.
  const long long t = nvec * 4 + (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t < count) out[t] = __ldg(table + __ldcs(idx + t));
}

__global__ void __launch_bounds__(kThreads)
    gather_scalar_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ idx,
                         int32_t* __restrict__ out, long long count) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < count; i += stride) {
    __stcs(out + i, __ldg(table + __ldcs(idx + i)));
  }
}

}  // namespace

extern "C" int ghs_gather(int device, const void* table, const void* idx, void* out,
                          long long count, void* stream) {
  const ghs::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = ((uintptr_t)idx % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (aligned) {
    const long long chunks = ((count >> 2) + kChunk - 1) / kChunk;
    long long grid = chunks < kMaxGrid ? chunks : kMaxGrid;
    if (grid < 1) grid = 1;  // count < 4: the tail alone, in one block
    gather_vec_kernel<<<(unsigned)grid, kThreads, 0, s>>>(
        (const int32_t*)table, (const int32_t*)idx, (int32_t*)out, count);
  } else {
    const long long blocks = (count + kThreads - 1) / kThreads;
    const long long grid = blocks < kMaxGrid ? blocks : kMaxGrid;
    gather_scalar_kernel<<<(unsigned)grid, kThreads, 0, s>>>(
        (const int32_t*)table, (const int32_t*)idx, (int32_t*)out, count);
  }
  return (int)cudaGetLastError();
}
