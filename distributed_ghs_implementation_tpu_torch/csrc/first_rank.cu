// K6 first_rank: each vertex's least incident rank, the rank route's
// level-1 input.
//
// Replaces no TPU kernel. The JAX package computes this pass on the host
// (Graph.first_ranks: a native serial scan, or NumPy's first occurrence),
// under the endpoint copies to the TPU. On the H100 the rank endpoints are
// already staged when the pass starts, so it runs where they are:
//   vmin[x] = min{ r < m : ra[r] == x or rb[r] == x }
// The wrapper presets vmin (n_pad entries) to INT32_MAX, which a vertex
// with no edge, and every pad vertex, keeps. Pad ranks r >= m (ra == rb ==
// 0) are never read, so an isolated vertex 0 keeps INT32_MAX too.
//
// Bound on the H100. By bytes: each rank streams 8 B in (ra, rb) and each
// vertex is written once, 4 B: at 2^27 ranks and 2^23 vertices 1.11 GB,
// 0.33 ms at 3.35 TB/s. By the table's reads, which bind: two reads a rank
// of one int32 each, at random over the table (32 MB at 2^23 vertices,
// kept in the 50 MB L2), each a 32-byte L2 sector; the L2 serves about
// 1.3e11 such reads a second (K5's random gather, PERF.md), so 2^28 reads
// take about 2 ms. The design streams the endpoints in a grid-stride loop,
// four ranks a thread a step through 16-byte loads marked streaming (read
// once, so they do not evict the table). Before each int32 atomicMin a
// thread reads the table's entry from L2 and updates only when its rank is
// smaller. The grid sweeps the ranks in ascending order, so a hub of an
// RMAT graph is settled by its first few ranks and the read rejects almost
// every later one without an atomic: atomics alone took 1.8 times as long.
// An entry only ever falls, so a read that is stale is larger than the
// entry and costs one atomic that changes nothing: never a wrong minimum.
// A cache of the hottest vertices in shared memory saved 11% of the reads'
// time, a cluster's shared memory lost time; neither is kept.

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 8;  // one wave: 8 blocks of 256 fill an SM's 2,048 threads

__device__ __forceinline__ void relax(int32_t* vmin, int32_t x, int32_t r) {
  if (r < __ldcg(vmin + x)) atomicMin(vmin + x, r);
}

// kVec: ra and rb are 16-byte aligned, and each thread takes four ranks a
// step with one int4 load of each; the m % 4 ranks past the last whole
// quad go one a thread.
template <bool kVec>
__global__ void first_rank_kernel(const int32_t* __restrict__ ra,
                                  const int32_t* __restrict__ rb,
                                  int32_t* vmin,
                                  long long m) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (kVec) {
    const long long quads = m / 4;
    const int4* a4 = reinterpret_cast<const int4*>(ra);
    const int4* b4 = reinterpret_cast<const int4*>(rb);
    for (long long q = tid; q < quads; q += stride) {
      const int4 a = __ldcs(a4 + q);
      const int4 b = __ldcs(b4 + q);
      const int32_t r = (int32_t)(4 * q);
      relax(vmin, a.x, r);
      relax(vmin, b.x, r);
      relax(vmin, a.y, r + 1);
      relax(vmin, b.y, r + 1);
      relax(vmin, a.z, r + 2);
      relax(vmin, b.z, r + 2);
      relax(vmin, a.w, r + 3);
      relax(vmin, b.w, r + 3);
    }
    done = 4 * quads;
  }
  for (long long r = done + tid; r < m; r += stride) {
    relax(vmin, __ldcs(ra + r), (int32_t)r);
    relax(vmin, __ldcs(rb + r), (int32_t)r);
  }
}

}  // namespace

extern "C" int ghs_first_rank(int device, const void* ra, const void* rb, void* vmin,
                              long long m, void* stream) {
  const ghs::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const bool vec = (reinterpret_cast<uintptr_t>(ra) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(rb) % 16 == 0);
  const long long items = vec ? (m + 3) / 4 : m;
  const long long blocks = (items + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  if (vec) {
    first_rank_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ra, (const int32_t*)rb, (int32_t*)vmin, m);
  } else {
    first_rank_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ra, (const int32_t*)rb, (int32_t*)vmin, m);
  }
  return (int)cudaGetLastError();
}
