// K3 ell_row_min: the masked row minimum of one ELL bucket.
//
// Replaces fused_ell_row_min (distributed_ghs_implementation_tpu/ops/
// pallas_kernels.py:465, body _ell_row_min_kernel :422). Per row r of a
// bucket of width W:
//   out[r] = min_j (fragment[dstb[r,j]] != fragment[verts[r]] ? rankb[r,j] : INT32_MAX)
// One launch per bucket, as the JAX caller makes one call per bucket. The
// scatter-min of out into the per-vertex minima stays a separate op, as it
// stayed outside the kernel on the TPU.
//
// Hazard: W ranges over 1 ... 32,768 within one solve (RMAT-18: 65,536 rows
// of width 1 and one row of width 32,768). A thread per row would serialise
// the hub rows; a warp per row would leave 31 of 32 lanes idle on the narrow
// ones. So the layout follows W: up to W = 512 a group of g lanes of one
// warp takes a row, g the largest power of two <= min(W, 32), so a warp
// takes 32 / g rows below W = 32; above W = 512 a block takes a row. Lanes
// reduce with __shfl_xor_sync, the warps of a block through shared memory.
//
// Bound on the H100: bytes. The dstb and rankb streams, 8 B a slot (137 MB
// for one RMAT-18 level over its 15 buckets), dominate; verts, out and the
// 1 MB fragment table add about 3 MB. Neighbouring lanes read neighbouring
// slots, so the streams coalesce; the fragment gathers go through __ldg and
// the table stays in the 50 MB L2. A slot whose rank cannot lower the
// lane's running minimum skips its dstb read and its gather: on rank-sorted
// rows a lane stops gathering after its first outgoing slot. Row offsets
// are 64-bit.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpLayoutThreads = 256;
constexpr long long kWarpLayoutMaxWidth = 512;  // above it a block takes a row
constexpr long long kMaxBlocks = 132 * 32;      // a grid-stride loop covers the rest

// The least rank among slots start, start + step, ... < width of one row
// (dst, rank already offset to the row) that leave fragment fv.
__device__ __forceinline__ int32_t lane_row_min(const int32_t* __restrict__ fragment,
                                                const int32_t* __restrict__ dst,
                                                const int32_t* __restrict__ rank,
                                                int32_t fv, long long start,
                                                long long width, long long step) {
  int32_t best = INT_MAX;
  for (long long j = start; j < width; j += step) {
    const int32_t rk = __ldg(rank + j);
    if (rk < best && __ldg(fragment + __ldg(dst + j)) != fv) best = rk;
  }
  return best;
}

// W <= 512: `group` lanes a row, 32 / group rows a warp.
__global__ void ell_row_min_warp_kernel(const int32_t* __restrict__ fragment,
                                        const int32_t* __restrict__ verts,
                                        const int32_t* __restrict__ dstb,
                                        const int32_t* __restrict__ rankb,
                                        int32_t* __restrict__ out, long long rows,
                                        long long width, int group) {
  const int lane = threadIdx.x & 31;
  const int sub = lane / group;  // which of the warp's rows
  const int col = lane % group;  // lane within the row's group
  const long long rows_per_warp = 32 / group;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  // r0 is the same for every lane of a warp, so all 32 lanes reach the shuffles.
  for (long long r0 = warp * rows_per_warp; r0 < rows; r0 += warps * rows_per_warp) {
    const long long r = r0 + sub;
    int32_t best = INT_MAX;
    if (r < rows) {
      const long long base = r * width;
      best = lane_row_min(fragment, dstb + base, rankb + base,
                          __ldg(fragment + __ldg(verts + r)), col, width, group);
    }
    for (int off = group >> 1; off > 0; off >>= 1) {
      best = min(best, __shfl_xor_sync(kFullMask, best, off));
    }
    if (r < rows && col == 0) out[r] = best;
  }
}

// W > 512: a block a row.
__global__ void ell_row_min_block_kernel(const int32_t* __restrict__ fragment,
                                         const int32_t* __restrict__ verts,
                                         const int32_t* __restrict__ dstb,
                                         const int32_t* __restrict__ rankb,
                                         int32_t* __restrict__ out, long long rows,
                                         long long width) {
  __shared__ int32_t warp_best[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const long long base = r * width;
    int32_t best = lane_row_min(fragment, dstb + base, rankb + base,
                                __ldg(fragment + __ldg(verts + r)), threadIdx.x, width,
                                blockDim.x);
    for (int off = 16; off > 0; off >>= 1) {
      best = min(best, __shfl_xor_sync(kFullMask, best, off));
    }
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = lane < warps ? warp_best[lane] : INT_MAX;
      for (int off = 16; off > 0; off >>= 1) {
        best = min(best, __shfl_xor_sync(kFullMask, best, off));
      }
      if (lane == 0) out[r] = best;
    }
    __syncthreads();  // warp_best is rewritten for the next row
  }
}

}  // namespace

extern "C" int ghs_ell_row_min(int device, const void* fragment, const void* verts,
                               const void* dstb, const void* rankb, void* out,
                               long long rows, long long width, void* stream) {
  const ghs::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (rows <= 0 || width <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* f = (const int32_t*)fragment;
  const int32_t* v = (const int32_t*)verts;
  const int32_t* d = (const int32_t*)dstb;
  const int32_t* k = (const int32_t*)rankb;
  int32_t* o = (int32_t*)out;
  if (width <= kWarpLayoutMaxWidth) {
    int group = 1;
    while (group < 32 && 2LL * group <= width) group *= 2;
    const long long rows_per_warp = 32 / group;
    const long long warps = (rows + rows_per_warp - 1) / rows_per_warp;
    const long long blocks = (warps * 32 + kWarpLayoutThreads - 1) / kWarpLayoutThreads;
    const unsigned grid = (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
    ell_row_min_warp_kernel<<<grid, kWarpLayoutThreads, 0, s>>>(f, v, d, k, o, rows, width,
                                                                 group);
  } else {
    long long threads = width / 4;  // at least 4 slots a thread
    if (threads > 1024) threads = 1024;
    threads = threads / 32 * 32;    // whole warps: width > 512 gives at least 128
    const unsigned grid = (unsigned)(rows < kMaxBlocks ? rows : kMaxBlocks);
    ell_row_min_block_kernel<<<grid, (unsigned)threads, 0, s>>>(f, v, d, k, o, rows, width);
  }
  return (int)cudaGetLastError();
}
