// K3 ell_row_min: the masked row minima of a whole ELL level, folded into
// the per-vertex minima, in one launch.
//
// Replaces fused_ell_row_min (distributed_ghs_implementation_tpu/ops/
// pallas_kernels.py:465, body _ell_row_min_kernel :422), which computes
// one bucket's
//   row_min[r] = min_j (fragment[dstb[r,j]] != fragment[verts[r]] ? rankb[r,j] : INT32_MAX)
// and leaves the scatter-min into the per-vertex minima to XLA, one call
// and one scatter a bucket. Here one launch covers every bucket of a level
// and folds the scatter in:
//   out[verts[r]] = min(out[verts[r]], row_min[r])
// over all rows of all buckets, with an int32 atomicMin (order-free, so
// exact and the same in every run). The caller presets out to INT32_MAX. A
// row whose minimum is INT32_MAX makes no atomic: pad rows (which alias
// vertex 0) and rows with no outgoing slot. With row_indexed the target is
// out[r] instead: the one-bucket call of the per-bucket wrapper.
//
// Hazard: W ranges over 1 ... 32,768 within one level (RMAT-18: 65,536 rows
// of width 1 and one row of width 32,768), so a block a bucket or a row
// would leave most SMs idle on the wide buckets and serialise the hub row.
// The plan (ops/kernels.py: ell_plan) cuts the level into tiles of about
// equal slot count: several whole rows of a narrow bucket, or one chunk of
// one wide row. A block takes a tile; the hub row spreads over
// ceil(W / tile) blocks. The buckets' descriptors (at most kMaxBuckets)
// reach the kernel by value as a __grid_constant__ parameter; a block finds
// its bucket by scanning their first tiles. Inside a tile, g lanes take a
// row, g the largest power of two <= min(row segment, block); lanes reduce
// with __shfl_xor_sync within the warp, and each warp's lane 0 of a group
// makes the atomic, so a row split over warps or blocks makes a few.
//
// Bound on the H100: bytes. The dstb and rankb streams, 8 B a slot (137 MB
// for one RMAT-18 level), dominate; verts, fragment and out add about 4 MB.
// Neighbouring lanes read neighbouring slots, so the streams coalesce; the
// fragment gathers go through __ldg and the table stays in the 50 MB L2. A
// slot whose rank cannot lower the lane's running minimum skips its dstb
// read and its gather: on rank-sorted rows a lane stops gathering after its
// first outgoing slot. Offsets are 64-bit.

#include <climits>
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kMaxBuckets = 32;

// One bucket as the plan lays it out: nine 64-bit fields, in the order of
// ops/kernels.py's _ELL_FIELDS.
struct EllBucket {
  const int32_t* verts;
  const int32_t* dstb;
  const int32_t* rankb;
  long long rows;
  long long width;
  long long first_tile;
  long long rows_per_tile;  // 1 where a row splits into chunks
  long long seg;            // slots of a row a tile takes: width, or the chunk
  long long chunks;         // ceil(width / seg)
};
static_assert(sizeof(EllBucket) == 9 * 8, "EllBucket must match the plan's fields");

struct EllLevel {
  EllBucket b[kMaxBuckets];
  int count;
};
static_assert(sizeof(EllLevel) <= 4096, "kernel parameters are limited to 4 KB");

// The least rank among slots start, start + step, ... < end of one row
// (dst, rank already offset to the row) that leave fragment fv.
__device__ __forceinline__ int32_t lane_row_min(const int32_t* __restrict__ fragment,
                                                const int32_t* __restrict__ dst,
                                                const int32_t* __restrict__ rank,
                                                int32_t fv, long long start, long long end,
                                                long long step) {
  int32_t best = INT_MAX;
  for (long long j = start; j < end; j += step) {
    const int32_t rk = __ldg(rank + j);
    if (rk < best && __ldg(fragment + __ldg(dst + j)) != fv) best = rk;
  }
  return best;
}

__global__ void __launch_bounds__(kThreads)
ell_level_kernel(const __grid_constant__ EllLevel level, const int32_t* __restrict__ fragment,
                 int32_t* __restrict__ out, int row_indexed) {
  const long long tile = blockIdx.x;
  int k = 0;
  while (k + 1 < level.count && tile >= level.b[k + 1].first_tile) ++k;
  const EllBucket& b = level.b[k];
  const long long local = tile - b.first_tile;
  const long long r0 = local / b.chunks * b.rows_per_tile;
  const long long c0 = local % b.chunks * b.seg;
  const long long nrows = min(b.rows_per_tile, b.rows - r0);
  const long long c1 = min(b.width, c0 + b.seg);
  int g = 1;
  while (g < kThreads && 2LL * g <= c1 - c0) g *= 2;
  const int group = threadIdx.x / g;
  const int col = threadIdx.x % g;
  const int groups = kThreads / g;
  const int span = g < 32 ? g : 32;  // lanes of one group within one warp
  // base is the same for every thread of the block, so all lanes reach the shuffles.
  for (long long base = 0; base < nrows; base += groups) {
    const long long r = r0 + base + group;
    const bool valid = base + group < nrows;
    int32_t best = INT_MAX;
    int32_t v = 0;
    if (valid) {
      v = __ldg(b.verts + r);
      const long long row = r * b.width;
      best = lane_row_min(fragment, b.dstb + row, b.rankb + row, __ldg(fragment + v), c0 + col,
                          c1, g);
    }
    for (int off = span >> 1; off > 0; off >>= 1) {
      best = min(best, __shfl_xor_sync(kFullMask, best, off));
    }
    if (valid && (threadIdx.x & (span - 1)) == 0 && best != INT_MAX) {
      atomicMin(out + (row_indexed ? r : (long long)v), best);
    }
  }
}

}  // namespace

// desc: count buckets of nine 64-bit fields each (EllBucket), in host
// memory; tiles: the plan's tile count, one block a tile.
extern "C" int ghs_ell_level(int device, const void* fragment, void* out, const void* desc,
                             long long count, long long tiles, int row_indexed, void* stream) {
  const ghs::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (count <= 0 || count > kMaxBuckets || tiles <= 0 || tiles > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  EllLevel level;
  std::memcpy(level.b, desc, (size_t)count * sizeof(EllBucket));
  level.count = (int)count;
  ell_level_kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      level, (const int32_t*)fragment, (int32_t*)out, row_indexed);
  return (int)cudaGetLastError();
}
