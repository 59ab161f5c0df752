// K7 rank_order: the edge ids in (weight, edge id) order, the rank route's
// rank order, and rank_endpoints, the endpoint gather that follows it.
//
// Replaces no TPU kernel. The JAX package sorts on the host
// (graphs/edgelist.py rank_order: a native counting sort of integer
// weights, a stable argsort of the others) and gathers the rank endpoints
// there. On the H100 the raw w is staged as it is, u and v narrowed to
// int32, and both steps run on the card:
//   order[r] = the edge of rank r, a stable sort of key = w - wlow
//   ra[r] = u[order[r]], rb[r] = v[order[r]] for r < m; 0 for m <= r < m_pad
// The wrapper takes this path for integer weights whose range spans at most
// 2^22 values (the host's counting-sort rule), so a key fits 22 bits.
//
// Bound on the H100: bytes. The sort reads w (8 B an edge) and writes
// order (4 B): at Graph500 scale 23 (129.3M edges) 1.55 GB, 0.46 ms at
// 3.35 TB/s. The gather reads order, u and v (12 B an edge) and writes ra
// and rb (8 B a padded rank).
//
// The sort is a stable LSD radix sort, 8-bit digits, ceil(bits(range) / 8)
// passes (one for weights 1..255, two for road lengths up to 2^16). A pass
// is three launches over tiles of 4,096 keys:
// - histogram: each tile's digit counts (shared-memory counters, one atomic
//   per run of equal digits in a warp, found with __match_any_sync), stored
//   digit-major, hist[d * tiles + t];
// - scan: one block a digit scans its row, so that hist[d * tiles + t] is
//   where tile t's keys of digit d start among all keys of digit d, and
//   totals[d] counts them;
// - scatter: each warp ranks its 512 contiguous keys in order (a running
//   count a digit, plus the lanes below with the same digit), the block adds
//   the warps before it, and the tile's keys are laid out by digit in
//   shared memory, then written from there: consecutive threads write
//   consecutive places of one digit's run, so the stores coalesce.
// The first pass reads the keys straight from the int64 w and its values
// are the edge ids, iota, never read. Later passes read the int32 key and
// value the previous pass wrote, and the last pass writes no key. A onesweep
// pass (decoupled look-back in place of the histogram and scan launches)
// would read the keys once less; at one pass over the scale-23 graph the
// two reads of w are about 0.6 ms.
//
// The gather reads order with streaming loads and u, v (int32, narrowed on
// the host as they were staged) at random: in one weight's run of ranks the
// edge ids ascend, so its reads walk forward through u and v, a 32-byte
// sector per read.

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                  // keys a thread holds in a tile
constexpr int kTile = kThreads * kItems;    // 4,096 keys a tile
constexpr int kWarpKeys = kTile / kWarps;   // 512: one warp's contiguous share
constexpr int kRadix = 256;                 // 8-bit digits; kRadix marks a key past m
constexpr int kMaxPasses = 3;               // 2^22 values need 22 bits
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == kRadix, "one thread a digit");

// The key of element i: w[i] - wlow on the first pass, the key the previous
// pass wrote after it.
template <bool kFirst>
__device__ __forceinline__ uint32_t key_at(const long long* __restrict__ w, long long wlow,
                                           const int32_t* __restrict__ keys, long long i) {
  if (kFirst) return (uint32_t)(w[i] - wlow);
  return (uint32_t)keys[i];
}

template <bool kFirst>
__global__ void __launch_bounds__(kThreads)
    histogram_kernel(const long long* __restrict__ w, long long wlow,
                     const int32_t* __restrict__ keys, int32_t* __restrict__ hist, long long m,
                     long long tiles, int shift) {
  __shared__ int32_t counts[kRadix];
  counts[threadIdx.x] = 0;  // kThreads == kRadix
  __syncthreads();
  const long long base = (long long)blockIdx.x * kTile;
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + (long long)j * kThreads + threadIdx.x;
    uint32_t digit = kRadix;
    if (i < m) digit = (key_at<kFirst>(w, wlow, keys, i) >> shift) & (kRadix - 1);
    const unsigned peers = __match_any_sync(kFull, digit);
    if (digit < kRadix && lane == __ffs(peers) - 1) atomicAdd(&counts[digit], __popc(peers));
  }
  __syncthreads();
  hist[(long long)threadIdx.x * tiles + blockIdx.x] = counts[threadIdx.x];
}

// Exclusive prefix of x over the block's threads, in thread order; *total
// gets the sum. warp_sums holds kWarps entries; the block is synchronised on
// return, so the caller may reuse warp_sums.
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t x, int32_t* warp_sums,
                                                        int32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int32_t before = 0, sum = 0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    const int32_t s = warp_sums[q];
    before += q < warp ? s : 0;
    sum += s;
  }
  __syncthreads();
  *total = sum;
  return before + incl - x;
}

// One block a digit: row d of hist becomes its exclusive scan over the
// tiles, and totals[d] the row's sum.
__global__ void __launch_bounds__(kThreads)
    scan_kernel(int32_t* __restrict__ hist, int32_t* __restrict__ totals, long long tiles) {
  __shared__ int32_t warp_sums[kWarps];
  int32_t* row = hist + (long long)blockIdx.x * tiles;
  constexpr int kPer = 4;
  int32_t carry = 0;
  for (long long start = 0; start < tiles; start += (long long)kThreads * kPer) {
    const long long first = start + (long long)threadIdx.x * kPer;
    int32_t v[kPer];
    int32_t sum = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      v[q] = first + q < tiles ? row[first + q] : 0;
      sum += v[q];
    }
    int32_t chunk;
    int32_t at = carry + block_exclusive_scan(sum, warp_sums, &chunk);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (first + q < tiles) row[first + q] = at;
      at += v[q];
    }
    carry += chunk;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

template <bool kFirst, bool kLast>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const long long* __restrict__ w, long long wlow,
                   const int32_t* __restrict__ keys_in, const int32_t* __restrict__ vals_in,
                   int32_t* __restrict__ keys_out, int32_t* __restrict__ vals_out,
                   const int32_t* __restrict__ hist, const int32_t* __restrict__ totals,
                   long long m, long long tiles, int shift) {
  // Per warp and digit: the warp's running count, then the count of the
  // tile's keys of that digit in the warps before it. Column kRadix counts
  // the keys past m, which are never written.
  __shared__ int32_t s_warp[kWarps][kRadix + 1];
  __shared__ int32_t s_start[kRadix + 1];  // where each digit's run starts in the tile
  __shared__ int32_t s_dst[kRadix];        // global place of the tile's key at tile place 0
  __shared__ int32_t warp_sums[kWarps];
  __shared__ uint32_t s_key[kTile];
  __shared__ int32_t s_val[kTile];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < kWarps * (kRadix + 1); k += kThreads) {
    (&s_warp[0][0])[k] = 0;
  }
  __syncthreads();

  // 1. Each warp ranks its contiguous 512 keys in order, 32 a step.
  const long long wbase = (long long)blockIdx.x * kTile + (long long)warp * kWarpKeys;
  const unsigned below = (1u << lane) - 1;
  uint32_t key[kItems];
  int32_t val[kItems];
  int32_t rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = wbase + j * 32 + lane;
    uint32_t digit = kRadix;
    key[j] = 0;
    val[j] = 0;
    if (i < m) {
      key[j] = key_at<kFirst>(w, wlow, keys_in, i);
      val[j] = kFirst ? (int32_t)i : vals_in[i];
      digit = (key[j] >> shift) & (kRadix - 1);
    }
    const unsigned peers = __match_any_sync(kFull, digit);
    const int32_t seen = s_warp[warp][digit];
    rank[j] = seen + __popc(peers & below);
    __syncwarp();
    if (lane == __ffs(peers) - 1) s_warp[warp][digit] = seen + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // 2. Thread d: digit d's count in the warps before each warp, the start of
  // its run in the tile, and the global place of the tile's key at place 0.
  {
    const int d = threadIdx.x;
    int32_t count = 0;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      const int32_t c = s_warp[q][d];
      s_warp[q][d] = count;
      count += c;
    }
    int32_t valid, all;
    const int32_t start = block_exclusive_scan(count, warp_sums, &valid);
    const int32_t base = block_exclusive_scan(totals[d], warp_sums, &all);
    s_start[d] = start;
    if (d == kRadix - 1) s_start[kRadix] = valid;
    s_dst[d] = base + hist[(long long)d * tiles + blockIdx.x] - start;
  }
  __syncthreads();

  // 3. The tile's keys laid out by digit in shared memory, stably.
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (wbase + j * 32 + lane < m) {
      const int d = (key[j] >> shift) & (kRadix - 1);
      const int at = s_start[d] + s_warp[warp][d] + rank[j];
      s_key[at] = key[j];
      s_val[at] = val[j];
    }
  }
  __syncthreads();

  // 4. Out in tile order: a digit's run goes to consecutive global places.
  const int valid = s_start[kRadix];
  for (int at = threadIdx.x; at < valid; at += kThreads) {
    const uint32_t k = s_key[at];
    const long long to = (long long)s_dst[(k >> shift) & (kRadix - 1)] + at;
    vals_out[to] = s_val[at];
    if (!kLast) keys_out[to] = (int32_t)k;
  }
}

template <bool kFirst>
void launch_scatter(bool last, unsigned grid, cudaStream_t s, const long long* w, long long wlow,
                    const int32_t* keys_in, const int32_t* vals_in, int32_t* keys_out,
                    int32_t* vals_out, const int32_t* hist, const int32_t* totals, long long m,
                    long long tiles, int shift) {
  if (last) {
    scatter_kernel<kFirst, true><<<grid, kThreads, 0, s>>>(w, wlow, keys_in, vals_in, keys_out,
                                                           vals_out, hist, totals, m, tiles, shift);
  } else {
    scatter_kernel<kFirst, false><<<grid, kThreads, 0, s>>>(w, wlow, keys_in, vals_in, keys_out,
                                                            vals_out, hist, totals, m, tiles, shift);
  }
}

__global__ void __launch_bounds__(kThreads)
    rank_endpoints_kernel(const int32_t* __restrict__ order, const int32_t* __restrict__ u,
                          const int32_t* __restrict__ v, int32_t* __restrict__ ra,
                          int32_t* __restrict__ rb, long long m, long long m_pad) {
  constexpr int kPer = 4;  // ranks a thread takes a step: 8 table reads in flight
  const long long step = (long long)gridDim.x * kThreads * kPer;
  for (long long r0 = (long long)blockIdx.x * kThreads * kPer + threadIdx.x; r0 < m_pad;
       r0 += step) {
    int32_t e[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const long long r = r0 + (long long)q * kThreads;
      e[q] = r < m ? __ldcs(order + r) : -1;
    }
    int32_t a[kPer], b[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      a[q] = e[q] >= 0 ? __ldg(u + e[q]) : 0;
      b[q] = e[q] >= 0 ? __ldg(v + e[q]) : 0;
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const long long r = r0 + (long long)q * kThreads;
      if (r < m_pad) {
        __stcs(ra + r, a[q]);
        __stcs(rb + r, b[q]);
      }
    }
  }
}

}  // namespace

// int32 words of scratch a sort of m keys in `passes` passes needs: the
// digit-major histogram, the digit totals, then a key buffer and a value
// buffer for a second pass and one more key buffer for a third. The wrapper
// allocates what this says.
extern "C" long long ghs_rank_order_scratch(long long m, int passes) {
  const long long tiles = (m + kTile - 1) / kTile;
  return kRadix * tiles + kRadix + (passes >= 2 ? 2 * m : 0) + (passes >= 3 ? m : 0);
}

extern "C" int ghs_rank_order(int device, const void* w, long long wlow, int passes, void* order,
                              void* scratch, long long scratch_words, long long m, void* stream) {
  const ghs::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (passes < 1 || passes > kMaxPasses || m < 1 || m > 0x7fffffffLL ||
      scratch_words < ghs_rank_order_scratch(m, passes)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (m + kTile - 1) / kTile;
  int32_t* hist = (int32_t*)scratch;
  int32_t* totals = hist + kRadix * tiles;
  int32_t* keys_a = totals + kRadix;
  int32_t* vals_a = keys_a + m;
  int32_t* keys_b = vals_a + m;
  const long long* w64 = (const long long*)w;
  const unsigned grid = (unsigned)tiles;
  const int32_t* keys_in = nullptr;
  const int32_t* vals_in = nullptr;
  for (int p = 0; p < passes; ++p) {
    const bool last = p == passes - 1;
    const int shift = 8 * p;
    // The values ping-pong between vals_a and order so that the last pass
    // writes order; the keys between keys_a and keys_b.
    int32_t* vals_out = (passes - 1 - p) % 2 == 0 ? (int32_t*)order : vals_a;
    int32_t* keys_out = last ? nullptr : (p % 2 == 0 ? keys_a : keys_b);
    if (p == 0) {
      histogram_kernel<true><<<grid, kThreads, 0, s>>>(w64, wlow, nullptr, hist, m, tiles, shift);
    } else {
      histogram_kernel<false><<<grid, kThreads, 0, s>>>(nullptr, 0, keys_in, hist, m, tiles,
                                                        shift);
    }
    scan_kernel<<<kRadix, kThreads, 0, s>>>(hist, totals, tiles);
    if (p == 0) {
      launch_scatter<true>(last, grid, s, w64, wlow, nullptr, nullptr, keys_out, vals_out, hist,
                           totals, m, tiles, shift);
    } else {
      launch_scatter<false>(last, grid, s, nullptr, 0, keys_in, vals_in, keys_out, vals_out, hist,
                            totals, m, tiles, shift);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    keys_in = keys_out;
    vals_in = vals_out;
  }
  return (int)cudaSuccess;
}

extern "C" int ghs_rank_endpoints(int device, const void* order, const void* u, const void* v,
                                  void* ra, void* rb, long long m, long long m_pad,
                                  void* stream) {
  const ghs::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const long long per_block = (long long)kThreads * 4;
  long long blocks = (m_pad + per_block - 1) / per_block;
  const long long max_blocks = 132LL * 16;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  rank_endpoints_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)order, (const int32_t*)u, (const int32_t*)v, (int32_t*)ra, (int32_t*)rb, m,
      m_pad);
  return (int)cudaGetLastError();
}
