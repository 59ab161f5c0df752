// K7 rank_order: the edge ids in (weight, edge id) order, the rank route's
// rank order, and rank_endpoints, the endpoint gather that follows it.
//
// Replaces no TPU kernel. The JAX package sorts on the host
// (graphs/edgelist.py rank_order: a native counting sort of integer
// weights, a stable argsort of the others) and gathers the rank endpoints
// there. On the H100 the raw w is staged as it is, u and v narrowed to
// int32, and both steps run on the card:
//   order[r] = the edge of rank r, a stable sort of an unsigned key of w
//   ra[r] = u[order[r]], rb[r] = v[order[r]] for r < m; 0 for m <= r < m_pad
//
// Two key forms, one sort:
// - 32-bit keys, w - wlow, for integer weights whose range spans at most
//   2^22 values (the host's counting-sort rule): ceil(bits(range) / 8)
//   passes, every one run (one for weights 1..255, two for road lengths).
// - 64-bit keys for every other w: int64 as w ^ 2^63, float64 as its bits
//   made order-preserving (-0.0 read as +0.0, every NaN as one positive
//   quiet NaN, then the sign bit flipped for a non-negative value and every
//   bit flipped for a negative one), so unsigned key order is NumPy's
//   stable argsort order: -inf < negatives < zeros < positives < inf < NaN.
//   A first read of all keys (rank_key_bits) ORs and ANDs them: a digit is
//   the same in every key exactly where its bits' OR equals their AND, and
//   the wrapper passes only the other digits (at most 8) to the sort.
//
// Bound on the H100: bytes. The sort reads w (8 B an edge) and writes
// order (4 B): at Graph500 scale 23 (129.3M edges) 1.55 GB, 0.46 ms at
// 3.35 TB/s. The gather reads order, u and v (12 B an edge) and writes ra
// and rb (8 B a padded rank).
//
// The sort is a stable LSD radix sort, 8-bit digits. A pass is three
// launches over tiles of 4,096 keys:
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
//   consecutive places of one digit's run, so the stores coalesce. Its
//   shared memory is dynamic: a tile of 64-bit keys needs 58 KB, over the
//   48 KB a static allocation may hold.
// The first pass makes the keys in registers from w and its values are the
// edge ids, iota, never read. Later passes read the key and value the
// previous pass wrote, and the last pass writes no key. A onesweep pass
// (decoupled look-back in place of the histogram and scan launches) would
// read the keys once less; at one pass over the scale-23 graph the two
// reads of w are about 0.6 ms.
//
// 8-bit digits for both forms: one thread a digit in the scan and the
// scatter's per-digit steps, and a tile's per-warp counters (8 warps x 257)
// fit beside its keys. An 11-bit digit would take a 64-bit key in 6 passes
// instead of 8, but its per-warp counters alone (8 x 2,049 x 4 B = 64 KB)
// would cut the blocks an SM holds to one or two.
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
constexpr int kMaxPasses = 3;               // 32-bit keys: 2^22 values need 22 bits
constexpr int kDigits64 = 8;                // 64-bit keys: at most 8 passes
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kSign = 1ULL << 63;
static_assert(kThreads == kRadix, "one thread a digit");

// Where a pass reads its keys: the previous pass's keys, or w on the first
// pass (w - wlow, int64 w ^ 2^63, or float64 bits made order-preserving).
enum class Src { kKeys, kOffset, kInt64, kFloat64 };

// The unsigned key of a float64 whose bits are `bits`, in NumPy's order.
__device__ __forceinline__ unsigned long long float_key(long long bits) {
  if (bits == (long long)kSign) bits = 0;                     // -0.0 as +0.0
  if ((bits & 0x7fffffffffffffffLL) > 0x7ff0000000000000LL) {
    bits = 0x7ff8000000000000LL;                              // every NaN, last
  }
  return bits < 0 ? ~(unsigned long long)bits : (unsigned long long)bits | kSign;
}

// The key of element i. A float64 w is read as its 64 bits.
template <typename Key, Src kSrc>
__device__ __forceinline__ Key key_at(const long long* __restrict__ w, long long wlow,
                                      const Key* __restrict__ keys, long long i) {
  if constexpr (kSrc == Src::kKeys) {
    return keys[i];
  } else if constexpr (kSrc == Src::kOffset) {
    return (Key)(w[i] - wlow);
  } else if constexpr (kSrc == Src::kInt64) {
    return (Key)((unsigned long long)w[i] ^ kSign);
  } else {
    return (Key)float_key(w[i]);
  }
}

template <typename Key>
__device__ __forceinline__ uint32_t digit_of(Key key, int shift) {
  return (uint32_t)(key >> shift) & (kRadix - 1);
}

template <typename Key, Src kSrc>
__global__ void __launch_bounds__(kThreads)
    histogram_kernel(const long long* __restrict__ w, long long wlow,
                     const Key* __restrict__ keys, int32_t* __restrict__ hist, long long m,
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
    if (i < m) digit = digit_of(key_at<Key, kSrc>(w, wlow, keys, i), shift);
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

// The scatter's shared memory: per warp and digit, the warp's running count,
// then the count of the tile's keys of that digit in the warps before it
// (column kRadix counts the keys past m, which are never written); where
// each digit's run starts in the tile; the global place of the tile's key
// at tile place 0; then the tile laid out by digit.
template <typename Key>
struct ScatterShared {
  int32_t warp[kWarps][kRadix + 1];
  int32_t start[kRadix + 1];
  int32_t dst[kRadix];
  int32_t warp_sums[kWarps];
  Key key[kTile];
  int32_t val[kTile];
};

template <typename Key, Src kSrc, bool kLast>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const long long* __restrict__ w, long long wlow,
                   const Key* __restrict__ keys_in, const int32_t* __restrict__ vals_in,
                   Key* __restrict__ keys_out, int32_t* __restrict__ vals_out,
                   const int32_t* __restrict__ hist, const int32_t* __restrict__ totals,
                   long long m, long long tiles, int shift) {
  constexpr bool kFirst = kSrc != Src::kKeys;
  extern __shared__ __align__(16) unsigned char shared_bytes[];
  ScatterShared<Key>& sh = *reinterpret_cast<ScatterShared<Key>*>(shared_bytes);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < kWarps * (kRadix + 1); k += kThreads) {
    (&sh.warp[0][0])[k] = 0;
  }
  __syncthreads();

  // 1. Each warp ranks its contiguous 512 keys in order, 32 a step.
  const long long wbase = (long long)blockIdx.x * kTile + (long long)warp * kWarpKeys;
  const unsigned below = (1u << lane) - 1;
  Key key[kItems];
  int32_t val[kItems];
  int32_t rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = wbase + j * 32 + lane;
    uint32_t digit = kRadix;
    key[j] = 0;
    val[j] = 0;
    if (i < m) {
      key[j] = key_at<Key, kSrc>(w, wlow, keys_in, i);
      val[j] = kFirst ? (int32_t)i : vals_in[i];
      digit = digit_of(key[j], shift);
    }
    const unsigned peers = __match_any_sync(kFull, digit);
    const int32_t seen = sh.warp[warp][digit];
    rank[j] = seen + __popc(peers & below);
    __syncwarp();
    if (lane == __ffs(peers) - 1) sh.warp[warp][digit] = seen + __popc(peers);
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
      const int32_t c = sh.warp[q][d];
      sh.warp[q][d] = count;
      count += c;
    }
    int32_t valid, all;
    const int32_t start = block_exclusive_scan(count, sh.warp_sums, &valid);
    const int32_t base = block_exclusive_scan(totals[d], sh.warp_sums, &all);
    sh.start[d] = start;
    if (d == kRadix - 1) sh.start[kRadix] = valid;
    sh.dst[d] = base + hist[(long long)d * tiles + blockIdx.x] - start;
  }
  __syncthreads();

  // 3. The tile's keys laid out by digit in shared memory, stably.
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (wbase + j * 32 + lane < m) {
      const int d = digit_of(key[j], shift);
      const int at = sh.start[d] + sh.warp[warp][d] + rank[j];
      sh.key[at] = key[j];
      sh.val[at] = val[j];
    }
  }
  __syncthreads();

  // 4. Out in tile order: a digit's run goes to consecutive global places.
  const int valid = sh.start[kRadix];
  for (int at = threadIdx.x; at < valid; at += kThreads) {
    const Key k = sh.key[at];
    const long long to = (long long)sh.dst[digit_of(k, shift)] + at;
    vals_out[to] = sh.val[at];
    if (!kLast) keys_out[to] = k;
  }
}

template <typename Key, Src kSrc, bool kLast>
cudaError_t launch_scatter_as(unsigned grid, cudaStream_t s, const long long* w, long long wlow,
                              const Key* keys_in, const int32_t* vals_in, Key* keys_out,
                              int32_t* vals_out, const int32_t* hist, const int32_t* totals,
                              long long m, long long tiles, int shift) {
  constexpr int kBytes = (int)sizeof(ScatterShared<Key>);
  const cudaError_t err = cudaFuncSetAttribute(
      scatter_kernel<Key, kSrc, kLast>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  scatter_kernel<Key, kSrc, kLast><<<grid, kThreads, kBytes, s>>>(
      w, wlow, keys_in, vals_in, keys_out, vals_out, hist, totals, m, tiles, shift);
  return cudaSuccess;
}

template <typename Key, Src kSrc>
cudaError_t launch_pass(bool last, unsigned grid, cudaStream_t s, const long long* w,
                        long long wlow, const Key* keys_in, const int32_t* vals_in,
                        Key* keys_out, int32_t* vals_out, int32_t* hist, int32_t* totals,
                        long long m, long long tiles, int shift) {
  histogram_kernel<Key, kSrc><<<grid, kThreads, 0, s>>>(w, wlow, keys_in, hist, m, tiles, shift);
  scan_kernel<<<kRadix, kThreads, 0, s>>>(hist, totals, tiles);
  if (last) {
    return launch_scatter_as<Key, kSrc, true>(grid, s, w, wlow, keys_in, vals_in, keys_out,
                                              vals_out, hist, totals, m, tiles, shift);
  }
  return launch_scatter_as<Key, kSrc, false>(grid, s, w, wlow, keys_in, vals_in, keys_out,
                                             vals_out, hist, totals, m, tiles, shift);
}

// The passes of one sort, one a digit set in `digits` (bit d: the digit at
// shift 8d), lowest first; the first makes its keys from w as kFirstSrc
// says. The values ping-pong between vals_a and order so that the last pass
// writes order; the keys between keys_a and keys_b.
template <typename Key, Src kFirstSrc>
cudaError_t sort_passes(cudaStream_t s, const long long* w, long long wlow, unsigned digits,
                        int32_t* order, Key* keys_a, Key* keys_b, int32_t* vals_a,
                        int32_t* hist, int32_t* totals, long long m) {
  const long long tiles = (m + kTile - 1) / kTile;
  const unsigned grid = (unsigned)tiles;
  const int passes = __builtin_popcount(digits);
  const Key* keys_in = nullptr;
  const int32_t* vals_in = nullptr;
  for (int d = 0, p = 0; p < passes; ++d) {
    if (!((digits >> d) & 1u)) continue;
    const bool last = p == passes - 1;
    int32_t* vals_out = (passes - 1 - p) % 2 == 0 ? order : vals_a;
    Key* keys_out = last ? nullptr : (p % 2 == 0 ? keys_a : keys_b);
    cudaError_t err;
    if (p == 0) {
      err = launch_pass<Key, kFirstSrc>(last, grid, s, w, wlow, nullptr, nullptr, keys_out,
                                        vals_out, hist, totals, m, tiles, 8 * d);
    } else {
      err = launch_pass<Key, Src::kKeys>(last, grid, s, nullptr, 0, keys_in, vals_in, keys_out,
                                         vals_out, hist, totals, m, tiles, 8 * d);
    }
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    keys_in = keys_out;
    vals_in = vals_out;
    ++p;
  }
  return cudaSuccess;
}

// The OR (bits[0]) and the AND (bits[1]) of every 64-bit key, folded in
// with atomics into words the launcher presets to 0 and ~0.
template <Src kSrc>
__global__ void __launch_bounds__(kThreads)
    key_bits_kernel(const long long* __restrict__ w, unsigned long long* __restrict__ bits,
                    long long m) {
  __shared__ unsigned long long s_any[kWarps], s_all[kWarps];
  unsigned long long any = 0, all = ~0ULL;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < m; i += step) {
    const unsigned long long k = key_at<unsigned long long, kSrc>(w, 0, nullptr, i);
    any |= k;
    all &= k;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    any |= __shfl_xor_sync(kFull, any, d);
    all &= __shfl_xor_sync(kFull, all, d);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_any[warp] = any;
    s_all[warp] = all;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 1; q < kWarps; ++q) {
      any |= s_any[q];
      all &= s_all[q];
    }
    atomicOr(bits, any);
    atomicAnd(bits + 1, all);
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

constexpr int kKindInt64 = 0;
constexpr int kKindFloat64 = 1;

}  // namespace

// int32 words of scratch a sort of m 32-bit keys in `passes` passes needs:
// the digit-major histogram, the digit totals, then a key buffer and a
// value buffer for a second pass and one more key buffer for a third. The
// wrapper allocates what this says.
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
  const long long tiles = (m + kTile - 1) / kTile;
  int32_t* hist = (int32_t*)scratch;
  int32_t* totals = hist + kRadix * tiles;
  uint32_t* keys_a = (uint32_t*)(totals + kRadix);
  int32_t* vals_a = (int32_t*)(keys_a + m);
  uint32_t* keys_b = (uint32_t*)(vals_a + m);
  return (int)sort_passes<uint32_t, Src::kOffset>(
      (cudaStream_t)stream, (const long long*)w, wlow, (1u << passes) - 1, (int32_t*)order,
      keys_a, keys_b, vals_a, hist, totals, m);
}

// The OR and the AND of the 64-bit keys of m int64 (kind 0) or float64
// (kind 1) weights, into bits[0] and bits[1] (two 64-bit words on the card).
extern "C" int ghs_rank_key_bits(int device, const void* w, int kind, void* bits, long long m,
                                 void* stream) {
  const ghs::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if ((kind != kKindInt64 && kind != kKindFloat64) || m < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* out = (unsigned long long*)bits;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned long long), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(out + 1, 0xff, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (m + kThreads - 1) / kThreads;
  if (blocks > 132LL * 8) blocks = 132LL * 8;
  if (kind == kKindInt64) {
    key_bits_kernel<Src::kInt64><<<(unsigned)blocks, kThreads, 0, s>>>((const long long*)w, out, m);
  } else {
    key_bits_kernel<Src::kFloat64><<<(unsigned)blocks, kThreads, 0, s>>>((const long long*)w, out,
                                                                         m);
  }
  return (int)cudaGetLastError();
}

// Bytes of scratch a sort of m 64-bit keys in `passes` passes needs: the
// histogram and the totals, then for a second pass a key buffer (8 B a key)
// and a value buffer (4 B), and for a third one more key buffer.
extern "C" long long ghs_rank_order64_scratch(long long m, int passes) {
  const long long tiles = (m + kTile - 1) / kTile;
  return 4LL * kRadix * (tiles + 1) + (passes >= 2 ? 12 * m : 0) + (passes >= 3 ? 8 * m : 0);
}

// The stable sort of m 64-bit keys of int64 (kind 0) or float64 (kind 1)
// weights over the digits set in `digits` (bit d: the digit at shift 8d),
// at least one: the other digits are the same in every key.
extern "C" int ghs_rank_order64(int device, const void* w, int kind, int digits, void* order,
                                void* scratch, long long scratch_bytes, long long m,
                                void* stream) {
  const ghs::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const int passes = __builtin_popcount((unsigned)digits);
  if ((kind != kKindInt64 && kind != kKindFloat64) || digits < 1 ||
      digits >= (1 << kDigits64) || m < 1 || m > 0x7fffffffLL ||
      scratch_bytes < ghs_rank_order64_scratch(m, passes)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles = (m + kTile - 1) / kTile;
  int32_t* hist = (int32_t*)scratch;
  int32_t* totals = hist + kRadix * tiles;
  // 4 * kRadix * (tiles + 1) bytes so far, a multiple of 8: the key buffers
  // first, then the value buffer.
  unsigned long long* keys_a = (unsigned long long*)(totals + kRadix);
  unsigned long long* keys_b = keys_a + (passes >= 2 ? m : 0);
  int32_t* vals_a = (int32_t*)(keys_b + (passes >= 3 ? m : 0));
  cudaStream_t s = (cudaStream_t)stream;
  const long long* w64 = (const long long*)w;
  const cudaError_t err =
      kind == kKindInt64
          ? sort_passes<unsigned long long, Src::kInt64>(s, w64, 0, (unsigned)digits,
                                                         (int32_t*)order, keys_a, keys_b, vals_a,
                                                         hist, totals, m)
          : sort_passes<unsigned long long, Src::kFloat64>(s, w64, 0, (unsigned)digits,
                                                           (int32_t*)order, keys_a, keys_b,
                                                           vals_a, hist, totals, m);
  return (int)err;
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
