// K1 hook_compress: one merge round of the Borůvka solve, in one launch.
//
// Replaces fused_hook_compress (distributed_ghs_implementation_tpu/ops/
// pallas_kernels.py:516, body _hook_compress_kernel :442), the same
// contract as union_find.hook_and_compress:
//   parent0[i] = has[i] ? dst_frag[i] : i
//   a mutual pair f <-> g: the smaller id becomes its own root
//   up to num_jumps synchronous pointer jumps: q[i] = p[p[i]]
//   new_fragment[v] = parent[fragment[v]]
//
// Hazard: every phase must finish everywhere before the next starts. A
// jump over an unbroken 2-cycle makes both fragments roots and loses the
// merge, and a jump that reads a half-written buffer is no longer the
// synchronous jump the plain version makes. The TPU kernel held the whole
// parent array in one core's VMEM. Here one launch does the round, in one
// of two forms picked by n:
//
// * block form (n <= kBlockFormThreshold): one block of 1,024 threads keeps
//   parent and its ping-pong buffer in shared memory (8 B a node) and
//   separates the phases with __syncthreads();
// * grid form: a persistent cooperative grid, as many blocks as fit on the
//   card at once, with cooperative_groups' grid sync between the phases.
//   The ping-pong buffers are parent and scratch in device memory (at the
//   solver's sizes they sit in the 50 MB L2); blocks read what other blocks
//   wrote, so those reads go through L2 (__ldcg), never the non-coherent
//   read-only path.
//
// Exact early exit: jumps stay synchronous (ping-pong). After jump k each
// block ORs "some q[i] != p[i]" into flag k (the grid form keeps one flag a
// jump in scratch, zeroed before the first barrier, so no flag is reset
// while it is read; the block form uses __syncthreads_or). When the flag is
// zero, jump k changed nothing: p is the fixpoint, which every later jump
// would keep, so stopping gives what all num_jumps jumps give. A cyclic
// input never reaches a fixpoint and runs all num_jumps jumps, as the plain
// version does. The jumps taken and the form land in a read-out after the
// flags.
//
// Bound on the H100: 17 B a node of device memory, 1.3 us at n = 2^18; the
// round is bound by its barriers (one launch, num_jumps + 2 grid syncs at
// most) and, in the block form, by one SM's shared-memory rate.

#include <cooperative_groups.h>

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlockThreads = 1024;
// Two int32 buffers of n in the 227 KB of shared memory one block can have.
constexpr long long kBlockMaxNodes = 232448 / 8;
// Up to this n the launcher picks the block form. chip_smoke.py's "K1
// forms" line times both forms: on an H100 the block form took less device
// time up to n = 8,192 and the grid form from 16,384 on (one SM's shared
// memory against the whole card's L2); by CUDA events, which the host
// bounds at these sizes, the two tied.
constexpr long long kBlockFormThreshold = 8192;
constexpr int kGridThreads = 512;
constexpr int kMaxDevices = 64;

enum Form { kAuto = 0, kBlock = 1, kGrid = 2 };

__global__ void __launch_bounds__(kBlockThreads)
hook_compress_block_kernel(const uint8_t* __restrict__ has, const int32_t* __restrict__ dst_frag,
                           const int32_t* __restrict__ fragment,
                           int32_t* __restrict__ new_fragment, int32_t* __restrict__ parent,
                           int32_t* __restrict__ readout, int n, int num_jumps) {
  extern __shared__ int32_t smem[];
  int32_t* p = smem;
  int32_t* q = smem + n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) q[i] = has[i] ? __ldg(dst_frag + i) : i;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int32_t p0i = q[i];
    p[i] = (q[p0i] == i && i < p0i) ? i : p0i;
  }
  __syncthreads();
  int jumps = 0;
  while (jumps < num_jumps) {
    int changed = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int32_t pi = p[i];
      const int32_t v = p[pi];
      q[i] = v;
      changed |= v != pi;
    }
    ++jumps;
    int32_t* t = p;
    p = q;
    q = t;
    if (!__syncthreads_or(changed)) break;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    parent[i] = p[i];
    new_fragment[i] = p[__ldg(fragment + i)];
  }
  if (threadIdx.x == 0) {
    readout[0] = jumps;
    readout[1] = kBlock;
  }
}

__global__ void __launch_bounds__(kGridThreads)
hook_compress_grid_kernel(const uint8_t* __restrict__ has, const int32_t* __restrict__ dst_frag,
                          const int32_t* __restrict__ fragment, int32_t* new_fragment,
                          int32_t* parent, int32_t* scratch, long long n, int num_jumps) {
  cg::grid_group grid = cg::this_grid();
  int32_t* flags = scratch + n;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (start < num_jumps) flags[start] = 0;
  for (long long i = start; i < n; i += stride) {
    const int32_t me = (int32_t)i;
    const int32_t p0i = has[i] ? __ldg(dst_frag + i) : me;
    const int32_t p0j = has[p0i] ? __ldg(dst_frag + p0i) : p0i;
    __stcg(parent + i, (p0j == me && me < p0i) ? me : p0i);
  }
  grid.sync();
  int32_t* bufs[2] = {parent, scratch};
  int cur = 0;
  int jumps = 0;
  while (jumps < num_jumps) {
    const int32_t* p = bufs[cur];
    int32_t* q = bufs[cur ^ 1];
    int changed = 0;
    for (long long i = start; i < n; i += stride) {
      const int32_t pi = __ldcg(p + i);
      const int32_t v = __ldcg(p + pi);
      __stcg(q + i, v);
      changed |= v != pi;
    }
    if (__syncthreads_or(changed) && threadIdx.x == 0) flags[jumps] = 1;
    grid.sync();
    const bool more = __ldcg(flags + jumps) != 0;
    ++jumps;
    if (!more) {  // q == p: the result is in both buffers, parent among them
      cur = 0;
      break;
    }
    cur ^= 1;
  }
  const int32_t* result = bufs[cur];
  for (long long i = start; i < n; i += stride) {
    if (cur) __stcg(parent + i, __ldcg(result + i));
    new_fragment[i] = __ldcg(result + __ldg(fragment + i));
  }
  if (start == 0) {
    flags[num_jumps] = jumps;
    flags[num_jumps + 1] = kGrid;
  }
}

// Co-resident blocks of the grid form, queried once per device: each host
// microsecond of a call shows in the round's time.
cudaError_t grid_blocks(int device, int* out) {
  static int cached[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!cached[device]) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hook_compress_grid_kernel, kGridThreads, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (per_sm * sms <= 0) return cudaErrorCooperativeLaunchTooLarge;
    cached[device] = per_sm * sms;
  }
  *out = cached[device];
  return cudaSuccess;
}

// The block form's shared memory above 48 KB, allowed once per device.
cudaError_t allow_block_smem(int device) {
  static bool done[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[device]) {
    const cudaError_t err = cudaFuncSetAttribute(hook_compress_block_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)(8 * kBlockMaxNodes));
    if (err != cudaSuccess) return err;
    done[device] = true;
  }
  return cudaSuccess;
}

}  // namespace

// scratch holds n + num_jumps + 2 int32: the grid form's ping-pong buffer,
// one flag a jump, then the read-out (jumps taken, form run). form: 0 picks
// by n, 1 forces the block form (refused above kBlockMaxNodes), 2 the grid
// form. The result lands in parent whatever the parity of the jumps.
extern "C" int ghs_hook_compress(int device, const void* has, const void* dst_frag,
                                 const void* fragment, void* new_fragment, void* parent,
                                 void* scratch, long long n, int num_jumps, int form,
                                 void* stream) {
  const ghs::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (n <= 0 || num_jumps <= 0 || form < kAuto || form > kGrid) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* h = (const uint8_t*)has;
  const int32_t* d = (const int32_t*)dst_frag;
  const int32_t* f = (const int32_t*)fragment;
  int32_t* nf = (int32_t*)new_fragment;
  int32_t* p = (int32_t*)parent;
  int32_t* sc = (int32_t*)scratch;
  if (form == kAuto) form = n <= kBlockFormThreshold ? kBlock : kGrid;
  cudaError_t err;
  if (form == kBlock) {
    if (n > kBlockMaxNodes) return (int)cudaErrorInvalidValue;
    if ((err = allow_block_smem(device)) != cudaSuccess) return (int)err;
    hook_compress_block_kernel<<<1, kBlockThreads, (size_t)(8 * n), s>>>(
        h, d, f, nf, p, sc + n + num_jumps, (int)n, num_jumps);
    return (int)cudaGetLastError();
  }
  int resident = 0;
  if ((err = grid_blocks(device, &resident)) != cudaSuccess) return (int)err;
  const long long need = (n + kGridThreads - 1) / kGridThreads;
  const unsigned blocks = (unsigned)(need < resident ? need : resident);
  void* args[] = {(void*)&h, (void*)&d, (void*)&f, (void*)&nf, (void*)&p, (void*)&sc,
                  (void*)&n, (void*)&num_jumps};
  return (int)cudaLaunchCooperativeKernel((const void*)hook_compress_grid_kernel, dim3(blocks),
                                          dim3(kGridThreads), args, 0, s);
}
