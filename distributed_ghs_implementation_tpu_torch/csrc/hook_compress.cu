// K1 hook_compress: one merge round of the Borůvka solve.
//
// Replaces fused_hook_compress (distributed_ghs_implementation_tpu/ops/
// pallas_kernels.py:516, body _hook_compress_kernel :442), the same
// contract as union_find.hook_and_compress:
//   parent0[i] = has[i] ? dst_frag[i] : i
//   a mutual pair f <-> g: the smaller id becomes its own root
//   num_jumps pointer jumps: p[i] = p[p[i]]
//   new_fragment[v] = parent[fragment[v]]
//
// Hazard: the pair break must finish grid-wide before any jump starts. A
// jump over an unbroken 2-cycle makes both fragments roots and loses the
// merge. The TPU kernel held the whole parent array in one core's VMEM; on
// the H100 blocks run in no order, so each step is its own launch on one
// stream, which orders them: one launch computes parent0 inline and breaks
// the pairs, num_jumps launches jump between two ping-pong buffers, and one
// launch relabels. num_jumps = ceil(log2 n) reaches the fixpoint of any hook
// forest, the same fixpoint the early-exit jump loop stops at.
//
// Bound on the H100: at the solver's sizes (n <= 2^20, 4 MB a buffer) the
// arrays sit in the 50 MB L2, so the ~ceil(log2 n) + 2 launches, each a few
// microseconds of launch and drain, bound the round more than the bytes do.
// A single-block form that keeps small n in shared memory is later work.

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;

__global__ void hook_break_kernel(const uint8_t* __restrict__ has,
                                  const int32_t* __restrict__ dst_frag,
                                  int32_t* __restrict__ parent, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int32_t me = (int32_t)i;
    const int32_t p0i = has[i] ? __ldg(dst_frag + i) : me;
    const int32_t p0j = has[p0i] ? __ldg(dst_frag + p0i) : p0i;
    parent[i] = (p0j == me && me < p0i) ? me : p0i;
  }
}

__global__ void jump_kernel(const int32_t* __restrict__ p, int32_t* __restrict__ q,
                            long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    q[i] = __ldg(p + __ldg(p + i));
  }
}

__global__ void relabel_kernel(const int32_t* __restrict__ parent,
                               const int32_t* __restrict__ fragment,
                               int32_t* __restrict__ new_fragment, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    new_fragment[i] = __ldg(parent + __ldg(fragment + i));
  }
}

}  // namespace

// parent and scratch are the ping-pong pair; the result lands in parent.
extern "C" int ghs_hook_compress(int device, const void* has, const void* dst_frag,
                                 const void* fragment, void* new_fragment, void* parent,
                                 void* scratch, long long n, int num_jumps, void* stream) {
  const ghs::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  cudaError_t err;
  cudaStream_t s = (cudaStream_t)stream;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  int32_t* bufs[2] = {(int32_t*)parent, (int32_t*)scratch};
  int cur = num_jumps % 2;  // start where an even number of flips ends in parent
  hook_break_kernel<<<grid, kThreads, 0, s>>>((const uint8_t*)has, (const int32_t*)dst_frag,
                                              bufs[cur], n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int k = 0; k < num_jumps; ++k) {
    jump_kernel<<<grid, kThreads, 0, s>>>(bufs[cur], bufs[cur ^ 1], n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    cur ^= 1;
  }
  relabel_kernel<<<grid, kThreads, 0, s>>>(bufs[cur], (const int32_t*)fragment,
                                           (int32_t*)new_fragment, n);
  return (int)cudaGetLastError();
}
