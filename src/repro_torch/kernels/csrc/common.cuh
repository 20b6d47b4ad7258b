// Shared helpers for the qd-tree kernels: the cut kinds, an advanced
// cut's compare over int32 dictionary codes, a grid size, and the launch
// plan of a persistent kernel with a shared-memory tile a warp.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Cut kinds (core/predicates.py).
#define KIND_RANGE 0
#define KIND_IN 1
#define KIND_ADV 2

// col_a op col_b; ops 0-4 are <, <=, >, >=, ==, anything else is !=.
__device__ __forceinline__ bool adv_true(int op, int32_t va, int32_t vb) {
  switch (op) {
    case 0: return va < vb;
    case 1: return va <= vb;
    case 2: return va > vb;
    case 3: return va >= vb;
    case 4: return va == vb;
    default: return va != vb;
  }
}

// Grid size for a grid-stride loop over n items: enough blocks to fill
// the card, never more than the items need.
__host__ __forceinline__ unsigned grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t cap = 132 * 32;  // 132 SMs, 32 resident blocks each at most
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return (unsigned)blocks;
}

// The launch plan of a persistent kernel whose block holds `fixed` bytes of
// dynamic shared memory plus `per_warp` bytes a warp, made once a shape:
// plan = {kernel, warps a block, dynamic shared bytes, most blocks
// resident on the card}.  variant: 0 chooses by shape (1, the shared
// kernel, iff `min_warps` warps fit beside `fixed`; else 2, the global
// kernel, at 256 threads a block), 1 or 2 forces one.  The shared kernel
// takes the warps a block (at most `max_warps`) that put the most warps
// on an SM, the larger on a tie.  Returns a cudaError_t: a shared-memory
// request the card refuses is returned, never worked around.
static inline int plan_shared(const void* kernel, long long fixed,
                              long long per_warp, int min_warps,
                              int max_warps, int variant, int* plan) {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!err)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return (int)err;

  if (variant == 0) variant = fixed + min_warps * per_warp <= optin ? 1 : 2;
  plan[0] = variant;
  plan[1] = 8;  // global kernel: 256 threads a block
  plan[2] = 0;
  plan[3] = 0;
  if (variant != 1) return 0;

  // The kernel's limit is raised to all the card offers, so that a plan
  // for a small shape never lowers what a larger shape's launches need; a
  // request past it (one warp that does not fit) goes to CUDA, which
  // refuses it.
  long long smem = fixed + per_warp;
  const long long limit = smem > optin ? smem : optin;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(limit > INT32_MAX ? INT32_MAX : limit));
  int warps = 1, per_sm = 0;
  for (int w = max_warps; w >= 1 && !err; --w) {
    const long long bytes = fixed + w * per_warp;
    if (bytes > optin) continue;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        w * 32, (size_t)bytes);
    if (!err && w * blocks > warps * per_sm) {
      warps = w;
      per_sm = blocks;
      smem = bytes;
    }
  }
  if (err) {
    cudaGetLastError();  // clear it: the next launch must not see it
    return (int)err;
  }
  plan[1] = warps;
  plan[2] = (int)smem;
  plan[3] = sms * (per_sm > 0 ? per_sm : 1);
  return 0;
}
