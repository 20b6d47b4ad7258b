// route_descend: the block id of each record of a batch, in one launch.
//
// Replaces the pair of Pallas kernels eval_cuts_pallas and
// locate_leaf_pallas (src/repro/kernels/route_records.py), which together
// map records to block ids.  The TPU could not chase pointers, so the
// reference factored routing into two dense kernels: the whole (m, n_cuts)
// predicate matrix, then each record's leaf by path-constraint products.
// The port's eval_cuts and locate_leaf kernels keep that factoring, as the
// two functions' counterparts.  This kernel computes what they compose:
// each record descends the packed nodes (descend.cuh) and evaluates only
// the cuts on its own root path, so no predicate matrix is ever written.
//
// Bound: bytes.  It reads m * D * 4 bytes of records (88 MB for 2**20
// TPC-H-like rows), the nodes (16 bytes each) and the in_mask bytes once,
// and writes 4 bytes a record.  The descent is a chain of dependent loads
// (one level's node waits on the last), so it is latency, which many
// warps in flight hide.
//
// Three kernels, chosen by shape once a tree (kernels/route_records.py::
// descend_plan, pure arithmetic; route_descend_plan checks it on the card):
//
//  * route_descend_shared: a persistent grid.  Each block copies the
//    packed nodes into dynamic shared memory once (23 KB at 1,447 nodes),
//    so a level's node load waits on shared memory, not on L1/L2.  Each
//    warp stages contiguous tiles of 32 rows with 16-byte cp.async into
//    its own buffer, so record reads coalesce; each lane descends its own
//    row from shared memory, and lane i writes row i's id, so a warp
//    stores 128 contiguous bytes.  The plan takes the warps a block that
//    put the most warps on an SM (two blocks of 32 at tpch-40M).
//  * route_descend_prefix: for trees past the shared kernel's reach
//    (past 7,000 nodes, or where its blocks would hold fewer than 32
//    warps).  Bound, as above, by bytes: 2**20 rows of 21 columns read once
//    (88 MB) and their ids written, 0.0276 to 0.0278 ms at 3.35 TB/s on
//    tpch-40M's trees.  What holds it back is the descent: 16 to 18 levels
//    a record on trees of 8,000 to 20,000 leaves (a warp waits on its
//    deepest lane, 23 to 26), each a chain of dependent loads (the node,
//    then the record's column, then for an IN cut its in_mask byte).  Its
//    design against that chain: as many chains in flight as an SM holds,
//    and each load from the nearest memory that has room.  Each warp
//    stages the shared kernel's coalesced 32-row tiles, so a level's column
//    read is a shared load; the tree's BFS prefix, the nodes every record
//    passes, is staged beside them once a block; a path that leaves the
//    prefix never returns to it (BFS order), so the descent is two loops,
//    shared loads then global ones (descend.cuh::descend_prefix), and the
//    global loads go through the read-only path under an L2 evict_last
//    policy while the tiles stream in under evict_first, so the records
//    (88 MB a batch, past the 50 MB L2) do not evict the deep levels
//    (256 KB of nodes at 8,000 leaves, 640 KB at 20,000).  The plan sizes
//    a block so that chains win over staging: 21 warps and 632 nodes (65
//    KB), two blocks an SM at the kernel's 38 registers a thread, which
//    leaves L1 124 KB of the SM's 256 KB for the deeper levels and in_mask.
//    Measured on an H100 (PERF.md §6): 32 warps beside the largest prefix
//    (9,152 nodes) ran no faster than the global kernel, and a larger
//    prefix or fewer warps were slower; speculative loads of both children
//    and double-buffered tiles were slower too.
//  * route_descend_global: the first draft for trees past one block.  One
//    thread per record reads its own row (84-byte stride, so a warp's
//    loads do not coalesce) and every level's node through the read-only
//    cache.  Forced only: slower than the prefix kernel on every tree.

#include "descend.cuh"

namespace {

constexpr int kMaxWarps = 32;  // 1024 threads a block

// the plan's kernel (route_records.VARIANTS)
enum { kShared = 1, kGlobal = 2, kPrefix = 3 };

struct Route {
  const int32_t* records;  // (m, d)
  int64_t m;
  int d;
  const int4* nodes;  // (n_nodes,)
  int n_nodes;
  int depth;
  const uint8_t* in_mask;  // (n_cuts, bits)
  int bits;
  int32_t* bids;  // (m,)
};

// Two blocks of 1024 threads fill an SM: at most 32 registers a thread.
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
    route_descend_shared(Route r) {
  extern __shared__ __align__(16) int32_t smem[];
  // [nodes: n_nodes x 16 B][stage: nwarps x 32 rows]
  int4* s_nodes = reinterpret_cast<int4*>(smem);
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int32_t* cur = smem + 4 * r.n_nodes + warp * 32 * r.d;

  const int64_t tiles = (r.m + 31) / 32;
  const int64_t stride = (int64_t)gridDim.x * nwarps;
  const bool vec = (reinterpret_cast<uintptr_t>(r.records) & 15) == 0;
  int64_t t = (int64_t)blockIdx.x * nwarps + warp;
  // the first tile's copy and the nodes' copy go out together
  if (t < tiles) stage_tile(cur, r.records, r.m, r.d, t, lane, vec);
  for (int i = threadIdx.x; i < r.n_nodes; i += blockDim.x)
    cp_async16(s_nodes + i, r.nodes + i);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();  // every thread's node copies have landed

  // each warp walks its own tiles through its one buffer: the next tile's
  // copy is issued once this one is descended, and other warps hide it.
  for (; t < tiles; t += stride) {
    const int64_t row = t * 32 + lane;
    int bid = 0;
    if (row < r.m)
      bid = descend<false>(cur + lane * r.d, s_nodes, r.depth, r.in_mask,
                           r.bits);
    __syncwarp();  // every lane is done with `cur` before it is refilled
    if (t + stride < tiles)
      stage_tile(cur, r.records, r.m, r.d, t + stride, lane, vec);
    cp_async_commit();
    if (row < r.m) r.bids[row] = bid;
    cp_async_wait_all();  // the next tile's copies have landed (own lane's)
    __syncwarp();        // ... and every lane's
  }
}

// Up to 1024 threads a block, at most 64 registers a thread.
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    route_descend_prefix(Route r, int prefix) {
  extern __shared__ __align__(16) int32_t smem[];
  // [the first `prefix` nodes x 16 B][stage: nwarps x 32 rows]
  int4* s_nodes = reinterpret_cast<int4*>(smem);
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int32_t* cur = smem + 4 * prefix + warp * 32 * r.d;
  const uint64_t keep = l2_evict_last(), once = l2_evict_first();

  const int64_t tiles = (r.m + 31) / 32;
  const int64_t stride = (int64_t)gridDim.x * nwarps;
  const bool vec = (reinterpret_cast<uintptr_t>(r.records) & 15) == 0;
  int64_t t = (int64_t)blockIdx.x * nwarps + warp;
  // the first tile's copy and the prefix's copy go out together
  if (t < tiles)
    stage_tile<32, true>(cur, r.records, r.m, r.d, t, lane, vec, once);
  for (int i = threadIdx.x; i < prefix; i += blockDim.x)
    cp_async16(s_nodes + i, r.nodes + i, keep);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();  // every thread's node copies have landed

  for (; t < tiles; t += stride) {
    const int64_t row = t * 32 + lane;
    int bid = 0;
    if (row < r.m)
      bid = descend_prefix(cur + lane * r.d, s_nodes, prefix, r.nodes,
                           r.depth, r.in_mask, r.bits, keep);
    __syncwarp();  // every lane is done with `cur` before it is refilled
    if (t + stride < tiles)
      stage_tile<32, true>(cur, r.records, r.m, r.d, t + stride, lane, vec,
                           once);
    cp_async_commit();
    if (row < r.m) r.bids[row] = bid;
    cp_async_wait_all();  // the next tile's copies have landed (own lane's)
    __syncwarp();        // ... and every lane's
  }
}

__global__ void route_descend_global(Route r) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < r.m;
       i += (int64_t)gridDim.x * blockDim.x) {
    r.bids[i] =
        descend<true>(r.records + i * r.d, r.nodes, r.depth, r.in_mask,
                      r.bits);
  }
}

}  // namespace

// Check a launch plan of kernels/route_records.py::descend_plan on the card
// and fill in the most blocks resident: plan = {kernel, warps a block,
// dynamic shared bytes, most blocks}.  The shared kernel must hold all
// `n_nodes` nodes and `warps` tiles of `d` columns, the prefix kernel
// 1 <= prefix <= n_nodes nodes and its tiles (cudaErrorInvalidValue
// otherwise); a shared-memory request the card refuses is returned, never
// worked around.  The kernel's limit is raised to all the card offers, so
// that a plan for a small shape never lowers what a larger shape's
// launches need.
extern "C" int route_descend_plan(int n_nodes, int d, int kernel, int warps,
                                  int smem, int prefix, int* plan) {
  plan[0] = kernel;
  plan[1] = warps;
  plan[2] = 0;
  plan[3] = 0;
  if (kernel == kGlobal) return warps >= 1 && warps <= kMaxWarps
                                    ? 0
                                    : (int)cudaErrorInvalidValue;
  const void* fn = kernel == kShared ? (const void*)route_descend_shared
                                     : (const void*)route_descend_prefix;
  const long long staged = kernel == kShared ? n_nodes : prefix;
  const bool ok = (kernel == kShared || kernel == kPrefix) && warps >= 1 &&
                  warps <= kMaxWarps && staged >= 1 && staged <= n_nodes &&
                  smem >= 16 * staged + 4LL * 32 * d * warps;
  if (!ok) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!err)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem > optin ? smem : optin);
  int per_sm = 0;
  if (!err)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        warps * 32, smem);
  if (!err && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err) {
    cudaGetLastError();  // clear it: the next launch must not see it
    return (int)err;
  }
  plan[2] = smem;
  plan[3] = sms * per_sm;
  return 0;
}

// One batch, by the plan route_descend_plan checked: no host query of the
// card.  Returns cudaGetLastError().
extern "C" int route_descend_launch(const int32_t* records, int64_t m, int d,
                                    const int32_t* nodes, int n_nodes,
                                    int depth, const uint8_t* in_mask,
                                    int bits, int32_t* bids, int kernel,
                                    int warps, int smem, int max_blocks,
                                    int prefix, void* stream) {
  Route r{records, m, d, reinterpret_cast<const int4*>(nodes), n_nodes,
          depth, in_mask, bits, bids};
  cudaStream_t st = (cudaStream_t)stream;
  if (kernel == kShared || kernel == kPrefix) {
    const int64_t tiles = (m + 31) / 32;
    int64_t blocks = (tiles + warps - 1) / warps;
    if (blocks > max_blocks) blocks = max_blocks;
    if (kernel == kShared)
      route_descend_shared<<<(unsigned)blocks, warps * 32, (size_t)smem, st>>>(
          r);
    else
      route_descend_prefix<<<(unsigned)blocks, warps * 32, (size_t)smem, st>>>(
          r, prefix);
  } else {
    const int threads = warps * 32;
    route_descend_global<<<grid_for(m, threads), threads, 0, st>>>(r);
  }
  return (int)cudaGetLastError();
}
