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
// Two kernels, chosen by shape once a tree (route_descend_plan):
//
//  * route_descend_shared: a persistent grid.  Each block copies the
//    packed nodes into dynamic shared memory once (23 KB at 1,447 nodes),
//    so a level's node load waits on shared memory, not on L1/L2.  Each
//    warp stages contiguous tiles of 32 rows with 16-byte cp.async into
//    its own buffer, so record reads coalesce; each lane descends its own
//    row from shared memory, and lane i writes row i's id, so a warp
//    stores 128 contiguous bytes.  The plan takes the warps a block that
//    put the most warps on an SM (two blocks of 32 at tpch-40M).
//  * route_descend_global: for a tree whose nodes, beside four warps'
//    tiles, do not fit a block's shared memory (about 14,000 nodes at 21
//    columns).  One thread per record; the nodes are read through the
//    read-only cache.

#include "descend.cuh"

namespace {

constexpr int kMaxWarps = 32;  // 1024 threads a block
constexpr int kMinWarps = 4;   // below this the global kernel is chosen

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

__global__ void route_descend_global(Route r) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < r.m;
       i += (int64_t)gridDim.x * blockDim.x) {
    r.bids[i] =
        descend<true>(r.records + i * r.d, r.nodes, r.depth, r.in_mask,
                      r.bits);
  }
}

}  // namespace

// The launch plan of a tree, made once a shape (kernels/route_records.py
// keeps it): common.cuh::plan_shared over the packed nodes and a warp's
// tile of 32 records.  variant: 0 chooses by shape, 1 forces the shared
// kernel, 2 the global one.
extern "C" int route_descend_plan(int n_nodes, int d, int variant,
                                  int* plan) {
  return plan_shared((const void*)route_descend_shared, 16LL * n_nodes,
                     4LL * 32 * d, kMinWarps, kMaxWarps, variant, plan);
}

// One batch, by the plan route_descend_plan made: no host query of the
// card.  Returns cudaGetLastError().
extern "C" int route_descend_launch(const int32_t* records, int64_t m, int d,
                                    const int32_t* nodes, int n_nodes,
                                    int depth, const uint8_t* in_mask,
                                    int bits, int32_t* bids, int variant,
                                    int warps, int smem, int max_blocks,
                                    void* stream) {
  Route r{records, m, d, reinterpret_cast<const int4*>(nodes), n_nodes,
          depth, in_mask, bits, bids};
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 1) {
    const int64_t tiles = (m + 31) / 32;
    int64_t blocks = (tiles + warps - 1) / warps;
    if (blocks > max_blocks) blocks = max_blocks;
    route_descend_shared<<<(unsigned)blocks, warps * 32, (size_t)smem, st>>>(
        r);
  } else {
    const int threads = warps * 32;
    route_descend_global<<<grid_for(m, threads), threads, 0, st>>>(r);
  }
  return (int)cudaGetLastError();
}
