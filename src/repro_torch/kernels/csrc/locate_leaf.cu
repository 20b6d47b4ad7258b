// locate_leaf: the block id of each record, from its predicate-matrix row.
//
// Replaces the Pallas kernel locate_leaf_pallas / _locate_leaf_kernel
// (src/repro/kernels/route_records.py:198).  The TPU version found the
// leaf in path-constraint form, viol = (1 - M) @ PathPos + M @ PathNeg, two
// matrix products of O(m * n_cuts * n_leaves) work, because a
// data-dependent descent was a chain of gathers its vector unit did badly.
// Here each record walks the nodes from the root, reading one byte of its
// row a level: O(m * depth) work, and the same leaf (the leaves partition
// the space, so the unique zero-violation leaf is the one the descent
// reaches).  The plain version keeps the path-constraint form, so the two
// designs check each other.
//
// Bound: bytes.  The card reads 32-byte sectors, so the least it can read
// is the distinct sectors of M that the rows' paths touch (at 379 cuts and
// depth 19, most of each 379-byte row), plus the nodes and 4 bytes of
// output a record.  Reading a path's bytes where it leads, a thread a row,
// makes a warp touch 32 scattered sectors at every level: the reads do not
// coalesce, and each sector comes back more than once.
//
// Two kernels, chosen by shape once a tree (locate_leaf_plan):
//
//  * locate_leaf_shared: a persistent grid.  Each block copies the nodes
//    into shared memory once, packed as one 16-byte node (cut_id, left,
//    right, leaf_bid): 23 KB at 1,447 nodes.  Each warp stages tiles of 16
//    rows of M, each one contiguous span of 16 * n_cuts bytes (6 KB at 379
//    cuts), with one TMA bulk load a tile (cp.async.bulk, completing on a
//    barrier), so the matrix is read once, in whole sectors, and the copy
//    spends no load slots of the SM; lane i < 16 then descends row i from
//    shared memory and writes its id, so a warp stores 64 contiguous
//    bytes.  Two tile buffers a warp: the warp's next tile is in flight
//    while it descends this one (17 warps an SM at 379 cuts).  The copies
//    in flight, not the descent, set the pace, and 16-row tiles put more
//    of them in flight in the same shared memory than 32-row ones.  The
//    staged design reads the sectors no path touches too (43% of them at
//    tpch-40M), which the bound does not count.  A matrix that does not
//    start 16-byte aligned (a row view) is staged a byte at a time.
//  * locate_leaf_global: for a tree whose nodes, beside four warps' tiles,
//    do not fit a block's shared memory.  One thread a row, reading the
//    path's bytes where they lie and the node arrays through the
//    read-only cache.

#include "descend.cuh"

namespace {

constexpr int kMaxWarps = 32;  // 1024 threads a block
constexpr int kMinWarps = 4;   // below this the global kernel is chosen
// Rows a tile holds, and tile buffers a warp: with two, a warp's next tile
// is in flight while it descends this one.
constexpr int kTileRows = 16;
constexpr int kBuffers = 2;

struct Locate {
  const uint8_t* mmat;  // (m, n_cuts)
  int64_t m;
  int n_cuts;
  const int32_t* cut_id;  // (n_nodes,) -1 at a leaf
  const int32_t* left;
  const int32_t* right;
  const int32_t* leaf_bid;
  int n_nodes;
  int depth;
  int32_t* bids;  // (m,)
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One TMA bulk load of `bytes` (a multiple of 16) into shared memory; the
// barrier's phase completes when the bytes have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Start the copy of tile `tile` (rows kTileRows * tile .. of M) into `dst`;
// returns the bytes the barrier waits for.  A tile starts kTileRows *
// n_cuts bytes after the previous one, a multiple of 16, so with a 16-byte
// aligned matrix (`vec`) lane 0 copies
// its whole 16-byte chunks with one bulk load; a ragged tail, or a matrix
// that is not aligned, goes a byte at a time.
__device__ __forceinline__ unsigned stage_rows(uint8_t* dst,
                                               const uint8_t* mmat, int64_t m,
                                               int n, int64_t tile, int lane,
                                               bool vec, uint64_t* bar) {
  const int64_t row0 = tile * kTileRows;
  const unsigned bytes = (unsigned)min((int64_t)kTileRows, m - row0) * n;
  const uint8_t* src = mmat + row0 * n;
  const unsigned whole = vec ? bytes & ~15u : 0;
  if (whole && lane == 0) bulk_load(dst, src, whole, bar);
  for (unsigned i = whole + lane; i < bytes; i += 32) dst[i] = __ldg(src + i);
  return whole;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    locate_leaf_shared(Locate l) {
  extern __shared__ __align__(16) unsigned char smem[];
  // [nodes: n_nodes x 16 B][barriers: nwarps x kBuffers x 8 B, to 16]
  // [tiles: nwarps x kBuffers x kTileRows * n_cuts B]
  int4* s_nodes = reinterpret_cast<int4*>(smem);
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = l.n_cuts;
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(smem + 16 * l.n_nodes) + warp * kBuffers;
  uint8_t* bufs = smem + 16 * l.n_nodes +
                  ((8 * kBuffers * nwarps + 15) & ~15) +
                  (size_t)warp * kBuffers * kTileRows * n;

  const int64_t tiles = (l.m + kTileRows - 1) / kTileRows;
  const int64_t stride = (int64_t)gridDim.x * nwarps;
  const bool vec = (reinterpret_cast<uintptr_t>(l.mmat) & 15) == 0;
  int64_t t = (int64_t)blockIdx.x * nwarps + warp;
  if (lane == 0)
    for (int b = 0; b < kBuffers; ++b) mbar_init(bar + b);
  __syncwarp();
  // the first tiles' copies and the nodes' copy go out together
  // bit b of `pending`: buffer b waits on a bulk copy; of `parity`: the
  // phase its barrier completes next
  unsigned pending = 0, parity = 0;
  for (int b = 0; b < kBuffers; ++b)
    if (t + b * stride < tiles &&
        stage_rows(bufs + b * kTileRows * n, l.mmat, l.m, n, t + b * stride,
                   lane, vec, bar + b))
      pending |= 1u << b;
  for (int i = threadIdx.x; i < l.n_nodes; i += blockDim.x)
    s_nodes[i] = make_int4(__ldg(l.cut_id + i), __ldg(l.left + i),
                           __ldg(l.right + i), __ldg(l.leaf_bid + i));
  __syncthreads();  // the nodes have landed

  for (int b = 0; t < tiles; t += stride, b = (b + 1) % kBuffers) {
    uint8_t* buf = bufs + b * kTileRows * n;
    if ((pending >> b) & 1) {
      mbar_wait(bar + b, (parity >> b) & 1);  // the bulk bytes have landed
      parity ^= 1u << b;
    }
    __syncwarp();  // ... and every lane's byte copies
    const int64_t row = t * kTileRows + lane;
    int bid = 0;
    if (lane < kTileRows && row < l.m) {
      const uint8_t* r = buf + lane * n;
      int4 nd = s_nodes[0];
      for (int level = 0; level < l.depth && nd.x >= 0; ++level)
        nd = s_nodes[r[nd.x] ? nd.y : nd.z];
      bid = nd.w;
    }
    __syncwarp();  // every lane is done with `buf` before it is refilled
    const int64_t next = t + kBuffers * stride;
    pending &= ~(1u << b);
    if (next < tiles &&
        stage_rows(buf, l.mmat, l.m, n, next, lane, vec, bar + b))
      pending |= 1u << b;
    if (lane < kTileRows && row < l.m) l.bids[row] = bid;
  }
}

__global__ void locate_leaf_global(Locate l) {
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < l.m;
       r += (int64_t)gridDim.x * blockDim.x) {
    const uint8_t* row = l.mmat + r * l.n_cuts;
    int node = 0;
    for (int level = 0; level < l.depth; ++level) {
      const int c = __ldg(l.cut_id + node);
      if (c < 0) break;
      node = row[c] ? __ldg(l.left + node) : __ldg(l.right + node);
    }
    l.bids[r] = __ldg(l.leaf_bid + node);
  }
}

}  // namespace

// The launch plan of a tree, made once a shape
// (kernels/route_records.py::locate_leaf_plan): common.cuh::plan_shared
// over the packed nodes and a warp's two tiles of M.  variant: 0
// chooses by shape, 1 forces the shared kernel, 2 the global one.
extern "C" int locate_leaf_plan(int n_nodes, int n_cuts, int variant,
                                int* plan) {
  // a warp's barriers (8 B a buffer, all padded to 16) are counted in its
  // tiles
  return plan_shared((const void*)locate_leaf_shared, 16LL * n_nodes + 16,
                     kBuffers * ((long long)kTileRows * n_cuts + 8),
                     kMinWarps, kMaxWarps, variant, plan);
}

// One batch, by the plan locate_leaf_plan made: no host query of the card.
// Returns cudaGetLastError().
extern "C" int locate_leaf_launch(const uint8_t* mmat, int64_t m, int n_cuts,
                                  const int32_t* cut_id, const int32_t* left,
                                  const int32_t* right,
                                  const int32_t* leaf_bid, int n_nodes,
                                  int depth, int32_t* bids, int variant,
                                  int warps, int smem, int max_blocks,
                                  void* stream) {
  Locate l{mmat, m, n_cuts, cut_id, left, right, leaf_bid, n_nodes, depth,
           bids};
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 1) {
    const int64_t tiles = (m + kTileRows - 1) / kTileRows;
    int64_t blocks = (tiles + warps - 1) / warps;
    if (blocks > max_blocks) blocks = max_blocks;
    locate_leaf_shared<<<(unsigned)blocks, warps * 32, (size_t)smem, st>>>(
        l);
  } else {
    const int threads = warps * 32;
    locate_leaf_global<<<grid_for(m, threads), threads, 0, st>>>(l);
  }
  return (int)cudaGetLastError();
}
