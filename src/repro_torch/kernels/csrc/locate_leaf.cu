// locate_leaf: the block id of each record, from its predicate-matrix row.
//
// Replaces the Pallas kernel locate_leaf_pallas / _locate_leaf_kernel
// (src/repro/kernels/route_records.py).  The TPU version found the leaf in
// path-constraint form, viol = (1 - M) @ PathPos + M @ PathNeg, two matrix
// products of O(m * n_cuts * n_leaves) work, because a data-dependent
// descent was a chain of gathers its vector unit did badly.  Here one
// thread per record walks the node arrays from the root, reading one byte
// of its row per level: O(m * depth) work, and the same leaf (the leaves
// partition the space, so the unique zero-violation leaf is the one the
// descent reaches).  The plain version keeps the path-constraint form, so
// the two designs check each other.
//
// Bound: bytes.  It reads the m * n_cuts matrix (each row once at most)
// and writes 4 bytes a record.  Design: rows are read where the path
// leads, 32-byte sectors at a time; the node arrays (a few KB) stay in L1.

#include "common.cuh"

namespace {

__global__ void locate_leaf_kernel(const uint8_t* __restrict__ mmat,
                                   int64_t m, int n_cuts,
                                   const int32_t* __restrict__ cut_id,
                                   const int32_t* __restrict__ left,
                                   const int32_t* __restrict__ right,
                                   const int32_t* __restrict__ leaf_bid,
                                   int depth, int32_t* __restrict__ bids) {
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < m;
       r += (int64_t)gridDim.x * blockDim.x) {
    const uint8_t* row = mmat + r * n_cuts;
    int node = 0;
    for (int level = 0; level < depth; ++level) {
      const int c = cut_id[node];
      if (c < 0) break;
      node = row[c] ? left[node] : right[node];
    }
    bids[r] = leaf_bid[node];
  }
}

}  // namespace

extern "C" int locate_leaf_launch(const uint8_t* mmat, int64_t m, int n_cuts,
                                  const int32_t* cut_id, const int32_t* left,
                                  const int32_t* right,
                                  const int32_t* leaf_bid, int depth,
                                  int32_t* bids, void* stream) {
  const int threads = 256;
  locate_leaf_kernel<<<grid_for(m, threads), threads, 0,
                       (cudaStream_t)stream>>>(mmat, m, n_cuts, cut_id, left,
                                               right, leaf_bid, depth, bids);
  return (int)cudaGetLastError();
}
