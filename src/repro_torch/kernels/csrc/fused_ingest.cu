// fused_ingest: route a batch and reduce it per leaf in one pass.
//
// Replaces the Pallas kernel fused_ingest_pallas / _fused_ingest_kernel
// (src/repro/kernels/fused_ingest.py).  The TPU version evaluated every
// candidate cut of a record tile, located leaves by path-constraint
// products, and folded per-leaf aggregates into full-array accumulators
// that stayed resident because its grid ran in order on one core.  CUDA
// blocks run in parallel and in no order, so here:
//
//  * one thread per record descends the node arrays and evaluates only
//    the cuts on its own root path (depth cuts, not all n_cuts);
//  * it folds its record into int32 per-leaf accumulators with atomics:
//    atomicAdd (counts), atomicMin / atomicMax (lo / hi of every column)
//    and an idempotent byte store of 1 (categorical presence, advanced-
//    cut truth and falsity bits).  Min, max, or and integer add are
//    associative and commutative, so the result is exact and the same
//    whatever order the atomics land in.
//  * each atomic is skipped when a plain read already shows it cannot
//    change the value.  A stale read only ever overstates lo (understates
//    hi), so it can cost an extra atomic but never skip a needed one.
//
// Bound: bytes.  It reads m * D * 4 bytes of records (88 MB for 2**20
// TPC-H-like rows) and writes 4 bytes of block id a record plus the
// per-leaf aggregates.  Contention on hot leaves is the known cost of this
// simple design; pre-aggregating in shared memory is later work.

#include "common.cuh"

namespace {

struct Tree {
  const int32_t* cut_id;
  const int32_t* left;
  const int32_t* right;
  const int32_t* leaf_bid;
  int depth;
};

struct Aggregates {
  int32_t* counts;  // (L,)
  int32_t* lo;      // (L, D) init INT32_MAX
  int32_t* hi;      // (L, D) init INT32_MIN; max, not max + 1
  uint8_t* cat;     // (L, bits)
  uint8_t* advt;    // (L, adv_stride)
  uint8_t* advf;    // (L, adv_stride)
  int adv_stride;
};

__device__ __forceinline__ void set_flag(uint8_t* p) {
  if (*p == 0) *p = 1;
}

__global__ void fused_ingest_kernel(const int32_t* __restrict__ records,
                                    int64_t m, int d, CutTable t, Tree tree,
                                    const int32_t* __restrict__ cat_dims,
                                    int n_cat_dims, int n_adv,
                                    int32_t* __restrict__ bids,
                                    Aggregates agg) {
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < m;
       r += (int64_t)gridDim.x * blockDim.x) {
    const int32_t* rec = records + r * d;
    int node = 0;
    for (int level = 0; level < tree.depth; ++level) {
      const int c = tree.cut_id[node];
      if (c < 0) break;
      node = eval_cut(rec, c, t) ? tree.left[node] : tree.right[node];
    }
    const int leaf = tree.leaf_bid[node];
    bids[r] = leaf;

    atomicAdd(agg.counts + leaf, 1);
    int32_t* lo = agg.lo + (int64_t)leaf * d;
    int32_t* hi = agg.hi + (int64_t)leaf * d;
    for (int j = 0; j < d; ++j) {
      const int32_t v = rec[j];
      if (v < lo[j]) atomicMin(lo + j, v);
      if (v > hi[j]) atomicMax(hi + j, v);
    }
    uint8_t* cat = agg.cat + (int64_t)leaf * t.bits;
    for (int k = 0; k < n_cat_dims; ++k) {
      const int dd = cat_dims[k];
      const int pos = min(max(rec[dd] + t.cat_off[dd], 0), t.bits - 1);
      set_flag(cat + pos);
    }
    const int64_t arow = (int64_t)leaf * agg.adv_stride;
    for (int a = 0; a < n_adv; ++a) {
      const int32_t* p = t.adv + 3 * a;
      set_flag((adv_true(p[1], rec[p[0]], rec[p[2]]) ? agg.advt : agg.advf) +
               arow + a);
    }
  }
}

}  // namespace

extern "C" int fused_ingest_launch(
    const int32_t* records, int64_t m, int d, const int32_t* kind,
    const int32_t* dim, const int32_t* cutpoint, const uint8_t* in_mask,
    int n_cuts, int bits, const int32_t* cat_off, const int32_t* adv,
    const int32_t* adv_id, const int32_t* cut_id, const int32_t* left,
    const int32_t* right, const int32_t* leaf_bid, int depth,
    const int32_t* cat_dims, int n_cat_dims, int n_adv, int32_t* bids,
    int32_t* counts, int32_t* lo, int32_t* hi, uint8_t* cat, uint8_t* advt,
    uint8_t* advf, int adv_stride, void* stream) {
  CutTable t{kind, dim, cutpoint, in_mask, cat_off, adv, adv_id, n_cuts,
             bits};
  Tree tree{cut_id, left, right, leaf_bid, depth};
  Aggregates agg{counts, lo, hi, cat, advt, advf, adv_stride};
  const int threads = 256;
  fused_ingest_kernel<<<grid_for(m, threads), threads, 0,
                        (cudaStream_t)stream>>>(records, m, d, t, tree,
                                                cat_dims, n_cat_dims, n_adv,
                                                bids, agg);
  return (int)cudaGetLastError();
}
