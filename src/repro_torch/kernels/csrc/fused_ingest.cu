// fused_ingest: route a batch and fold it, per leaf, into running
// accumulators that live on the device across batches.
//
// Replaces the Pallas kernel fused_ingest_pallas / _fused_ingest_kernel
// (src/repro/kernels/fused_ingest.py).  The TPU version evaluated every
// candidate cut of a record tile, located leaves by path-constraint
// products, and folded per-leaf aggregates into full-array accumulators
// that stayed resident because its grid ran in order on one core.  CUDA
// blocks run in parallel and in no order.  Here each record descends the
// node arrays and evaluates only the cuts on its own root path, then folds
// into per-leaf aggregates: count, min and max of every column, the
// categorical values present and the advanced-cut truth values seen
// (packed 32 to a word).  Min, max, or and integer add are associative
// and commutative, so the result is exact and the same whatever order the
// atomics land in, and folding batch after batch into one set of
// accumulators equals folding their concatenation.
//
// Two kernels, chosen by shape once a tree (fused_ingest_plan):
//
//  * fused_ingest_shared: a persistent grid, about one block per SM.  Each
//    block keeps the whole tree's aggregates in dynamic shared memory
//    (142 KB at 724 leaves x 21 columns), so a record's 40-odd atomics are
//    shared-memory atomics.  Each warp stages contiguous tiles of 32 rows
//    with 16-byte cp.async into its own buffer, so record reads coalesce;
//    each lane then reads its row from shared memory.  The block takes as
//    many warps as fit beside the aggregates (32 at 724 x 21): the descent
//    is latency-bound, and other warps hide a warp's next copy.  At the
//    end the block folds its aggregates into the running accumulators
//    with read-checked global atomics, eight reads in flight a thread.
//
// The descent is latency-bound: a level's node load waits on the last.
// Each node carries its whole cut (engine/plan.py::pack_nodes), so a level
// is one 16-byte node load, a shared-memory read of the record and, on an
// IN cut, one in_mask byte; no cut table is read.
//  * fused_ingest_global: for a tree whose aggregates do not fit a block's
//    shared memory.  One thread per record, read-checked global atomics
//    straight into the running accumulators.
//
// Every atomic is skipped when a plain read already shows it cannot change
// the value.  Values only ever move one way (lo down, hi up, bits on), so a
// stale read can cost an extra atomic but never skip a needed one.
//
// Bound: bytes.  It reads m * D * 4 bytes of records (88 MB for 2**20
// TPC-H-like rows), writes 4 bytes of block id a record when asked, and
// reads and writes the accumulators once.

#include "descend.cuh"

namespace {

constexpr int kMaxWarps = 32;  // 1024 threads, one block a SM
constexpr int kMinWarps = 4;   // below this the global kernel is chosen

// A batch and the tree it descends (nodes packed as descend.cuh states).
struct Ingest {
  const int32_t* records;  // (m, d)
  int64_t m;
  int d;
  const int4* nodes;  // (n_nodes,)
  int depth;
  const int32_t* cat_off;  // (d,)
  const uint8_t* in_mask;  // (n_cuts, bits)
  int bits;
  const int32_t* adv;       // (A, 3) rows (col_a, op, col_b)
  const int32_t* cat_dims;  // categorical columns
  int n_cat_dims;
  int n_adv;
  int32_t* bids;  // (m,) or null: no block ids wanted
};

// The running accumulators (kernels/fused_ingest.py::IngestAccumulator).
struct Acc {
  unsigned long long* counts;  // (L,) int64
  int32_t* lo;                 // (L, d), INT32_MAX where empty
  int32_t* hi;                 // (L, d), INT32_MIN where empty; max, not max+1
  uint32_t* cat;               // (L, cw) categorical value bits
  uint32_t* advt;              // (L, aw) advanced cut seen true
  uint32_t* advf;              // (L, aw) advanced cut seen false
  int n_leaves, cw, aw;
};

__device__ __forceinline__ void or_bit(uint32_t* word, uint32_t bit) {
  if ((*word & bit) == 0) atomicOr(word, bit);
}

// The small tables a record's fold reads: categorical columns and their
// bit offsets, advanced predicates as (col_a, op, col_b) rows.
struct FoldTables {
  const int32_t* cat_dims;
  const int32_t* cat_off;
  const int32_t* adv;
  int n_cat_dims, n_adv, bits;
};

// Fold one record (row `rec`, block `leaf`) into a set of accumulators
// whose per-leaf rows start at the given pointers.  Used on shared and on
// global memory alike; inlined, so each call site's atomics address the
// right space.
__device__ __forceinline__ void fold_record(const int32_t* rec, int d,
                                            const FoldTables& t, int32_t* lo,
                                            int32_t* hi, uint32_t* cat,
                                            uint32_t* advt, uint32_t* advf) {
  for (int j = 0; j < d; ++j) {
    const int32_t v = rec[j];
    if (v < lo[j]) atomicMin(lo + j, v);
    if (v > hi[j]) atomicMax(hi + j, v);
  }
  for (int k = 0; k < t.n_cat_dims; ++k) {
    const int dd = t.cat_dims[k];
    int pos = rec[dd] + t.cat_off[dd];
    pos = min(max(pos, 0), t.bits - 1);
    or_bit(cat + (pos >> 5), 1u << (pos & 31));
  }
  for (int a = 0; a < t.n_adv; ++a) {
    const int32_t* p = t.adv + 3 * a;
    const bool truth = adv_true(p[1], rec[p[0]], rec[p[2]]);
    or_bit((truth ? advt : advf) + (a >> 5), 1u << (a & 31));
  }
}

// Fold the block's aggregates `s` into the running ones `g`, read-checked:
// kFlushBatch independent reads in flight a thread, then their atomics.
constexpr int kFlushBatch = 8;

template <typename T, typename Op>
__device__ __forceinline__ void flush(const T* s, T* g, int n, Op op) {
  for (int i0 = threadIdx.x; i0 < n; i0 += kFlushBatch * blockDim.x) {
    T seen[kFlushBatch];
#pragma unroll
    for (int u = 0; u < kFlushBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) seen[u] = __ldcg(g + i);
    }
#pragma unroll
    for (int u = 0; u < kFlushBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) op(g + i, s[i], seen[u]);
    }
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    fused_ingest_shared(Ingest in, Acc g) {
  extern __shared__ __align__(16) int32_t smem[];
  const int L = g.n_leaves, d = in.d;
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // [stage: nwarps x 32 rows][counts L][lo L*d][hi L*d][cat]
  // [advt][advf][cat_dims][cat_off d][adv 3 x n_adv]
  int32_t* stage = smem;
  int32_t* s_counts = stage + nwarps * 32 * d;
  int32_t* s_lo = s_counts + L;
  int32_t* s_hi = s_lo + L * d;
  uint32_t* s_cat = reinterpret_cast<uint32_t*>(s_hi + L * d);
  uint32_t* s_advt = s_cat + L * g.cw;
  uint32_t* s_advf = s_advt + L * g.aw;
  int32_t* s_cat_dims = reinterpret_cast<int32_t*>(s_advf + L * g.aw);
  int32_t* s_cat_off = s_cat_dims + in.n_cat_dims;
  int32_t* s_adv = s_cat_off + d;

  for (int i = threadIdx.x; i < L; i += blockDim.x) s_counts[i] = 0;
  for (int i = threadIdx.x; i < L * d; i += blockDim.x) {
    s_lo[i] = INT32_MAX;
    s_hi[i] = INT32_MIN;
  }
  for (int i = threadIdx.x; i < L * (g.cw + 2 * g.aw); i += blockDim.x)
    s_cat[i] = 0;  // cat, advt and advf are contiguous
  for (int i = threadIdx.x; i < in.n_cat_dims; i += blockDim.x)
    s_cat_dims[i] = in.cat_dims[i];
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    s_cat_off[i] = in.cat_off[i];
  for (int i = threadIdx.x; i < 3 * in.n_adv; i += blockDim.x)
    s_adv[i] = in.adv[i];
  __syncthreads();
  const FoldTables tables{s_cat_dims, s_cat_off, s_adv, in.n_cat_dims,
                          in.n_adv, in.bits};

  // each warp walks its own tiles of 32 rows through its one buffer: the
  // next tile's copy is issued once this one is folded, and other warps
  // hide it.
  const int64_t tiles = (in.m + 31) / 32;
  const int64_t stride = (int64_t)gridDim.x * nwarps;
  const bool vec = (reinterpret_cast<uintptr_t>(in.records) & 15) == 0;
  int32_t* cur = stage + warp * 32 * d;
  int64_t t = (int64_t)blockIdx.x * nwarps + warp;
  if (t < tiles) stage_tile(cur, in.records, in.m, d, t, lane, vec);
  cp_async_commit();
  for (; t < tiles; t += stride) {
    cp_async_wait_all();  // this tile's copies have landed (own lane's)
    __syncwarp();        // ... and every lane's
    const int64_t r = t * 32 + lane;
    if (r < in.m) {
      const int32_t* rec = cur + lane * d;
      const int leaf =
          descend<true>(rec, in.nodes, in.depth, in.in_mask, in.bits);
      if (in.bids != nullptr) in.bids[r] = leaf;
      atomicAdd(s_counts + leaf, 1);
      fold_record(rec, d, tables, s_lo + leaf * d, s_hi + leaf * d,
                  s_cat + leaf * g.cw, s_advt + leaf * g.aw,
                  s_advf + leaf * g.aw);
    }
    __syncwarp();  // every lane is done with `cur` before it is refilled
    if (t + stride < tiles)
      stage_tile(cur, in.records, in.m, d, t + stride, lane, vec);
    cp_async_commit();
  }
  cp_async_wait_all();
  __syncthreads();

  // flush the block's aggregates into the running accumulators
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const int c = s_counts[i];
    if (c) atomicAdd(g.counts + i, (unsigned long long)c);
  }
  flush(s_lo, g.lo, L * d, [](int32_t* p, int32_t v, int32_t seen) {
    if (v < seen) atomicMin(p, v);
  });
  flush(s_hi, g.hi, L * d, [](int32_t* p, int32_t v, int32_t seen) {
    if (v > seen) atomicMax(p, v);
  });
  const auto bits_or = [](uint32_t* p, uint32_t v, uint32_t seen) {
    if ((seen & v) != v) atomicOr(p, v);
  };
  flush(s_cat, g.cat, L * g.cw, bits_or);
  flush(s_advt, g.advt, L * g.aw, bits_or);
  flush(s_advf, g.advf, L * g.aw, bits_or);
}

__global__ void fused_ingest_global(Ingest in, Acc g) {
  const int d = in.d;
  const FoldTables tables{in.cat_dims, in.cat_off, in.adv, in.n_cat_dims,
                          in.n_adv, in.bits};
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < in.m;
       r += (int64_t)gridDim.x * blockDim.x) {
    const int32_t* rec = in.records + r * d;
    const int leaf =
        descend<true>(rec, in.nodes, in.depth, in.in_mask, in.bits);
    if (in.bids != nullptr) in.bids[r] = leaf;
    atomicAdd(g.counts + leaf, 1ull);
    fold_record(rec, d, tables, g.lo + (int64_t)leaf * d,
                g.hi + (int64_t)leaf * d,
                g.cat + (int64_t)leaf * g.cw, g.advt + (int64_t)leaf * g.aw,
                g.advf + (int64_t)leaf * g.aw);
  }
}

// Shared memory of fused_ingest_shared: the aggregates and small tables
// (fixed), and one buffer of 32 rows a warp.
long long fixed_bytes(int n_leaves, int d, int cw, int aw, int n_cat_dims,
                      int n_adv) {
  return 4LL * n_leaves * (1 + 2LL * d + cw + 2LL * aw) +
         4LL * (n_cat_dims + d + 3 * n_adv);
}

long long tile_bytes(int d) { return 4LL * 32 * d; }

}  // namespace

// The launch plan of a tree, made once (kernels/fused_ingest.py keeps it
// per shape): plan = {kernel, warps a block, dynamic shared bytes, most
// blocks resident on the card}.  variant: 0 chooses by shape, 1 forces
// the shared kernel, 2 the global one.  The shared kernel takes as many
// warps as fit beside the aggregates, at most 32; below kMinWarps the
// global kernel is chosen.  Returns a cudaError_t: a shared-memory request
// the card refuses is returned, never worked around.
extern "C" int fused_ingest_plan(int n_leaves, int d, int cw, int aw,
                                 int n_cat_dims, int n_adv, int variant,
                                 int* plan) {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!err)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return (int)err;

  const long long fixed =
      fixed_bytes(n_leaves, d, cw, aw, n_cat_dims, n_adv);
  const long long fit = optin > fixed ? (optin - fixed) / tile_bytes(d) : 0;
  const int warps_fit = (int)(fit > kMaxWarps ? kMaxWarps : fit);
  if (variant == 0) variant = warps_fit >= kMinWarps ? 1 : 2;
  plan[0] = variant;
  plan[1] = 8;  // global kernel: 256 threads a block
  plan[2] = 0;
  plan[3] = 0;
  if (variant != 1) return 0;

  const int warps = warps_fit < 1 ? 1 : warps_fit;
  const long long smem = fixed + warps * tile_bytes(d);
  // The kernel's limit is raised to all the card offers, so that a plan
  // for a small tree never lowers what a larger tree's launches need; a
  // request past it goes to CUDA, which refuses it.
  const long long limit = smem > optin ? smem : optin;
  err = cudaFuncSetAttribute(fused_ingest_shared,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(limit > INT32_MAX ? INT32_MAX : limit));
  int per_sm = 0;
  if (!err)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_ingest_shared, warps * 32, (size_t)smem);
  if (err) {
    cudaGetLastError();  // clear it: the next launch must not see it
    return (int)err;
  }
  plan[1] = warps;
  plan[2] = (int)smem;
  plan[3] = sms * (per_sm > 0 ? per_sm : 1);
  return 0;
}

// One batch, by the plan fused_ingest_plan made: no host query of the
// card.  Returns cudaGetLastError().
extern "C" int fused_ingest_launch(
    const int32_t* records, int64_t m, int d, const int32_t* nodes,
    int depth, const int32_t* cat_off, const uint8_t* in_mask, int bits,
    const int32_t* adv, const int32_t* cat_dims, int n_cat_dims, int n_adv,
    int32_t* bids, void* counts, int32_t* lo, int32_t* hi, int32_t* cat,
    int32_t* advt, int32_t* advf, int n_leaves, int cw, int aw,
    int variant, int warps, int smem, int max_blocks, void* stream) {
  Ingest in{records, m, d, reinterpret_cast<const int4*>(nodes), depth,
            cat_off, in_mask, bits, adv, cat_dims, n_cat_dims, n_adv, bids};
  Acc g{reinterpret_cast<unsigned long long*>(counts), lo, hi,
        reinterpret_cast<uint32_t*>(cat), reinterpret_cast<uint32_t*>(advt),
        reinterpret_cast<uint32_t*>(advf), n_leaves, cw, aw};
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 1) {
    const int64_t tiles = (m + 31) / 32;
    int64_t blocks = (tiles + warps - 1) / warps;
    if (blocks > max_blocks) blocks = max_blocks;
    fused_ingest_shared<<<(unsigned)blocks, warps * 32, (size_t)smem, st>>>(
        in, g);
  } else {
    const int threads = warps * 32;
    fused_ingest_global<<<grid_for(m, threads), threads, 0, st>>>(in, g);
  }
  return (int)cudaGetLastError();
}
