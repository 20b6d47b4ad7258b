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
// Three kernels; the plan (kernels/fused_ingest.py::layout_plan) picks
// one by shape once a tree:
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
//  * fused_ingest_cluster: for a tree whose aggregates do not fit one
//    block (past about 1,100 leaves at 21 columns) but fit a cluster of
//    two beside 32 warps a block (about 1,380 leaves).  A thread block
//    cluster of C blocks (2 to 16, on neighbouring SMs; past 2 only when
//    forced) splits the aggregates: each block holds per_block leaves in its shared memory,
//    the cluster C * per_block.  Records are staged and descended as in
//    the shared kernel, each once a cluster.  A row whose leaf another
//    block owns goes to that block's inbox in distributed shared memory
//    as a 4-byte reference, and the owner gathers the row and folds it
//    into its own slice with shared-memory atomics.  A tree past the
//    largest cluster is folded in ranges of C * per_block leaves, the
//    grid's y dimension, all in one launch; each range descends the whole
//    batch again and folds only the records whose leaf it holds.  Each
//    cluster flushes its slices once, as the shared kernel does.
//
//    Designs measured on an H100 before this one (PERF.md, section 6): each
//    row folded straight into the owner's slice through distributed
//    shared memory (some 55 remote reads and their atomics a row) took
//    3x the shared kernel's time at C = 2 and 6x at C = 8: the SM-to-SM
//    network moves few bytes an access.  Rows whose ids the owners read
//    from the descending block's list, epoch by epoch, were slower still
//    at C = 16.  In this design the descent's latency is most of the
//    time, then the round barrier's wait for the slowest warp (popular
//    leaves make some blocks' inboxes fuller), then the inboxes' drain.
//
//  * fused_ingest_global: the first draft, for larger trees: one thread
//    per record, unstaged loads and read-checked global atomics straight
//    into the running accumulators.  On an H100 it was as fast as the
//    cluster kernel at 1,350 leaves and faster on every larger tree (0.23
//    against 0.34 ms at 1,800, where a block of two keeps 17 warps; 0.27
//    against 0.42 at 8,000 with 16 blocks; PERF.md section 6): its
//    atomics spread over more addresses as leaves grow, while the
//    cluster kernel loses the warps that hide its descent, sends a larger
//    share of its rows to other blocks, and past 16 blocks descends the
//    batch once a range.
//
// The descent is latency-bound: a level's node load waits on the last.
// Each node carries its whole cut (engine/plan.py::pack_nodes), so a level
// is one 16-byte node load, a shared-memory read of the record and, on an
// IN cut, one in_mask byte; no cut table is read.
//
// Every atomic is skipped when a plain read already shows it cannot change
// the value.  Values only ever move one way (lo down, hi up, bits on), so a
// stale read can cost an extra atomic but never skip a needed one.
//
// Bound: bytes.  It reads m * D * 4 bytes of records (88 MB for 2**20
// TPC-H-like rows), writes 4 bytes of block id a record when asked, and
// reads and writes the accumulators once.

#include <cooperative_groups.h>

#include "descend.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWarps = 32;  // 1024 threads, one block a SM

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

// A block's aggregates of n leaves in shared memory: [counts n][lo n*d]
// [hi n*d][cat n*cw][advt n*aw][advf n*aw], each leaf's row contiguous.
struct Aggs {
  int32_t* counts;
  int32_t* lo;
  int32_t* hi;
  uint32_t* cat;
  uint32_t* advt;
  uint32_t* advf;

  __device__ __forceinline__ static Aggs at(int32_t* base, int n, int d,
                                            int cw, int aw) {
    Aggs a;
    a.counts = base;
    a.lo = base + n;
    a.hi = a.lo + n * d;
    a.cat = reinterpret_cast<uint32_t*>(a.hi + n * d);
    a.advt = a.cat + n * cw;
    a.advf = a.advt + n * aw;
    return a;
  }
  __device__ __forceinline__ int32_t* end(int n, int aw) const {
    return reinterpret_cast<int32_t*>(advf + n * aw);
  }
};

// Lay out a block's shared memory, [stage: nwarps x 32 rows][aggregates of
// n leaves][cat_dims][cat_off d][adv 3 x n_adv]; set the aggregates to
// their identities and copy the tables in.  Ends before any barrier.
__device__ __forceinline__ Aggs setup_block(int32_t* smem, const Ingest& in,
                                            const Acc& g, int n,
                                            FoldTables* tables) {
  const int d = in.d, nwarps = blockDim.x >> 5;
  const Aggs a = Aggs::at(smem + nwarps * 32 * d, n, d, g.cw, g.aw);
  int32_t* s_cat_dims = a.end(n, g.aw);
  int32_t* s_cat_off = s_cat_dims + in.n_cat_dims;
  int32_t* s_adv = s_cat_off + d;
  for (int i = threadIdx.x; i < n; i += blockDim.x) a.counts[i] = 0;
  for (int i = threadIdx.x; i < n * d; i += blockDim.x) {
    a.lo[i] = INT32_MAX;
    a.hi[i] = INT32_MIN;
  }
  for (int i = threadIdx.x; i < n * (g.cw + 2 * g.aw); i += blockDim.x)
    a.cat[i] = 0;  // cat, advt and advf are contiguous
  for (int i = threadIdx.x; i < in.n_cat_dims; i += blockDim.x)
    s_cat_dims[i] = in.cat_dims[i];
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    s_cat_off[i] = in.cat_off[i];
  for (int i = threadIdx.x; i < 3 * in.n_adv; i += blockDim.x)
    s_adv[i] = in.adv[i];
  *tables = FoldTables{s_cat_dims, s_cat_off, s_adv, in.n_cat_dims, in.n_adv,
                       in.bits};
  return a;
}

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
__device__ __forceinline__ void flush(const T* s, T* g, int n, int width,
                                      int64_t step, Op op) {
  // element i of the block's rows of `width` is element i % width of the
  // running row (i / width) * step: every row when step is 1
  const auto at = [&](int i) {
    return step == 1 ? g + i : g + (i / width) * step * width + i % width;
  };
  for (int i0 = threadIdx.x; i0 < n; i0 += kFlushBatch * blockDim.x) {
    T seen[kFlushBatch];
#pragma unroll
    for (int u = 0; u < kFlushBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) seen[u] = __ldcg(at(i));
    }
#pragma unroll
    for (int u = 0; u < kFlushBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) op(at(i), s[i], seen[u]);
    }
  }
}

// Flush the block's aggregates of n leaves into the running ones of
// leaves first, first + step, first + 2 * step, ...
__device__ __forceinline__ void flush_leaves(const Aggs& s, const Acc& g,
                                             int d, int first, int n,
                                             int step) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = s.counts[i];
    if (c)
      atomicAdd(g.counts + first + (int64_t)i * step, (unsigned long long)c);
  }
  flush(s.lo, g.lo + (int64_t)first * d, n * d, d, step,
        [](int32_t* p, int32_t v, int32_t seen) {
          if (v < seen) atomicMin(p, v);
        });
  flush(s.hi, g.hi + (int64_t)first * d, n * d, d, step,
        [](int32_t* p, int32_t v, int32_t seen) {
          if (v > seen) atomicMax(p, v);
        });
  const auto bits_or = [](uint32_t* p, uint32_t v, uint32_t seen) {
    if ((seen & v) != v) atomicOr(p, v);
  };
  flush(s.cat, g.cat + (int64_t)first * g.cw, n * g.cw, g.cw, step, bits_or);
  flush(s.advt, g.advt + (int64_t)first * g.aw, n * g.aw, g.aw, step,
        bits_or);
  flush(s.advf, g.advf + (int64_t)first * g.aw, n * g.aw, g.aw, step,
        bits_or);
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    fused_ingest_shared(Ingest in, Acc g) {
  extern __shared__ __align__(16) int32_t smem[];
  const int L = g.n_leaves, d = in.d;
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  FoldTables tables;
  const Aggs s = setup_block(smem, in, g, L, &tables);
  __syncthreads();

  // each warp walks its own tiles of 32 rows through its one buffer: the
  // next tile's copy is issued once this one is folded, and other warps
  // hide it.
  const int64_t tiles = (in.m + 31) / 32;
  const int64_t stride = (int64_t)gridDim.x * nwarps;
  const bool vec = (reinterpret_cast<uintptr_t>(in.records) & 15) == 0;
  int32_t* cur = smem + warp * 32 * d;
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
      atomicAdd(s.counts + leaf, 1);
      fold_record(rec, d, tables, s.lo + leaf * d, s.hi + leaf * d,
                  s.cat + leaf * g.cw, s.advt + leaf * g.aw,
                  s.advf + leaf * g.aw);
    }
    __syncwarp();  // every lane is done with `cur` before it is refilled
    if (t + stride < tiles)
      stage_tile(cur, in.records, in.m, d, t + stride, lane, vec);
    cp_async_commit();
  }
  cp_async_wait_all();
  __syncthreads();
  flush_leaves(s, g, d, 0, L, 1);
}

// Grid: (clusters a range x C, ranges); the cluster's block of rank k in
// range y of R owns the per_block leaves l with l % R == y and (l / R) % C
// == k, interleaved so that the popular leaves (BFS ids put the shallow,
// large ones first) spread over the blocks.  The batch goes in rounds, one
// tile a warp a round, with one cluster barrier a round.  A warp descends
// its staged tile and folds the rows whose leaf its block owns into its
// own slice.  Each other row of the range goes to its owner's inbox as a
// 4-byte reference (leaf slot, and the sender's block, warp and lane, from
// which the owner recomputes the row), in a slot reserved by one remote
// atomic a warp and owner; past a full inbox (kInboxShare entries a peer
// lane), the sender folds the row itself, straight into the owner's slice
// through distributed shared memory.  In the next round each warp, after
// its own descent, takes 32 entries of the last round's inbox at a time,
// gathers their rows from global memory (the L2 holds them: they were
// staged a round ago) into its tile buffer, coalesced, and folds them as
// it folds its own rows; then it stages its next tile.  Rounds alternate
// between two inboxes: round k's sends go to one while round k - 1's is
// drained, and round k + 1's come after round k's barrier, which every
// block passes only once it has drained round k - 1's.  The barriers
// after the slices are set and each round's keep every peer's shared
// memory alive while another block may still write it.
constexpr int kSenderBits = 14;  // block, warp, lane: < 16 * 32 * 32
// inbox entries a peer warp's lane: twice the rows a block's peers send it
// a round on average (kernels/fused_ingest.py::INBOX_SHARE sizes the plan)
constexpr int kInboxShare = 2;

__global__ void __launch_bounds__(kMaxWarps * 32)
    fused_ingest_cluster(Ingest in, Acc g, int per_block) {
  extern __shared__ __align__(16) int32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int L = g.n_leaves, d = in.d, P = per_block;
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int R = gridDim.y, y = blockIdx.y;  // leaf l's slot: l / (R * C)
  const int own_first = rank * R + y;
  const int own_n = max(0, min(P, (L - own_first + C * R - 1) / (C * R)));
  FoldTables tables;
  const Aggs s = setup_block(smem, in, g, P, &tables);
  // [.. tables][entries in each inbox: 2][inboxes: 2 x min(C - 1,
  // kInboxShare) x nwarps x 32 entries]; a row past a full inbox is
  // folded by its sender
  int* inbox_n = const_cast<int32_t*>(tables.adv) + 3 * in.n_adv;
  const int inbox_cap = min(C - 1, kInboxShare) * nwarps * 32;
  if (threadIdx.x < 2) inbox_n[threadIdx.x] = 0;
  cluster.sync();  // every peer's slice and inbox are set

  const int64_t tiles = (in.m + 31) / 32;
  const int64_t stride = (int64_t)gridDim.x * nwarps;
  const int64_t rounds = (tiles + stride - 1) / stride;
  const int64_t first_block = blockIdx.x - rank;  // the cluster's block 0
  const bool vec = (reinterpret_cast<uintptr_t>(in.records) & 15) == 0;
  int32_t* cur = smem + warp * 32 * d;
  int64_t t = (int64_t)blockIdx.x * nwarps + warp;
  if (t < tiles) stage_tile(cur, in.records, in.m, d, t, lane, vec);
  cp_async_commit();
  for (int64_t k = 0; k <= rounds; ++k, t += stride) {
    const int in_buf = (int)(k & 1), out_buf = in_buf ^ 1;
    // the last round's inbox: complete since the last barrier
    const int n = k > 0 ? min(inbox_n[out_buf], inbox_cap) : 0;
    __syncthreads();  // every thread has read the count before it is reset
    if (threadIdx.x == 0) inbox_n[out_buf] = 0;
    if (k < rounds && t < tiles) {  // warp-uniform
      cp_async_wait_all();
      __syncwarp();
      const int64_t r = t * 32 + lane;
      int owner = -1, li = 0;
      if (r < in.m) {
        const int32_t* rec = cur + lane * d;
        const int leaf =
            descend<true>(rec, in.nodes, in.depth, in.in_mask, in.bits);
        if (in.bids != nullptr && y == 0) in.bids[r] = leaf;
        if (leaf % R == y) {  // a leaf of this range
          owner = (leaf / R) % C;
          li = leaf / (R * C);
        }
        if (owner == rank) {
          atomicAdd(s.counts + li, 1);
          fold_record(rec, d, tables, s.lo + li * d, s.hi + li * d,
                      s.cat + li * g.cw, s.advt + li * g.aw,
                      s.advf + li * g.aw);
          owner = -1;
        }
      }
      const unsigned sending = __ballot_sync(0xffffffffu, owner >= 0);
      if (owner >= 0) {
        const unsigned same = __match_any_sync(sending, owner);
        const int leader = __ffs(same) - 1;
        int base = 0;
        if (lane == leader)
          base = atomicAdd(cluster.map_shared_rank(inbox_n + in_buf, owner),
                           __popc(same));
        base = __shfl_sync(same, base, leader);
        const int slot = base + __popc(same & ((1u << lane) - 1));
        if (slot < inbox_cap) {
          cluster.map_shared_rank(inbox_n + 2 + in_buf * inbox_cap,
                                  owner)[slot] =
              (li << kSenderBits) | ((rank * nwarps + warp) * 32 + lane);
        } else {  // the inbox is full: straight into the owner's slice
          const Aggs o = Aggs::at(cluster.map_shared_rank(s.counts, owner),
                                  P, d, g.cw, g.aw);
          atomicAdd(o.counts + li, 1);
          fold_record(cur + lane * d, d, tables, o.lo + li * d,
                      o.hi + li * d, o.cat + li * g.cw, o.advt + li * g.aw,
                      o.advf + li * g.aw);
        }
      }
      __syncwarp();  // every lane is done with `cur`
    }
    // the last round's inbox, 32 entries a warp at a time: their rows are
    // gathered into the warp's tile buffer (free until the next tile's
    // copy), each row's words by neighbouring lanes so that the reads
    // coalesce, and each lane folds one row from shared memory
    const int32_t* inbox = inbox_n + 2 + out_buf * inbox_cap;
    for (int i0 = warp * 32; i0 < n; i0 += nwarps * 32) {
      const int rows = min(32, n - i0);
      const int e = lane < rows ? inbox[i0 + lane] : 0;
      const int sender = e & ((1 << kSenderBits) - 1);
      const int s_block = sender / (nwarps * 32);
      const int s_warp = (sender >> 5) - s_block * nwarps;
      const int64_t row =
          ((first_block + s_block) * nwarps + s_warp + (k - 1) * stride) *
              32 + (sender & 31);
      for (int w0 = 0; w0 < rows * d; w0 += 32) {
        const int w = w0 + lane, u = w / d;
        const int64_t src_row = __shfl_sync(0xffffffffu, row, min(u, 31));
        if (w < rows * d)
          cp_async4(cur + w, in.records + src_row * d + (w - u * d));
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncwarp();
      if (lane < rows) {
        const int li = e >> kSenderBits;
        atomicAdd(s.counts + li, 1);
        fold_record(cur + lane * d, d, tables, s.lo + li * d, s.hi + li * d,
                    s.cat + li * g.cw, s.advt + li * g.aw,
                    s.advf + li * g.aw);
      }
      __syncwarp();  // every lane is done with `cur` before it is refilled
    }
    if (k < rounds && t + stride < tiles)
      stage_tile(cur, in.records, in.m, d, t + stride, lane, vec);
    cp_async_commit();
    if (k < rounds) cluster.sync();  // this round's inboxes are complete
  }
  // no peer touches this block's shared memory past the last round's
  // barrier: the slice is the block's own from here to its exit
  cp_async_wait_all();
  __syncthreads();
  flush_leaves(s, g, d, own_first, own_n, C * R);
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

enum Variant { kShared = 1, kGlobal = 2, kCluster = 3 };

cudaLaunchAttribute cluster_attr(int cluster) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

}  // namespace

// Check the launch plan of a tree, made by kernels/fused_ingest.py::
// layout_plan, against the card, and prepare its kernel: plan = {kernel,
// warps a block, dynamic shared bytes, most blocks (shared) or clusters
// (cluster) resident on the card}.  variant: 1 shared, 2 global (nothing
// to check), 3 cluster of `cluster` blocks, each holding per_block
// leaves, in `ranges` ranges.  The kernel's shared-memory limit is raised
// to all the card offers, so that a plan for a small tree never lowers
// what a larger tree's launches need; a request past it goes to CUDA,
// which refuses it.  Returns a cudaError_t: a request the card refuses is
// returned, never worked around, and cleared.
extern "C" int fused_ingest_plan(int variant, int warps, int smem,
                                 int cluster, int ranges, int per_block,
                                 int n_leaves, int* plan) {
  plan[0] = variant;
  plan[1] = warps;
  plan[2] = smem;
  plan[3] = 0;
  if (variant == kGlobal) return 0;
  if ((variant != kShared && variant != kCluster) || warps < 1 ||
      warps > kMaxWarps || smem < 0)
    return (int)cudaErrorInvalidValue;
  if (variant == kCluster &&
      (cluster < 1 || ranges < 1 || per_block < 1 ||
       (long long)cluster * ranges * per_block < n_leaves))
    return (int)cudaErrorInvalidValue;  // a leaf no block owns
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!err)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return (int)err;
  const void* kernel = variant == kShared
                           ? (const void*)fused_ingest_shared
                           : (const void*)fused_ingest_cluster;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem > optin ? smem : optin);
  if (variant == kShared) {
    int per_sm = 0;
    if (!err)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_ingest_shared, warps * 32, (size_t)smem);
    plan[3] = sms * (per_sm > 0 ? per_sm : 1);
  } else {
    // clusters past the portable 8 blocks need the kernel's consent; the
    // card says how many clusters fit at once, which may be fewer than
    // sms / C (a cluster's blocks must share one GPC)
    if (!err && cluster > 8)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr = cluster_attr(cluster);
    cfg.gridDim = dim3((unsigned)cluster, 1, 1);
    cfg.blockDim = dim3((unsigned)(warps * 32), 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (!err) err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (!err && clusters < 1) err = cudaErrorInvalidConfiguration;
    plan[3] = clusters;
  }
  if (err) {
    cudaGetLastError();  // clear it: the next launch must not see it
    return (int)err;
  }
  return 0;
}

// One batch, by the plan fused_ingest_plan checked: no host query of the
// card.  Returns the launch's error, or cudaGetLastError().
extern "C" int fused_ingest_launch(
    const int32_t* records, int64_t m, int d, const int32_t* nodes,
    int depth, const int32_t* cat_off, const uint8_t* in_mask, int bits,
    const int32_t* adv, const int32_t* cat_dims, int n_cat_dims, int n_adv,
    int32_t* bids, void* counts, int32_t* lo, int32_t* hi, int32_t* cat,
    int32_t* advt, int32_t* advf, int n_leaves, int cw, int aw,
    int variant, int warps, int smem, int most, int cluster, int ranges,
    int per_block, void* stream) {
  Ingest in{records, m, d, reinterpret_cast<const int4*>(nodes), depth,
            cat_off, in_mask, bits, adv, cat_dims, n_cat_dims, n_adv, bids};
  Acc g{reinterpret_cast<unsigned long long*>(counts), lo, hi,
        reinterpret_cast<uint32_t*>(cat), reinterpret_cast<uint32_t*>(advt),
        reinterpret_cast<uint32_t*>(advf), n_leaves, cw, aw};
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t tiles = (m + 31) / 32;
  if (variant == kShared) {
    int64_t blocks = (tiles + warps - 1) / warps;
    if (blocks > most) blocks = most;
    fused_ingest_shared<<<(unsigned)blocks, warps * 32, (size_t)smem, st>>>(
        in, g);
  } else if (variant == kCluster) {
    // the resident clusters shared among the ranges, never more than a
    // range's tiles need
    int64_t per_range = most / ranges;
    const int64_t need = (tiles + (int64_t)cluster * warps - 1) /
                         ((int64_t)cluster * warps);
    if (per_range > need) per_range = need;
    if (per_range < 1) per_range = 1;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr = cluster_attr(cluster);
    cfg.gridDim = dim3((unsigned)(per_range * cluster), (unsigned)ranges, 1);
    cfg.blockDim = dim3((unsigned)(warps * 32), 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = st;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, fused_ingest_cluster, in, g, per_block);
    if (err) {
      cudaGetLastError();
      return (int)err;
    }
  } else if (variant == kGlobal) {
    const int threads = warps * 32;
    fused_ingest_global<<<grid_for(m, threads), threads, 0, st>>>(in, g);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
