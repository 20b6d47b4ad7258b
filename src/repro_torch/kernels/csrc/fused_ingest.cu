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
// Four designs; the plan (kernels/fused_ingest.py::layout_plan) picks one
// by shape once a tree:
//
//  * fused_ingest_shared: a persistent grid, about one block per SM.  Each
//    block keeps the whole tree's aggregates in dynamic shared memory
//    (142 KB at 724 leaves x 21 columns), so a record's 40-odd atomics are
//    shared-memory atomics.  Each warp stages contiguous tiles of 32 rows
//    with 16-byte cp.async into its own buffer, so record reads coalesce;
//    each lane then reads its row from shared memory.  The block takes as
//    many warps as fit beside the aggregates (32 at 724 x 21): the descent
//    is latency-bound, and other warps hide a warp's next copy.  Past an
//    accumulator's first fold, the block's aggregates start as the running
//    ones (the counts at 0), copied in by cp.async beside the first tiles'
//    staging: min, max and or move one way, so a seed read while other
//    blocks or streams merge is stale only in the safe direction.  A row's
//    read-checks then fire only where it beats every batch before, and
//    such a row marks its leaf in a bit a leaf.  At the end the block adds
//    every count, and its warps share out the marked leaves alone, lanes
//    over a leaf's words, each merged with a read-checked global atomic.
//    Started from identities, a block saw about 11 rows of a leaf in the
//    benchmark's generated order, and 15.2 shared atomics a row fired
//    against 0.002-0.007 from the running aggregates
//    (tools/fold_access_stats.py); the flush read all 724 leaves of every
//    block.  Measured on an H100 (PERF.md section 6): the shared atomics
//    were a small part of the time; the flush that skips the unmarked
//    leaves is most of the gain.  The first fold, into the identities,
//    keeps the identity start and the whole flush (eight reads in flight a
//    thread): seeded, where nearly every leaf of every block is marked,
//    it measured slower (PERF.md section 6).
//
//  * fused_ingest_cluster, forced only (the leafwise design measured
//    faster where the plan took it, PERF.md section 6): for a tree whose
//    aggregates do not fit one block (past about 1,100 leaves at 21
//    columns) but fit a cluster of two beside 32 warps a block (about
//    1,380 leaves).  A thread block
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
//  * fused_ingest_leafwise: for trees past the cluster kernel's band, whose
//    aggregates (1.6 MB at 8,000 leaves, 4 MB at 20,000) fit no block or
//    cluster.  The first draft below folds each record into them with
//    about 45 dependent read-checked global atomics; this design routes
//    once, sorts the rows by leaf, and folds each leaf's rows with one
//    owner, so that the running accumulators take one read-checked atomic
//    a word per run of a leaf's rows, not one a record.  Four kernels, in
//    stream order, from the one entry fused_ingest_launch, with no host
//    work between them:
//    1. fused_ingest_leafwise_route: route_descend_prefix's descent (the
//       tree's BFS prefix staged in shared memory under evict_last, 32-row
//       record tiles a warp under evict_first, descend.cuh::descend_prefix);
//       each record's leaf id goes to an int32 scratch (the block ids when
//       asked), and into a per-block histogram of leaf counts in shared
//       memory beside the prefix and the tiles (4 bytes a leaf: 32 KB at
//       8,000 leaves, 80 KB at 20,000), whose shared atomic gives the
//       record its rank among the block's rows of its leaf.  At the end
//       each count goes to a per-leaf count in global memory with one
//       returning atomic, which gives the block's first place in the leaf,
//       and the block adds it to its rows' ranks: each row's slot within
//       its leaf.  No global atomic runs a record.
//    2. fused_ingest_leafwise_scan: one block.  The exclusive scan of the
//       per-leaf counts gives each leaf's first row in leaf order.
//    3. fused_ingest_leafwise_scatter: each row's (leaf << 32 | row) to its
//       leaf's first slot plus its own, with no atomic.  The order within
//       a leaf is the atomics' and does not matter: min, max and or are
//       commutative.  Each per-leaf count is added to the running counts
//       (one atomic a leaf, spread over the grid) and zeroed for the next
//       batch.
//    4. fused_ingest_leafwise_fold: the leaf-ordered rows cut into chunks
//       of at most kChunk (64) rows (at every multiple of kChunk and at
//       every leaf boundary), one warp a chunk of kChunk positions, 32 at a
//       time (a group; the next group's entries load while one is
//       folded).  First lane r takes the group's row r and builds its
//       categorical and advanced-cut words (these loads bring the rows
//       into L1).  The group falls in segments of one leaf each; for each,
//       lane j holds column j (in groups of 32 columns, so 160 columns
//       take five registers of lo and five of hi, and never spill) and
//       folds the segment's rows' min and max, kFoldRows loads in flight,
//       and __reduce_or_sync folds the segment's lanes' words.  A run of
//       one leaf's rows keeps its aggregates across segments; its first
//       segment issues the plain reads of the leaf's running words, which
//       have landed by the time the run ends and its words are merged,
//       each with one read-checked atomic.  The merges stay atomic, so a
//       leaf split over chunks, or two streams folding into one
//       accumulator, need no special case; each stream has its own
//       scratch.
//    Measured on an H100 (PERF.md section 6): a first fold, one row a step
//    with its bits through shared lookups and atomics, took twice this
//    design's time; this one was no faster with the rows prefetched to L1
//    or L2, more loads in flight, longer or shorter chunks, a lane's words
//    ored in shared memory, each group's rows gathered into shared memory
//    by cp.async first, the bits kept by column in registers, the bits
//    computed by the route kernel, or a lane a row with each column's min
//    and max reduced over a segment by redux.sync (slower).  The fold is
//    still most of the design's time; what bounds it past the gather of
//    random 84-byte rows is not known.
//    Bound, the function's: bytes, as below (0.0274 to 0.0289 ms at 8,000
//    to 20,000 leaves).  This design's own floor is higher: it reads the
//    records twice, coalesced in stage 1 and gathered by row in stage 4
//    (84 bytes a row spans three or four 32-byte sectors: 88 to 117 MB a
//    2**20-row batch), and writes and reads the ids, the slots and the
//    leaf order (16 bytes a row each way, about 34 MB): 0.06 to 0.07 ms at
//    3.35 TB/s,
//    about 2.3x the function's bound.  The descent's latency bounds stage
//    1 as it bounds route_descend_prefix; stage 4 is a gather, bound by
//    the sectors it reads.  It reaches trees where two blocks, or one of
//    more warps, of route_descend_prefix's warps fit beside the histogram
//    (up to about 41,000 leaves at 21 columns), of at most 256 columns and
//    1,024 advanced cuts; the plan takes it on every such tree.
//
//  * fused_ingest_global: the first draft, for trees past the leafwise
//    design's reach: one thread per record, unstaged loads and
//    read-checked global atomics straight into the running accumulators.  On an H100 it was as fast as the
//    cluster kernel at 1,350 leaves and faster on every larger tree (0.23
//    against 0.34 ms at 1,800, where a block of two keeps 17 warps; 0.27
//    against 0.42 at 8,000 with 16 blocks; PERF.md section 6): its
//    atomics spread over more addresses as leaves grow, while the
//    cluster kernel loses the warps that hide its descent, sends a larger
//    share of its rows to other blocks, and past 16 blocks descends the
//    batch once a range.  Its time varies with the tree far more than the
//    leafwise design's (a repeated fold skips the atomics whose read
//    shows no change).

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

// Set `bit` of `word` unless a plain read shows it set; whether it wrote.
__device__ __forceinline__ bool or_bit(uint32_t* word, uint32_t bit) {
  if (*word & bit) return false;
  atomicOr(word, bit);
  return true;
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

// Copy the fold's tables into shared memory at `at`: [cat_dims][cat_off
// d][adv 3 x n_adv].  Ends before any barrier.
__device__ __forceinline__ FoldTables stage_tables(int32_t* at,
                                                   const Ingest& in) {
  int32_t* s_cat_dims = at;
  int32_t* s_cat_off = s_cat_dims + in.n_cat_dims;
  int32_t* s_adv = s_cat_off + in.d;
  for (int i = threadIdx.x; i < in.n_cat_dims; i += blockDim.x)
    s_cat_dims[i] = in.cat_dims[i];
  for (int i = threadIdx.x; i < in.d; i += blockDim.x)
    s_cat_off[i] = in.cat_off[i];
  for (int i = threadIdx.x; i < 3 * in.n_adv; i += blockDim.x)
    s_adv[i] = in.adv[i];
  return FoldTables{s_cat_dims, s_cat_off, s_adv, in.n_cat_dims, in.n_adv,
                    in.bits};
}

// Lay out a block's shared memory, [stage: nwarps x 32 rows][aggregates of
// n leaves][tables]; set the aggregates to their identities and copy the
// tables in.  Ends before any barrier.
__device__ __forceinline__ Aggs setup_block(int32_t* smem, const Ingest& in,
                                            const Acc& g, int n,
                                            FoldTables* tables) {
  const int d = in.d, nwarps = blockDim.x >> 5;
  const Aggs a = Aggs::at(smem + nwarps * 32 * d, n, d, g.cw, g.aw);
  for (int i = threadIdx.x; i < n; i += blockDim.x) a.counts[i] = 0;
  for (int i = threadIdx.x; i < n * d; i += blockDim.x) {
    a.lo[i] = INT32_MAX;
    a.hi[i] = INT32_MIN;
  }
  for (int i = threadIdx.x; i < n * (g.cw + 2 * g.aw); i += blockDim.x)
    a.cat[i] = 0;  // cat, advt and advf are contiguous
  *tables = stage_tables(a.end(n, g.aw), in);
  return a;
}

// Seed the block's aggregates of all L leaves, `s`, with the running lo,
// hi, cat, advt and advf, which hold their words in the same order: 16-byte
// cp.async from every thread where both ends of an array are 16-byte
// aligned, 4-byte elsewhere, in the calling thread's open commit group.
// Every block reads the same words at once, so each starts its 16-byte
// chunks at its own place in them.  (One TMA bulk copy an array, by one
// thread onto an mbarrier, measured no faster on an H100: PERF.md section
// 6.)
__device__ __forceinline__ void seed_aggs(const Aggs& s, const Acc& g, int d) {
  const int L = g.n_leaves;
  int32_t* const dst[5] = {s.lo, s.hi, reinterpret_cast<int32_t*>(s.cat),
                           reinterpret_cast<int32_t*>(s.advt),
                           reinterpret_cast<int32_t*>(s.advf)};
  const int32_t* const src[5] = {g.lo, g.hi,
                                 reinterpret_cast<const int32_t*>(g.cat),
                                 reinterpret_cast<const int32_t*>(g.advt),
                                 reinterpret_cast<const int32_t*>(g.advf)};
  const int n[5] = {L * d, L * d, L * g.cw, L * g.aw, L * g.aw};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const bool vec = ((reinterpret_cast<uintptr_t>(src[k]) |
                       __cvta_generic_to_shared(dst[k])) & 15) == 0;
    const int whole = vec ? n[k] & ~3 : 0;
    const int chunks = whole >> 2;
    const int first = (int)((int64_t)blockIdx.x * chunks / gridDim.x);
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
      const int i = c + first < chunks ? c + first : c + first - chunks;
      cp_async16(dst[k] + 4 * i, src[k] + 4 * i);
    }
    for (int i = whole + threadIdx.x; i < n[k]; i += blockDim.x)
      cp_async4(dst[k] + i, src[k] + i);
  }
}

// Fold one record (row `rec`, block `leaf`) into a set of accumulators
// whose per-leaf rows start at the given pointers.  Used on shared and on
// global memory alike; inlined, so each call site's atomics address the
// right space.  Returns whether any atomic ran (a call site that does not
// ask compiles without the test).
__device__ __forceinline__ bool fold_record(const int32_t* rec, int d,
                                            const FoldTables& t, int32_t* lo,
                                            int32_t* hi, uint32_t* cat,
                                            uint32_t* advt, uint32_t* advf) {
  bool wrote = false;
  for (int j = 0; j < d; ++j) {
    const int32_t v = rec[j];
    if (v < lo[j]) {
      atomicMin(lo + j, v);
      wrote = true;
    }
    if (v > hi[j]) {
      atomicMax(hi + j, v);
      wrote = true;
    }
  }
  for (int k = 0; k < t.n_cat_dims; ++k) {
    const int dd = t.cat_dims[k];
    int pos = rec[dd] + t.cat_off[dd];
    pos = min(max(pos, 0), t.bits - 1);
    wrote |= or_bit(cat + (pos >> 5), 1u << (pos & 31));
  }
  for (int a = 0; a < t.n_adv; ++a) {
    const int32_t* p = t.adv + 3 * a;
    const bool truth = adv_true(p[1], rec[p[0]], rec[p[2]]);
    wrote |= or_bit((truth ? advt : advf) + (a >> 5), 1u << (a & 31));
  }
  return wrote;
}

// The read-checked merges into the running aggregates: an atomic only
// where the block's value `v` moves the running word, read as `seen`.
struct MergeMin {
  __device__ void operator()(int32_t* p, int32_t v, int32_t seen) const {
    if (v < seen) atomicMin(p, v);
  }
};
struct MergeMax {
  __device__ void operator()(int32_t* p, int32_t v, int32_t seen) const {
    if (v > seen) atomicMax(p, v);
  }
};
struct MergeOr {
  __device__ void operator()(uint32_t* p, uint32_t v, uint32_t seen) const {
    if ((seen & v) != v) atomicOr(p, v);
  }
};

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
  flush(s.lo, g.lo + (int64_t)first * d, n * d, d, step, MergeMin{});
  flush(s.hi, g.hi + (int64_t)first * d, n * d, d, step, MergeMax{});
  flush(s.cat, g.cat + (int64_t)first * g.cw, n * g.cw, g.cw, step,
        MergeOr{});
  flush(s.advt, g.advt + (int64_t)first * g.aw, n * g.aw, g.aw, step,
        MergeOr{});
  flush(s.advf, g.advf + (int64_t)first * g.aw, n * g.aw, g.aw, step,
        MergeOr{});
}

// One word of leaf `leaf`'s aggregates: word k of [lo d][hi d][cat cw]
// [advt aw][advf aw], its value in the block's (s) and its address in the
// running ones (g), and how it merges (0 MergeMin, 1 MergeMax, 2 MergeOr).
struct LeafWord {
  int32_t* at;
  int32_t v;
  int op;
};

__device__ __forceinline__ LeafWord leaf_word(const Aggs& s, const Acc& g,
                                              int d, int leaf, int k) {
  if (k < d) return {g.lo + (int64_t)leaf * d + k, s.lo[leaf * d + k], 0};
  if ((k -= d) < d)
    return {g.hi + (int64_t)leaf * d + k, s.hi[leaf * d + k], 1};
  k -= d;
  const uint32_t* sw;
  uint32_t* gw;
  if (k < g.cw) {
    sw = s.cat + leaf * g.cw + k;
    gw = g.cat + (int64_t)leaf * g.cw + k;
  } else if ((k -= g.cw) < g.aw) {
    sw = s.advt + leaf * g.aw + k;
    gw = g.advt + (int64_t)leaf * g.aw + k;
  } else {
    k -= g.aw;
    sw = s.advf + leaf * g.aw + k;
    gw = g.advf + (int64_t)leaf * g.aw + k;
  }
  return {reinterpret_cast<int32_t*>(gw), (int32_t)*sw, 2};
}

// Merge one leaf of the block's aggregates into the running ones, a warp's
// lanes over its words, kMergeWords reads in flight a lane (the leaf's
// 2 d + cw + 2 aw words in one round at 21 columns).
constexpr int kMergeWords = 2;

__device__ __forceinline__ void merge_leaf(const Aggs& s, const Acc& g, int d,
                                           int leaf, int lane) {
  const int n = 2 * d + g.cw + 2 * g.aw;
  for (int k0 = lane; k0 < n; k0 += 32 * kMergeWords) {
    LeafWord w[kMergeWords];
    int32_t seen[kMergeWords];
#pragma unroll
    for (int u = 0; u < kMergeWords; ++u) {
      const int k = k0 + 32 * u;
      w[u].op = -1;
      if (k < n) {
        w[u] = leaf_word(s, g, d, leaf, k);
        seen[u] = __ldcg(w[u].at);
      }
    }
#pragma unroll
    for (int u = 0; u < kMergeWords; ++u) {
      if (w[u].op == 0) MergeMin{}(w[u].at, w[u].v, seen[u]);
      if (w[u].op == 1) MergeMax{}(w[u].at, w[u].v, seen[u]);
      if (w[u].op == 2)
        MergeOr{}(reinterpret_cast<uint32_t*>(w[u].at), w[u].v, seen[u]);
    }
  }
}

// Flush the shared kernel's block: every count, then the leaves marked in
// `changed` (a bit a leaf), shared out in turn by their rank among the
// marked: warp w merges ranks w, w + nwarps, ...
__device__ __forceinline__ void flush_marked(const Aggs& s, const Acc& g,
                                             int d, const uint32_t* changed) {
  const int L = g.n_leaves;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const int c = s.counts[i];
    if (c) atomicAdd(g.counts + i, (unsigned long long)c);
  }
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int words = (L + 31) >> 5;
  int before = 0;  // marked leaves in the words before w0
  for (int w0 = 0; w0 < words; w0 += 32) {
    const uint32_t bits = w0 + lane < words ? changed[w0 + lane] : 0u;
    const int c = __popc(bits);
    int incl = c;  // the warp's inclusive scan of the words' marks
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += x;
    }
    const int first = before + incl - c;  // rank of this word's first mark
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    for (int r = before + ((warp - before) % nwarps + nwarps) % nwarps;
         r < before + total; r += nwarps) {
      // the word that holds rank r, and its (r - first)-th mark
      const int src = __ffs(__ballot_sync(
                          0xffffffffu, r >= first && r < first + c)) - 1;
      uint32_t b = __shfl_sync(0xffffffffu, bits, src);
      for (int k = r - __shfl_sync(0xffffffffu, first, src); k > 0; --k)
        b &= b - 1;
      merge_leaf(s, g, d, (w0 + src) * 32 + __ffs(b) - 1, lane);
    }
    before += total;
  }
}

// Shared memory: [stage: nwarps x 32 rows][aggregates of all L leaves]
// [tables][changed: a bit a leaf].  kSeeded: the aggregates start as the
// running ones (seed_aggs), the counts at 0; a row that moves a value of
// its leaf marks the leaf, and the flush merges only the marked leaves
// beyond their counts.  Otherwise, for an accumulator's first fold (it
// holds the identities), they start as the identities and the flush merges
// every leaf.
template <bool kSeeded>
__global__ void __launch_bounds__(kMaxWarps * 32)
    fused_ingest_shared(Ingest in, Acc g) {
  extern __shared__ __align__(16) int32_t smem[];
  const int L = g.n_leaves, d = in.d;
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  FoldTables tables;
  const Aggs s = kSeeded ? Aggs::at(smem + nwarps * 32 * d, L, d, g.cw, g.aw)
                         : setup_block(smem, in, g, L, &tables);
  if (kSeeded) {
    seed_aggs(s, g, d);
    cp_async_commit();
  } else {
    __syncthreads();
  }

  // each warp walks its own tiles of 32 rows through its one buffer: the
  // next tile's copy is issued once this one is folded, and other warps
  // hide it.  Seeded, the first goes out beside the seed.
  const int64_t tiles = (in.m + 31) / 32;
  const int64_t stride = (int64_t)gridDim.x * nwarps;
  const bool vec = (reinterpret_cast<uintptr_t>(in.records) & 15) == 0;
  int32_t* cur = smem + warp * 32 * d;
  int64_t t = (int64_t)blockIdx.x * nwarps + warp;
  if (t < tiles) stage_tile(cur, in.records, in.m, d, t, lane, vec);
  cp_async_commit();
  uint32_t* changed = nullptr;
  if (kSeeded) {
    for (int i = threadIdx.x; i < L; i += blockDim.x) s.counts[i] = 0;
    tables = stage_tables(s.end(L, g.aw), in);
    changed = reinterpret_cast<uint32_t*>(
        const_cast<int32_t*>(tables.adv) + 3 * in.n_adv);
    for (int i = threadIdx.x; i < (L + 31) >> 5; i += blockDim.x)
      changed[i] = 0;
    cp_async_wait<1>();  // this thread's seed words (its tile may still fly)
    __syncthreads();     // every seed word has landed, every count is 0
  }

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
      const bool moved =
          fold_record(rec, d, tables, s.lo + leaf * d, s.hi + leaf * d,
                      s.cat + leaf * g.cw, s.advt + leaf * g.aw,
                      s.advf + leaf * g.aw);
      if (kSeeded && moved) or_bit(changed + (leaf >> 5), 1u << (leaf & 31));
    }
    __syncwarp();  // every lane is done with `cur` before it is refilled
    if (t + stride < tiles)
      stage_tile(cur, in.records, in.m, d, t + stride, lane, vec);
    cp_async_commit();
  }
  cp_async_wait_all();
  __syncthreads();
  if (kSeeded)
    flush_marked(s, g, d, changed);
  else
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

// ---------------------------------------------------------------------------
// fused_ingest_leafwise: route, scan, scatter, fold (the note at the top)
// ---------------------------------------------------------------------------
constexpr int kFoldWarps = 8;   // the fold's blocks: 256 threads
constexpr int kChunk = 64;      // the fold's chunks: positions a warp's each
constexpr int kFoldRows = 8;    // column loads in flight a lane in the fold
constexpr int kMaxGroups = 8;   // the fold's columns, 32 a group: at most 256
constexpr int kCatWords = 8;    // categorical words a lane builds at a time
constexpr int kScanThreads = 1024;
constexpr unsigned kAll = 0xffffffffu;

// The leaf id of every row into `ids`, its slot among its leaf's rows
// into `slots`, and the batch's count of each leaf into `hist` (zero on
// entry), by way of a per-block histogram in shared memory: [prefix nodes
// x 16 B][stage: nwarps x 32 rows][histogram: L].  A row's rank among its
// block's rows of its leaf is what its shared atomic returns; once the
// block's rows are routed, each leaf's count goes to `hist` with one
// returning atomic, which gives the block's first slot in the leaf, and
// each thread adds it to its own rows' ranks (in L2, written by itself).
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    fused_ingest_leafwise_route(Ingest in, int prefix, int n_leaves,
                                int32_t* ids, int32_t* slots,
                                int32_t* hist) {
  extern __shared__ __align__(16) int32_t smem[];
  int4* s_nodes = reinterpret_cast<int4*>(smem);
  const int d = in.d, nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int32_t* cur = smem + 4 * prefix + warp * 32 * d;
  int32_t* s_hist = smem + 4 * prefix + nwarps * 32 * d;
  const uint64_t keep = l2_evict_last(), once = l2_evict_first();

  const int64_t tiles = (in.m + 31) / 32;
  const int64_t stride = (int64_t)gridDim.x * nwarps;
  const bool vec = (reinterpret_cast<uintptr_t>(in.records) & 15) == 0;
  const int64_t t0 = (int64_t)blockIdx.x * nwarps + warp;
  int64_t t = t0;
  // the first tile's copy and the prefix's copy go out together
  if (t < tiles) stage_tile<32, true>(cur, in.records, in.m, d, t, lane, vec,
                                      once);
  for (int i = threadIdx.x; i < prefix; i += blockDim.x)
    cp_async16(s_nodes + i, in.nodes + i, keep);
  cp_async_commit();
  for (int i = threadIdx.x; i < n_leaves; i += blockDim.x) s_hist[i] = 0;
  cp_async_wait_all();
  __syncthreads();  // every node copy has landed, the histogram is zero

  for (; t < tiles; t += stride) {
    const int64_t row = t * 32 + lane;
    int leaf = -1;
    if (row < in.m)
      leaf = descend_prefix(cur + lane * d, s_nodes, prefix, in.nodes,
                            in.depth, in.in_mask, in.bits, keep);
    __syncwarp();  // every lane is done with `cur` before it is refilled
    if (t + stride < tiles)
      stage_tile<32, true>(cur, in.records, in.m, d, t + stride, lane, vec,
                           once);
    cp_async_commit();
    if (leaf >= 0) {
      ids[row] = leaf;
      slots[row] = atomicAdd(s_hist + leaf, 1);
    }
    cp_async_wait_all();  // the next tile's copies have landed (own lane's)
    __syncwarp();        // ... and every lane's
  }
  __syncthreads();
  // each leaf's count out, its first slot for this block back, four leaves
  // a thread in flight
  for (int i0 = threadIdx.x; i0 < n_leaves; i0 += 4 * blockDim.x) {
    int c[4], base[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + r * blockDim.x;
      c[r] = i < n_leaves ? s_hist[i] : 0;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      base[r] = c[r] ? atomicAdd(hist + i0 + r * blockDim.x, c[r]) : 0;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (c[r]) s_hist[i0 + r * blockDim.x] = base[r];
  }
  __syncthreads();
  // each thread's own rows again, four tiles' loads in flight
  for (t = t0; t < tiles; t += 4 * stride) {
    int leaf[4], slot[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t row = (t + r * stride) * 32 + lane;
      leaf[r] = row < in.m ? ids[row] : -1;
      slot[r] = row < in.m ? slots[row] : 0;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (leaf[r] >= 0) slots[(t + r * stride) * 32 + lane] = slot[r] + s_hist[leaf[r]];
  }
}

// One block of kScanThreads: offsets = the exclusive scan of hist
// (offsets[L] = the rows).  Tiles of 4 kScanThreads leaves, four
// consecutive a thread, the running total carried from tile to tile.
__global__ void __launch_bounds__(kScanThreads)
    fused_ingest_leafwise_scan(const int32_t* hist, int32_t* offsets,
                               int n_leaves) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < n_leaves; base += 4 * kScanThreads) {
    const int first = base + 4 * (int)threadIdx.x;
    int c[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      c[r] = first + r < n_leaves ? hist[first + r] : 0;
    const int sum = c[0] + c[1] + c[2] + c[3];
    int incl = sum;  // the warp's inclusive scan
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kAll, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kAll, w, o);
        if (lane >= o) w += v;
      }
      warp_sums[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    int run = carry + incl - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (first + r < n_leaves) {
        offsets[first + r] = run;
        run += c[r];
      }
    }
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();  // warp_sums is the next tile's
  }
  if (threadIdx.x == 0) offsets[n_leaves] = carry;
}

// Each row's (leaf << 32 | row) into `entries` at its leaf's first slot
// (offsets) plus its slot among the leaf's rows (slots); and each leaf's
// count added to the running counts (one atomic a leaf, over the whole
// grid) and zeroed for the next batch.
__global__ void fused_ingest_leafwise_scatter(
    const int32_t* ids, const int32_t* slots, int64_t m,
    const int32_t* offsets, long long* entries, int32_t* hist,
    unsigned long long* counts, int n_leaves) {
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = first; r < m; r += step) {
    const int leaf = ids[r];
    entries[__ldg(offsets + leaf) + slots[r]] =
        ((long long)leaf << 32) | (long long)r;
  }
  for (int64_t l = first; l < n_leaves; l += step) {
    const int c = hist[l];
    if (c) {
      atomicAdd(counts + l, (unsigned long long)c);
      hist[l] = 0;
    }
  }
}

// One warp a chunk of kChunk positions of the leaf order, 32 positions (a
// group) at a time, the next group's entries loaded while one is folded.
// First lane r takes the group's row r: its categorical and advanced-cut
// words (a word of each: cw + 2 aw) go to the warp's lane words in shared
// memory; these loads bring the rows into L1.  The group's rows fall in
// segments of one leaf each, and a run of one leaf spans the segments of
// consecutive groups.  Per segment: the columns' min and max with lane j
// holding column j (in G groups of 32; d <= 32 G), kFoldRows / G rows'
// loads in flight; each word of bits, __reduce_or_sync over the segment's
// lanes, kept for the run (categorical words in shared memory, written by
// lane 0; advanced-cut word w by lane w).  Shared memory: [the runs'
// categorical words: kFoldWarps x cw][lane words: kFoldWarps x (cw + 2 aw)
// x 32][cat_dims][cat_off d][adv 3 x n_adv].
template <int G>
__global__ void __launch_bounds__(kFoldWarps * 32)
    fused_ingest_leafwise_fold(Ingest in, Acc g, const long long* entries) {
  constexpr int U = kFoldRows / G > 0 ? kFoldRows / G : 1;  // rows a step
  extern __shared__ __align__(16) int32_t smem[];
  const int d = in.d, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cw = g.cw, aw = g.aw, nw = cw + 2 * aw;
  const int n_cat = in.n_cat_dims, n_adv = in.n_adv, bits = in.bits;
  uint32_t* s_cat = reinterpret_cast<uint32_t*>(smem) + warp * cw;
  uint32_t* s_lane = reinterpret_cast<uint32_t*>(smem) + kFoldWarps * cw +
                     warp * nw * 32 + lane;  // word w: s_lane[32 w]
  int32_t* s_cat_dims = smem + kFoldWarps * (cw + nw * 32);
  int32_t* s_cat_off = s_cat_dims + n_cat;
  int32_t* s_adv = s_cat_off + d;
  for (int i = threadIdx.x; i < kFoldWarps * cw; i += blockDim.x) smem[i] = 0;
  for (int i = threadIdx.x; i < n_cat; i += blockDim.x)
    s_cat_dims[i] = in.cat_dims[i];
  for (int i = threadIdx.x; i < d; i += blockDim.x) s_cat_off[i] = in.cat_off[i];
  for (int i = threadIdx.x; i < 3 * n_adv; i += blockDim.x) s_adv[i] = in.adv[i];
  __syncthreads();

  // a run of one leaf's rows: its aggregates (lane j: columns j, 32 + j,
  // ...; lane w: advanced-cut word w; the categorical words in s_cat), and
  // its leaf's running words as read when the run opened
  int32_t lo[G], hi[G], seen_lo[G], seen_hi[G];
  uint32_t run_t = 0, run_f = 0, seen_cat = 0, seen_t = 0, seen_f = 0;
  int leaf = -1;

  const auto open_run = [&](int l) {
    leaf = l;
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int j = 32 * q + lane;
      lo[q] = INT32_MAX;
      hi[q] = INT32_MIN;
      if (j < d) {
        seen_lo[q] = __ldcg(g.lo + (int64_t)l * d + j);
        seen_hi[q] = __ldcg(g.hi + (int64_t)l * d + j);
      }
    }
    seen_cat = lane < cw ? __ldcg(g.cat + (int64_t)l * cw + lane) : 0u;
    seen_t = lane < aw ? __ldcg(g.advt + (int64_t)l * aw + lane) : 0u;
    seen_f = lane < aw ? __ldcg(g.advf + (int64_t)l * aw + lane) : 0u;
    run_t = run_f = 0;
  };
  // merge the run into the running accumulators: one read-checked atomic a
  // word (the reads open_run issued)
  const auto close_run = [&]() {
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int j = 32 * q + lane;
      if (j < d) {
        const int64_t at = (int64_t)leaf * d + j;
        if (lo[q] < seen_lo[q]) atomicMin(g.lo + at, lo[q]);
        if (hi[q] > seen_hi[q]) atomicMax(g.hi + at, hi[q]);
      }
    }
    __syncwarp();  // lane 0's categorical words are in s_cat
    for (int w = lane; w < cw; w += 32) {
      const uint32_t b = s_cat[w];
      if (b) {
        uint32_t* p = g.cat + (int64_t)leaf * cw + w;
        const uint32_t seen = w < 32 ? seen_cat : __ldcg(p);
        if ((seen & b) != b) atomicOr(p, b);
        s_cat[w] = 0;
      }
    }
    __syncwarp();
    if (lane < aw) {
      const int64_t at = (int64_t)leaf * aw + lane;
      if (run_t & ~seen_t) atomicOr(g.advt + at, run_t);
      if (run_f & ~seen_f) atomicOr(g.advf + at, run_f);
    }
  };

  const int64_t n_chunks = (in.m + kChunk - 1) / kChunk;
  for (int64_t c = (int64_t)blockIdx.x * kFoldWarps + warp; c < n_chunks;
       c += (int64_t)gridDim.x * kFoldWarps) {
    const int64_t e = min((c + 1) * kChunk, in.m);
    long long next =
        entries[c * kChunk + min((int64_t)lane, e - c * kChunk - 1)];
    for (int64_t p0 = c * kChunk; p0 < e; p0 += 32) {
      const int n = (int)min((int64_t)32, e - p0);
      const long long ent = next;
      if (p0 + 32 < e)  // warp-uniform
        next = entries[p0 + 32 + min((int64_t)lane, e - p0 - 33)];
      const int my_leaf = (int)(ent >> 32);
      const int my_row = (int)(ent & 0xffffffffLL);
      const int32_t* my_rec = in.records + (int64_t)my_row * d;
      // the bits of row `lane` (past n: the last row again, not reduced)
      for (int q0 = 0; q0 < cw; q0 += kCatWords) {
        uint32_t word[kCatWords] = {};
        for (int k = 0; k < n_cat; ++k) {
          const int dim = s_cat_dims[k];
          int pos = __ldg(my_rec + dim) + s_cat_off[dim];
          pos = min(max(pos, 0), bits - 1);
          const int at = (pos >> 5) - q0;
#pragma unroll
          for (int r = 0; r < kCatWords; ++r)
            if (at == r) word[r] |= 1u << (pos & 31);
        }
#pragma unroll
        for (int r = 0; r < kCatWords; ++r)
          if (q0 + r < cw) s_lane[32 * (q0 + r)] = word[r];
      }
      for (int w = 0; w < aw; ++w) {
        uint32_t t = 0, f = 0;
        const int last = min(32 * w + 32, n_adv);
        for (int a = 32 * w; a < last; ++a) {
          const int32_t* p = s_adv + 3 * a;
          const uint32_t bit = 1u << (a & 31);
          if (adv_true(p[1], __ldg(my_rec + p[0]), __ldg(my_rec + p[2])))
            t |= bit;
          else
            f |= bit;
        }
        s_lane[32 * (cw + 2 * w)] = t;
        s_lane[32 * (cw + 2 * w + 1)] = f;
      }
      const int prev = __shfl_up_sync(kAll, my_leaf, 1);
      unsigned starts =
          __ballot_sync(kAll, lane < n && (lane == 0 || my_leaf != prev));
      while (starts) {  // the group's segments; warp-uniform
        const int s0 = __ffs(starts) - 1;
        starts &= starts - 1;
        const int s1 = starts ? __ffs(starts) - 1 : n;
        const int l = __shfl_sync(kAll, my_leaf, s0);
        if (l != leaf) {
          if (leaf >= 0) close_run();
          open_run(l);
        }
        // min and max: U rows' loads, then their folds (past the segment:
        // its last row again, which changes neither)
        for (int i = s0; i < s1; i += U) {
          int32_t v[U][G];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int64_t row = __shfl_sync(kAll, my_row, min(i + u, s1 - 1));
#pragma unroll
            for (int q = 0; q < G; ++q) {
              const int j = 32 * q + lane;
              v[u][q] = j < d ? __ldg(in.records + row * d + j) : 0;
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int q = 0; q < G; ++q) {
              lo[q] = min(lo[q], v[u][q]);
              hi[q] = max(hi[q], v[u][q]);
            }
          }
        }
        // the bits: each word ored over the segment's lanes
        const bool mine = lane >= s0 && lane < s1;
        for (int w = 0; w < cw; ++w) {
          const uint32_t x = __reduce_or_sync(kAll, mine ? s_lane[32 * w] : 0u);
          if (lane == 0 && x) s_cat[w] |= x;
        }
        for (int w = 0; w < aw; ++w) {
          const uint32_t t =
              __reduce_or_sync(kAll, mine ? s_lane[32 * (cw + 2 * w)] : 0u);
          const uint32_t f =
              __reduce_or_sync(kAll, mine ? s_lane[32 * (cw + 2 * w + 1)] : 0u);
          if (lane == w) {
            run_t |= t;
            run_f |= f;
          }
        }
      }
    }
    if (leaf >= 0) close_run();
    leaf = -1;
  }
}

// The fold's shared bytes: the runs' categorical words, the lane words and
// the tables.
size_t fold_smem(int d, int cw, int aw, int n_cat, int n_adv) {
  return 4 * ((size_t)kFoldWarps * (cw + 32 * ((size_t)cw + 2 * aw)) +
              n_cat + d + 3 * (size_t)n_adv);
}

// The fold's column groups for d columns (0: more than it takes).
int fold_groups(int d) {
  return d <= 32 ? 1 : d <= 64 ? 2 : d <= 128 ? 4 : d <= 32 * kMaxGroups ? 8 : 0;
}

const void* fold_kernel(int groups) {
  switch (groups) {
    case 1: return (const void*)fused_ingest_leafwise_fold<1>;
    case 2: return (const void*)fused_ingest_leafwise_fold<2>;
    case 4: return (const void*)fused_ingest_leafwise_fold<4>;
    case 8: return (const void*)fused_ingest_leafwise_fold<8>;
    default: return nullptr;
  }
}

enum Variant { kShared = 1, kGlobal = 2, kCluster = 3, kLeafwise = 4 };

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
// layout_plan, against the card, and prepare its kernels: plan = {kernel,
// warps a block, dynamic shared bytes, most blocks (shared, leafwise) or
// clusters (cluster) resident on the card}.  variant: 1 shared, 2 global
// (nothing to check), 3 cluster of `cluster` blocks, each holding
// per_block leaves, in `ranges` ranges, 4 leafwise (the route's `warps`
// and `smem`, staging `prefix` of the tree's 2 L - 1 nodes beside the
// tiles of d columns and the histogram; the fold takes at most 256
// columns and 32 advanced-cut words).  The kernel's
// shared-memory limit is raised to all the card offers, so that a plan for
// a small tree never lowers what a larger tree's launches need; a request
// past it goes to CUDA, which refuses it.  Returns a cudaError_t: a request
// the card refuses is returned, never worked around, and cleared.
extern "C" int fused_ingest_plan(int variant, int warps, int smem,
                                 int cluster, int ranges, int per_block,
                                 int n_leaves, int d, int aw, int prefix,
                                 int* plan) {
  plan[0] = variant;
  plan[1] = warps;
  plan[2] = smem;
  plan[3] = 0;
  if (variant == kGlobal) return 0;
  if ((variant != kShared && variant != kCluster && variant != kLeafwise) ||
      warps < 1 || warps > kMaxWarps || smem < 0)
    return (int)cudaErrorInvalidValue;
  if (variant == kCluster &&
      (cluster < 1 || ranges < 1 || per_block < 1 ||
       (long long)cluster * ranges * per_block < n_leaves))
    return (int)cudaErrorInvalidValue;  // a leaf no block owns
  if (variant == kLeafwise &&
      (prefix < 1 || prefix > 2LL * n_leaves - 1 || fold_groups(d) == 0 || aw > 32 ||
       smem < 16LL * prefix + 128LL * d * warps + 4LL * n_leaves))
    return (int)cudaErrorInvalidValue;
  // the shared kernel: at least the tiles, the counts, lo, hi and advanced-
  // cut words, and a changed bit a leaf (layout_plan adds the categorical
  // words and the tables)
  if (variant == kShared &&
      smem < 128LL * d * warps + 4LL * n_leaves * (1 + 2 * d + 2 * aw) +
                 4LL * ((n_leaves + 31) / 32))
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!err)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return (int)err;
  const void* kernel = variant == kShared
                           ? (const void*)fused_ingest_shared<true>
                       : variant == kCluster
                           ? (const void*)fused_ingest_cluster
                           : (const void*)fused_ingest_leafwise_route;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem > optin ? smem : optin);
  if (!err && variant == kShared)  // an accumulator's first fold
    err = cudaFuncSetAttribute((const void*)fused_ingest_shared<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem > optin ? smem : optin);
  if (variant == kShared || variant == kLeafwise) {
    int per_sm = 0;
    if (!err)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, warps * 32, (size_t)smem);
    if (variant == kLeafwise) {
      if (!err && per_sm < 1) err = cudaErrorInvalidConfiguration;
      if (!err)  // the fold's tables and words, however wide
        err = cudaFuncSetAttribute(fold_kernel(fold_groups(d)),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   optin);
    }
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
// card.  seeded: the shared kernel starts its blocks from the running
// aggregates (0 for an accumulator's first fold, which holds the
// identities; exact either way).  The leafwise design's scratch
// (kernels/fused_ingest.py::IngestAccumulator): ids (m,) int32 (unused when bids are asked for: they
// take its place), slots (m,) int32, entries (m,) int64, hist (L,) int32,
// zero between batches, offsets (L + 1,) int32; null for the other
// designs.  Returns the first launch's error, or cudaGetLastError().
extern "C" int fused_ingest_launch(
    const int32_t* records, int64_t m, int d, const int32_t* nodes,
    int depth, const int32_t* cat_off, const uint8_t* in_mask, int bits,
    const int32_t* adv, const int32_t* cat_dims, int n_cat_dims, int n_adv,
    int32_t* bids, void* counts, int32_t* lo, int32_t* hi, int32_t* cat,
    int32_t* advt, int32_t* advf, int n_leaves, int cw, int aw,
    int32_t* ids, int32_t* slots, void* entries, int32_t* hist,
    int32_t* offsets,
    int variant, int warps, int smem, int most, int cluster, int ranges,
    int per_block, int prefix, int seeded, void* stream) {
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
    if (seeded)
      fused_ingest_shared<true>
          <<<(unsigned)blocks, warps * 32, (size_t)smem, st>>>(in, g);
    else
      fused_ingest_shared<false>
          <<<(unsigned)blocks, warps * 32, (size_t)smem, st>>>(in, g);
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
  } else if (variant == kLeafwise) {
    const int groups = fold_groups(d);
    // row indices and slots are int32; the scratch must be there
    if (m > INT32_MAX || groups == 0 || aw > 32 || prefix < 1 ||
        slots == nullptr || entries == nullptr || hist == nullptr ||
        offsets == nullptr || (bids == nullptr && ids == nullptr))
      return (int)cudaErrorInvalidValue;
    int32_t* leaf_of = bids != nullptr ? bids : ids;
    long long* order = reinterpret_cast<long long*>(entries);
    int64_t blocks = (tiles + warps - 1) / warps;
    if (blocks > most) blocks = most;
    fused_ingest_leafwise_route<<<(unsigned)blocks, warps * 32, (size_t)smem,
                                  st>>>(in, prefix, n_leaves, leaf_of, slots,
                                        hist);
    cudaError_t err = cudaGetLastError();
    if (err) return (int)err;
    fused_ingest_leafwise_scan<<<1, kScanThreads, 0, st>>>(hist, offsets,
                                                           n_leaves);
    err = cudaGetLastError();
    if (err) return (int)err;
    fused_ingest_leafwise_scatter<<<grid_for(m > n_leaves ? m : n_leaves, 256),
                                    256, 0, st>>>(leaf_of, slots, m, offsets,
                                                  order, hist, g.counts,
                                                  n_leaves);
    err = cudaGetLastError();
    if (err) return (int)err;
    // one warp a chunk: grid_for's "threads" are a block's warps here
    const int64_t chunks = (m + kChunk - 1) / kChunk;
    const unsigned fold_blocks = grid_for(chunks, kFoldWarps);
    const size_t fsmem = fold_smem(d, cw, aw, n_cat_dims, n_adv);
    switch (groups) {
      case 1:
        fused_ingest_leafwise_fold<1>
            <<<fold_blocks, kFoldWarps * 32, fsmem, st>>>(in, g, order);
        break;
      case 2:
        fused_ingest_leafwise_fold<2>
            <<<fold_blocks, kFoldWarps * 32, fsmem, st>>>(in, g, order);
        break;
      case 4:
        fused_ingest_leafwise_fold<4>
            <<<fold_blocks, kFoldWarps * 32, fsmem, st>>>(in, g, order);
        break;
      default:
        fused_ingest_leafwise_fold<8>
            <<<fold_blocks, kFoldWarps * 32, fsmem, st>>>(in, g, order);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
