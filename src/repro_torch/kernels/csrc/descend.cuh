// The test of a packed cut, the descent of a packed tree, the cp.async
// staging of record tiles and the L2 eviction policies, shared by
// eval_cuts.cu, fused_ingest.cu and route_descend.cu.
#pragma once

#include "common.cuh"

// IN membership masks, (n_cuts, bits) flattened: byte w + pos of in_mask,
// or bit w + pos of the same flags packed 32 to a word.
struct ByteMask {
  const uint8_t* __restrict__ m;  // global, read through the read-only cache
  __device__ __forceinline__ bool operator()(int64_t i) const {
    return __ldg(m + i) != 0;
  }
};

struct BitMask {
  const uint32_t* b;  // shared memory
  __device__ __forceinline__ bool operator()(int64_t i) const {
    return (b[i >> 5] >> (i & 31)) & 1u;
  }
};

// A cut packed as (meta, w) (engine/plan.py::pack_cuts): meta's top two
// bits hold the cut's kind and its low 12 bits a column: range: meta =
// dim, w = cutpoint; IN: meta = 1 << 30 | cat_off[dim] << 12 | dim, w =
// the cut's first in_mask byte; advanced: meta = 2 << 30 | op << 24 |
// col_b << 12 | col_a.
//
// The cut's test on the values it reads from a record: v = rec[meta &
// 0xFFF] and, for an advanced cut alone, col_b() = rec[col_b].  Besides
// those, only an IN cut reads memory: one flag of `in_mask`.
template <class Mask, class ColB>
__device__ __forceinline__ bool packed_test(unsigned meta, int32_t w,
                                            int32_t v, ColB col_b,
                                            Mask in_mask, int bits) {
  const unsigned kind = meta >> 30;
  if (kind == KIND_RANGE) return v < w;
  if (kind == KIND_IN) {
    int pos = v + (int)((meta >> 12) & 0x3FFFF);
    pos = min(max(pos, 0), bits - 1);  // same clip as the plain version
    return in_mask((int64_t)w + pos);
  }
  return adv_true((meta >> 24) & 0x3F, v, col_b());
}

// Does the record `rec` (a row of D codes) pass the cut?  descend below
// tests the cuts on a row's path with it, eval_cuts_global every cut of a
// row; eval_cuts_shared reads a tile's values first and calls packed_test.
template <class Mask>
__device__ __forceinline__ bool packed_cut(unsigned meta, int32_t w,
                                           const int32_t* rec, Mask in_mask,
                                           int bits) {
  return packed_test(
      meta, w, rec[meta & 0xFFF],
      [&] { return rec[(meta >> 12) & 0xFFF]; }, in_mask, bits);
}

// A node of the tree with its cut, packed for the descent
// (engine/plan.py::pack_nodes): (meta, left, right, w), with (meta, w) its
// cut as above; a leaf is (0, block id, -1, 0).
//
// Walk from the root to the record's leaf; returns its block id.  kLdg
// reads the nodes through the read-only cache (a node array in global
// memory); otherwise they are plain loads, for a node array staged in
// shared memory.
template <bool kLdg>
__device__ __forceinline__ int descend(const int32_t* rec,
                                       const int4* __restrict__ nodes,
                                       int depth,
                                       const uint8_t* __restrict__ in_mask,
                                       int bits) {
  int4 n = kLdg ? __ldg(nodes) : nodes[0];
  for (int level = 0; level < depth && n.z >= 0; ++level) {
    const int next =
        packed_cut((unsigned)n.x, n.w, rec, ByteMask{in_mask}, bits)
            ? n.y
            : n.z;
    n = kLdg ? __ldg(nodes + next) : nodes[next];
  }
  return n.y;
}

// ---------------------------------------------------------------------------
// L2 eviction policies (createpolicy) and the loads and copies that take one
// ---------------------------------------------------------------------------
// Lines read under evict_last stay in L2 past lines read under evict_first:
// a kernel that streams a batch once keeps the small arrays it reads again.
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// A 16-byte load through the read-only path under the L2 policy `policy`.
__device__ __forceinline__ int4 ldg_hint(const int4* p, uint64_t policy) {
  int4 v;
  asm("ld.global.nc.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

// The descent of descend<> over a tree whose first `prefix` nodes (at least
// the root) are staged in shared memory at `s_nodes`; `nodes` holds the
// whole tree in global memory.  Shared loads while the path stays in the
// prefix, then the rest of the path from `nodes` through the read-only path
// under the L2 policy `keep`.  In BFS order (core/qdtree.py::freeze) a
// child's index is greater than its parent's, so a path that leaves the
// prefix never comes back to it, and the second loop does not ask where a
// node lies; in any other order the nodes past the exit are still read from
// `nodes`, so the block id does not depend on the order.  Level for level
// the same walk as descend<>, so the same block id.
__device__ __forceinline__ int descend_prefix(
    const int32_t* rec, const int4* s_nodes, int prefix,
    const int4* __restrict__ nodes, int depth,
    const uint8_t* __restrict__ in_mask, int bits, uint64_t keep) {
  int4 n = s_nodes[0];
  int level = 0;
  while (level < depth && n.z >= 0) {
    const int next =
        packed_cut((unsigned)n.x, n.w, rec, ByteMask{in_mask}, bits) ? n.y
                                                                     : n.z;
    ++level;
    if (next >= prefix) {  // out of the prefix: the rest through L2
      n = ldg_hint(nodes + next, keep);
      for (; level < depth && n.z >= 0; ++level) {
        const int after =
            packed_cut((unsigned)n.x, n.w, rec, ByteMask{in_mask}, bits)
                ? n.y
                : n.z;
        n = ldg_hint(nodes + after, keep);
      }
      break;
    }
    n = s_nodes[next];
  }
  return n.y;
}

// ---------------------------------------------------------------------------
// cp.async staging of a warp's tile of 32 rows
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// The same copies under the L2 policy `policy` (l2_evict_first, ...).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint64_t policy) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(
          s),
      "l"(src), "l"(policy));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          uint64_t policy) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile(
      "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;\n" ::"r"(
          s),
      "l"(src), "l"(policy));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until at most `kPending` of this thread's newest commit groups are
// still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Issue the copies of tile `tile` (rows kRows*tile .. of the (m, d) batch
// `records`) into `dst`.  A tile starts 4 * kRows * d bytes after the
// previous one, so with a 16-byte aligned batch (`vec`) and kRows a
// multiple of 4 every 16-byte chunk is aligned; a ragged tail or an
// unaligned batch goes 4 bytes at a time.  kHint copies under the L2 policy
// `policy`.
template <int kRows = 32, bool kHint = false>
__device__ __forceinline__ void stage_tile(int32_t* dst,
                                           const int32_t* records, int64_t m,
                                           int d, int64_t tile, int lane,
                                           bool vec, uint64_t policy = 0) {
  const int64_t row0 = tile * kRows;
  const int rows = (int)min((int64_t)kRows, m - row0);
  const int n = rows * d;
  const int32_t* src = records + row0 * d;
  int done = 0;
  if (vec) {
    const int nv = n >> 2;
    for (int i = lane; i < nv; i += 32) {
      if constexpr (kHint)
        cp_async16(dst + 4 * i, src + 4 * i, policy);
      else
        cp_async16(dst + 4 * i, src + 4 * i);
    }
    done = nv << 2;
  }
  for (int i = done + lane; i < n; i += 32) {
    if constexpr (kHint)
      cp_async4(dst + i, src + i, policy);
    else
      cp_async4(dst + i, src + i);
  }
}
