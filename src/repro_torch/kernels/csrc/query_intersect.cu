// query_intersect: block x conjunct hit matrix and the Eq. 1 scan count,
// in one launch.
//
// Replaces the Pallas kernel query_intersect_pallas / _intersect_kernel
// (src/repro/kernels/query_intersect.py).  The TPU version tested the
// categorical segments with a mask matrix product per segment and carried
// the scanned sum across its sequential leaf-tile grid.  Here the
// operands are packed once, at plan build (engine/plan.py::pack_leaf_descs,
// kernels/ops.py::pack_workload), into one int32 row per leaf and per
// conjunct: numeric lo and hi, the categorical bits 32 to a word (a
// conjunct's words already ANDed with each segment's word masks) and the
// advanced-cut bits.  A pair (leaf, conjunct) then hits iff
//
//   * max(lo) < min(hi) on every numeric column,
//   * every categorical segment shares a bit: a few word ANDs,
//   * no required advanced-cut polarity is missing: (req & ~seen) == 0.
//
// Grid: a cluster of kClusterBlocks blocks per tile of 32 conjuncts.  Each
// block stages its tile transposed in shared memory (lane i holds
// conjunct i), the segment tables, and its share of the leaves' rows
// (contiguous, so the copy coalesces); its warps then walk those leaves,
// a leaf's word being a shared-memory broadcast, and write the 32 hit
// bytes of each (leaf, tile) pair contiguously.  Each lane sums
// size[l] * hit in int64; the block reduces across warps in shared memory
// and the cluster's first block adds the blocks' sums through distributed
// shared memory and writes scanned.  No atomics, no fill: every output is
// written exactly once, and the sum is exact.
//
// Bound: operations.  A few hundred KB move (724 leaves x 170 conjuncts
// at the slice's shapes), so the launch and its latency chains dominate:
// every read in the leaf loop is a shared-memory one.

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kClusterBlocks = 8;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLeavesStaged = 128;  // leaf rows a block holds at a time

struct Query {
  const int32_t* leaf;    // (L, kl) packed leaf rows
  const long long* size;  // (L,) block sizes
  int n_leaves;
  const int32_t* conj;    // (C, kc) packed conjunct rows
  int n_conj;
  const int32_t* seg_word;  // (E,) bit word of each segment entry
  const int32_t* seg_end;   // (n_seg,) end of each segment's entries
  int n_num, n_seg, n_entries, cw, aw;
  int chunk;  // leaves a block stages at a time
  uint8_t* hits;    // (L, C)
  int64_t* scanned;  // (C,)
};

__global__ void __cluster_dims__(kClusterBlocks, 1, 1)
    __launch_bounds__(kThreads) query_intersect_kernel(Query q) {
  // [conjunct tile (kc, 32)][seg_word E][seg_end n_seg][leaf rows]
  extern __shared__ int32_t smem[];
  __shared__ long long s_sum[kWarps][32];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = q.n_num;
  const int kl = 2 * n + q.cw + 2 * q.aw;
  const int kc = 2 * n + q.n_entries + 2 * q.aw;
  const int c0 = blockIdx.y * 32;
  const int nc = min(32, q.n_conj - c0);
  int32_t* s_conj = smem;
  int32_t* s_seg_word = s_conj + 32 * kc;
  int32_t* s_seg_end = s_seg_word + q.n_entries;
  int32_t* s_leaf = s_seg_end + q.n_seg;

  for (int i = threadIdx.x; i < 32 * kc; i += blockDim.x) {
    const int cl = i / kc, k = i - cl * kc;  // row-major source: coalesced
    s_conj[k * 32 + cl] = cl < nc ? q.conj[(int64_t)(c0 + cl) * kc + k] : 0;
  }
  for (int i = threadIdx.x; i < q.n_entries; i += blockDim.x)
    s_seg_word[i] = q.seg_word[i];
  for (int i = threadIdx.x; i < q.n_seg; i += blockDim.x)
    s_seg_end[i] = q.seg_end[i];
  const int32_t* mine = s_conj + lane;  // my conjunct's k-th word: mine[32k]
  const int32_t* qcat = mine + 32 * 2 * n;
  const int32_t* qreq = mine + 32 * (2 * n + q.n_entries);

  long long sum = 0;
  // the cluster's blocks take turns over chunks of leaves
  for (int l0 = rank * q.chunk; l0 < q.n_leaves;
       l0 += kClusterBlocks * q.chunk) {
    const int nl = min(q.chunk, q.n_leaves - l0);
    __syncthreads();  // the previous chunk's rows are no longer read
    for (int i = threadIdx.x; i < nl * kl; i += blockDim.x)
      s_leaf[i] = q.leaf[(int64_t)l0 * kl + i];
    __syncthreads();
    for (int li = warp; li < nl; li += kWarps) {
      const int32_t* row = s_leaf + li * kl;
      bool ok = true;
      for (int j = 0; j < n; ++j) {
        const int32_t lo = max(row[j], mine[32 * j]);
        const int32_t hi = min(row[n + j], mine[32 * (n + j)]);
        ok &= lo < hi;
      }
      const int32_t* lcat = row + 2 * n;
      for (int k = 0, e = 0; k < q.n_seg; ++k) {
        uint32_t common_bits = 0;
        for (const int end = s_seg_end[k]; e < end; ++e)
          common_bits |= (uint32_t)lcat[s_seg_word[e]] & (uint32_t)qcat[32 * e];
        ok &= common_bits != 0;
      }
      const int32_t* ladv = row + 2 * n + q.cw;
      for (int w = 0; w < q.aw; ++w) {
        const uint32_t seen_t = (uint32_t)ladv[w];
        const uint32_t seen_f = (uint32_t)ladv[q.aw + w];
        const uint32_t req_t = (uint32_t)qreq[32 * w];
        const uint32_t req_f = (uint32_t)qreq[32 * (q.aw + w)];
        ok &= ((req_t & ~seen_t) | (req_f & ~seen_f)) == 0;
      }
      const int l = l0 + li;
      if (lane < nc) q.hits[(int64_t)l * q.n_conj + c0 + lane] = ok ? 1 : 0;
      if (ok) sum += __ldg(q.size + l);
    }
  }

  s_sum[warp][lane] = sum;
  __syncthreads();
  if (warp == 0) {
    long long s = 0;
    for (int w = 0; w < kWarps; ++w) s += s_sum[w][lane];
    s_sum[0][lane] = s;
  }
  cluster.sync();  // every block's sums are in its shared memory
  if (rank == 0 && warp == 0 && lane < nc) {
    long long s = 0;
    for (int r = 0; r < kClusterBlocks; ++r)
      s += cluster.map_shared_rank(&s_sum[0][0], r)[lane];
    q.scanned[c0 + lane] = s;
  }
  cluster.sync();  // no block leaves while the first still reads its sums
}

}  // namespace

extern "C" int query_intersect_launch(
    const int32_t* leaf, const int64_t* size, int n_leaves,
    const int32_t* conj, int n_conj, const int32_t* seg_word,
    const int32_t* seg_end, int n_num, int n_seg, int n_entries, int cw,
    int aw, uint8_t* hits, int64_t* scanned, void* stream) {
  const int chunk = std::min(
      kMaxLeavesStaged, (n_leaves + kClusterBlocks - 1) / kClusterBlocks);
  Query q{leaf, reinterpret_cast<const long long*>(size),
          n_leaves, conj, n_conj, seg_word, seg_end, n_num, n_seg,
          n_entries, cw, aw, chunk, hits, scanned};
  const int kl = 2 * n_num + cw + 2 * aw;
  const int kc = 2 * n_num + n_entries + 2 * aw;
  const size_t smem =
      sizeof(int32_t) * ((size_t)32 * kc + n_entries + n_seg +
                         (size_t)chunk * kl);
  // the default dynamic limit is 48 KB less the static s_sum
  if (smem + sizeof(long long) * kWarps * 32 > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        query_intersect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) {
      cudaGetLastError();
      return (int)err;
    }
  }
  const dim3 grid(kClusterBlocks, (n_conj + 31) / 32);
  query_intersect_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(q);
  return (int)cudaGetLastError();
}
