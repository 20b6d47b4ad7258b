// query_intersect: block x conjunct hit matrix and the Eq. 1 scan count.
//
// Replaces the Pallas kernel query_intersect_pallas / _intersect_kernel
// (src/repro/kernels/query_intersect.py).  The TPU version tested the
// categorical segments with a mask matrix product per segment and carried
// the scanned sum across its sequential leaf-tile grid.  Here:
//
//  * hits: one thread per (leaf, conjunct) tests numeric box overlap
//    (max lo < min hi on every numeric column), at least one shared bit in
//    every categorical segment, and advanced-cut polarity; neighbouring
//    threads take neighbouring conjuncts, so the byte stores coalesce.
//  * scanned: a second launch, one thread per conjunct, sums
//    size[l] * hit[l, c] over all leaves in int64 — no atomics, so the sum
//    is exact and the same on every run.  The sizes are the real block
//    sizes of the tree's last tightening.
//
// Bound: operations.  A few hundred KB move (728 leaves x 170 conjuncts
// at the slice's shapes), so the launches themselves dominate.

#include "common.cuh"

namespace {

struct Leaves {
  const int32_t* lo;    // (L, D)
  const int32_t* hi;    // (L, D)
  const uint8_t* cat;   // (L, bits)
  const uint8_t* advt;  // (L, adv_stride)
  const uint8_t* advf;  // (L, adv_stride)
  int n;
};

struct Conjuncts {
  const int32_t* lo;    // (C, D)
  const int32_t* hi;    // (C, D)
  const uint8_t* cat;   // (C, bits)
  const uint8_t* reqt;  // (C, adv_stride) requires the predicate true
  const uint8_t* reqf;  // (C, adv_stride) requires it false
  int n;
};

struct Layout {
  const int32_t* num_dims;   // (n_num,)
  const int32_t* seg_start;  // (n_seg,) categorical bit segments
  const int32_t* seg_end;
  int n_num, n_seg, d, bits, n_adv, adv_stride;
};

__device__ bool intersects(const Leaves& lv, const Conjuncts& cj,
                           const Layout& s, int l, int c) {
  const int64_t ld = (int64_t)l * s.d, cd = (int64_t)c * s.d;
  for (int k = 0; k < s.n_num; ++k) {
    const int j = s.num_dims[k];
    if (max(lv.lo[ld + j], cj.lo[cd + j]) >= min(lv.hi[ld + j], cj.hi[cd + j]))
      return false;
  }
  const uint8_t* lcat = lv.cat + (int64_t)l * s.bits;
  const uint8_t* ccat = cj.cat + (int64_t)c * s.bits;
  for (int k = 0; k < s.n_seg; ++k) {
    bool shared = false;
    for (int b = s.seg_start[k]; b < s.seg_end[k] && !shared; ++b)
      shared = lcat[b] && ccat[b];
    if (!shared) return false;
  }
  const int64_t la = (int64_t)l * s.adv_stride, ca = (int64_t)c * s.adv_stride;
  for (int a = 0; a < s.n_adv; ++a) {
    if (cj.reqt[ca + a] && !lv.advt[la + a]) return false;
    if (cj.reqf[ca + a] && !lv.advf[la + a]) return false;
  }
  return true;
}

__global__ void hits_kernel(Leaves lv, Conjuncts cj, Layout s,
                            uint8_t* __restrict__ hits) {
  const int64_t total = (int64_t)lv.n * cj.n;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int l = (int)(i / cj.n);
    const int c = (int)(i - (int64_t)l * cj.n);
    hits[i] = intersects(lv, cj, s, l, c) ? 1 : 0;
  }
}

__global__ void scanned_kernel(const uint8_t* __restrict__ hits,
                               const int64_t* __restrict__ size, int n_leaves,
                               int n_conj, int64_t* __restrict__ scanned) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_conj) return;
  int64_t acc = 0;
  for (int l = 0; l < n_leaves; ++l)
    if (hits[(int64_t)l * n_conj + c]) acc += size[l];
  scanned[c] = acc;
}

}  // namespace

extern "C" int query_intersect_launch(
    const int32_t* leaf_lo, const int32_t* leaf_hi, const uint8_t* leaf_cat,
    const uint8_t* leaf_advt, const uint8_t* leaf_advf,
    const int64_t* leaf_size, int n_leaves, const int32_t* q_lo,
    const int32_t* q_hi, const uint8_t* q_cat, const uint8_t* q_reqt,
    const uint8_t* q_reqf, int n_conj, const int32_t* num_dims, int n_num,
    const int32_t* seg_start, const int32_t* seg_end, int n_seg, int d,
    int bits, int n_adv, int adv_stride, uint8_t* hits, int64_t* scanned,
    void* stream) {
  Leaves lv{leaf_lo, leaf_hi, leaf_cat, leaf_advt, leaf_advf, n_leaves};
  Conjuncts cj{q_lo, q_hi, q_cat, q_reqt, q_reqf, n_conj};
  Layout s{num_dims, seg_start, seg_end, n_num, n_seg, d, bits, n_adv,
           adv_stride};
  const int threads = 256;
  cudaStream_t st = (cudaStream_t)stream;
  hits_kernel<<<grid_for((int64_t)n_leaves * n_conj, threads), threads, 0,
                st>>>(lv, cj, s, hits);
  int err = (int)cudaGetLastError();
  if (err) return err;
  scanned_kernel<<<(n_conj + threads - 1) / threads, threads, 0, st>>>(
      hits, leaf_size, n_leaves, n_conj, scanned);
  return (int)cudaGetLastError();
}
