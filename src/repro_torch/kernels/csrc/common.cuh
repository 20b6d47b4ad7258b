// Shared device helpers for the qd-tree kernels: one candidate cut on one
// record, over int32 dictionary codes with integer compares.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Cut kinds (core/predicates.py).
#define KIND_RANGE 0
#define KIND_IN 1

// The shared candidate-cut table in struct-of-arrays form, as packed by
// core/routing.py::cut_table_arrays.  All arrays live on the device.
struct CutTable {
  const int32_t* kind;      // (n_cuts,)
  const int32_t* dim;       // (n_cuts,) column of range/IN cuts
  const int32_t* cutpoint;  // (n_cuts,) range cut: rec[dim] < cutpoint
  const uint8_t* in_mask;   // (n_cuts, bits) IN membership over the bit space
  const int32_t* cat_off;   // (D,) categorical bit offset per column
  const int32_t* adv;       // (A, 3) rows (col_a, op, col_b)
  const int32_t* adv_id;    // (n_cuts,) advanced predicate of an adv cut
  int n_cuts;
  int bits;
};

// col_a op col_b; ops 0-4 are <, <=, >, >=, ==, anything else is !=.
__device__ __forceinline__ bool adv_true(int op, int32_t va, int32_t vb) {
  switch (op) {
    case 0: return va < vb;
    case 1: return va <= vb;
    case 2: return va > vb;
    case 3: return va >= vb;
    case 4: return va == vb;
    default: return va != vb;
  }
}

// Does record `rec` (a row of D codes) satisfy cut c?
__device__ __forceinline__ bool eval_cut(const int32_t* __restrict__ rec,
                                         int c, const CutTable& t) {
  const int kind = t.kind[c];
  if (kind == KIND_RANGE) return rec[t.dim[c]] < t.cutpoint[c];
  if (kind == KIND_IN) {
    const int d = t.dim[c];
    int pos = rec[d] + t.cat_off[d];
    pos = min(max(pos, 0), t.bits - 1);  // same clip as the plain version
    return t.in_mask[(int64_t)c * t.bits + pos] != 0;
  }
  const int32_t* a = t.adv + 3 * t.adv_id[c];
  return adv_true(a[1], rec[a[0]], rec[a[2]]);
}

// Grid size for a grid-stride loop over n items: enough blocks to fill
// the card, never more than the items need.
__host__ __forceinline__ unsigned grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t cap = 132 * 32;  // 132 SMs, 32 resident blocks each at most
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return (unsigned)blocks;
}
