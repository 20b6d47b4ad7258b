// eval_cuts: the (m, n_cuts) predicate matrix of a record batch.
//
// Replaces the Pallas kernel eval_cuts_pallas / _eval_cuts_kernel
// (src/repro/kernels/route_records.py).  The TPU version chose each cut's
// column with a one-hot matrix product and looked IN sets up through a
// categorical one-hot times the membership masks, because its matrix unit
// was the cheap way to gather.  Here a thread gathers its column directly
// and compares int32 codes, so no float rounding can touch a code.
//
// Bound: bytes.  The output is m * n_cuts bytes (0.4 GB for 2**20 records
// and 379 cuts) against m * D * 4 bytes of records read, so the kernel is
// write-bound.  Design: a block of 128 x 2 threads covers 128 consecutive
// cuts of 2 records, so each warp stores 32 consecutive bytes of one row;
// the small cut table stays in L1/L2.

#include "common.cuh"

namespace {

constexpr int kCutsPerBlock = 128;
constexpr int kRowsPerBlock = 2;

__global__ void eval_cuts_kernel(const int32_t* __restrict__ records,
                                 int64_t m, int d, CutTable t,
                                 uint8_t* __restrict__ out) {
  const int c = blockIdx.y * kCutsPerBlock + threadIdx.x;
  if (c >= t.n_cuts) return;
  for (int64_t r = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.y; r < m;
       r += (int64_t)gridDim.x * kRowsPerBlock) {
    out[r * t.n_cuts + c] = eval_cut(records + r * d, c, t) ? 1 : 0;
  }
}

}  // namespace

extern "C" int eval_cuts_launch(const int32_t* records, int64_t m, int d,
                                const int32_t* kind, const int32_t* dim,
                                const int32_t* cutpoint,
                                const uint8_t* in_mask, int n_cuts, int bits,
                                const int32_t* cat_off, const int32_t* adv,
                                const int32_t* adv_id, uint8_t* out,
                                void* stream) {
  CutTable t{kind, dim, cutpoint, in_mask, cat_off, adv, adv_id, n_cuts,
             bits};
  int64_t row_blocks = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  if (row_blocks > 65536) row_blocks = 65536;  // grid-stride beyond this
  dim3 grid((unsigned)row_blocks,
            (unsigned)((n_cuts + kCutsPerBlock - 1) / kCutsPerBlock));
  dim3 block(kCutsPerBlock, kRowsPerBlock);
  eval_cuts_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(records, m, d,
                                                             t, out);
  return (int)cudaGetLastError();
}
