// eval_cuts: the (m, n_cuts) predicate matrix of a record batch.
//
// Replaces the Pallas kernel eval_cuts_pallas / _eval_cuts_kernel
// (src/repro/kernels/route_records.py:114).  The TPU version chose each
// cut's column with a one-hot matrix product and looked IN sets up through
// a categorical one-hot times the membership masks, because its matrix
// unit was the cheap way to gather.  Here a lane reads its cut's column
// from shared memory and compares int32 codes, so no float rounding can
// touch a code.  Each cut comes packed as (meta, w)
// (engine/plan.py::pack_cuts) and is tested by descend.cuh::packed_test,
// the test route_descend and fused_ingest make on a node's cut.
//
// Bound: bytes.  The output is m * n_cuts bytes (151.6 MB at WOODBLOCK's
// 400,000 x 379, 397 MB at 2**20 rows) against m * D * 4 bytes of records
// read (33.6 MB, 88 MB), so the kernel is write-bound, and the writes have
// to go out in whole, aligned sectors.  But each output byte is a test,
// and at tpch-40M's shape the tests' latency, not the writes, sets the
// pace.
//
// Two kernels, chosen by shape once a table (eval_cuts_plan):
//
//  * eval_cuts_shared: a persistent grid.  Each block copies the packed
//    table into shared memory once (8 B a cut, 3 KB at 379 cuts), and
//    in_mask's flags packed 32 to a word, flag_stride words a cut (7.6 KB
//    at 379 x 146 bits, against 55 KB of bytes): read from global memory,
//    the IN lookups (146 of 379 cuts, one a row) miss the small L1 that
//    the shared carve-out leaves and wait on L2.  Each warp walks tiles of
//    16 records: it stages a tile with cp.async (descend.cuh::stage_tile),
//    transposes it in shared memory (column c's 16 values together), and
//    stages the next tile while it evaluates this one.  Lane j tests cuts
//    j, j + 32, ... on the tile's rows: a cut's fields stay in registers,
//    its kind's code runs alone (test_rows), its column comes in four
//    16-byte loads, every read comes before the first store (the compiler
//    keeps shared loads and stores in order), a warp's 32 lanes read their
//    IN flags from 32 banks, and a warp stores 32 consecutive bytes a row.
//    The output tile (16 * n_cuts bytes, a multiple of 16 that starts
//    16-byte aligned) is assembled in shared memory and lane 0 stores it
//    with one TMA bulk copy (cp.async.bulk): whole 16-byte chunks straight
//    from shared memory, no registers spent.  The tests are latency-bound
//    (a cut's chain of shared loads and compares), so the design buys
//    warps: a warp holds 9.1 KB at 21 x 379, so 24 fit an SM, against 7
//    with 32-row tiles and two output buffers.  One output tile a warp: the
//    store of a tile overlaps the warp's next transpose and the other
//    warps' tests.  The plan takes the warps a block that put the most
//    warps on an SM.
//  * eval_cuts_global: for a table whose warp tiles do not fit a block
//    (about 2,400 cuts at 21 columns and 146 bits).  One warp a row, lane
//    j testing cuts j, j + 32, ...: a warp stores 32 consecutive bytes at
//    a time; the table and the row are read through the read-only cache.

#include "descend.cuh"

namespace {

constexpr int kMinWarps = 4;   // below this the global kernel is chosen

struct Eval {
  const int32_t* records;  // (m, d)
  int64_t m;
  int d;
  const int2* cuts;  // (n_cuts,) packed (meta, w)
  int n_cuts;
  const uint8_t* in_mask;  // (n_cuts, bits)
  int bits;
  uint8_t* out;  // (m, n_cuts)
};

// The async proxy (the bulk copy) sees this thread's shared-memory writes.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One TMA bulk store of `bytes` (a multiple of 16) from shared memory.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(src);
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(s), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// None of this thread's bulk stores still reads shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The shared bytes of the packed table.
__host__ __device__ __forceinline__ int64_t table_bytes(int n_cuts) {
  return (8LL * n_cuts + 15) & ~15LL;
}

// The words of a cut's IN flags in shared memory: its `bits` flags 32 to a
// word, the count made odd, so that the lanes of a warp, on 32 consecutive
// cuts and one value, read 32 different banks.
__host__ __device__ __forceinline__ int flag_stride(int bits) {
  return ((bits + 31) / 32) | 1;
}

__host__ __device__ __forceinline__ int64_t flag_bytes(int n_cuts,
                                                       int bits) {
  return (4LL * n_cuts * flag_stride(bits) + 15) & ~15LL;
}

// Four bytes to four bits, byte i to bit i: is it nonzero?
__device__ __forceinline__ uint32_t nonzero4(uint32_t x) {
  return (uint32_t)((x & 0xFFu) != 0) | (uint32_t)((x & 0xFF00u) != 0) << 1 |
         (uint32_t)((x & 0xFF0000u) != 0) << 2 | (uint32_t)((x >> 24) != 0)
                                                    << 3;
}

// Flags q * 32 .. q * 32 + 31 of the flattened (n_cuts, bits) in_mask as
// bits, two 16-byte loads where they are whole and aligned; flags past the
// end are clear.
__device__ __forceinline__ uint32_t flag_word(const uint8_t* in_mask,
                                              int64_t flags, int64_t q,
                                              bool vec) {
  const int64_t b0 = q * 32;
  uint32_t word = 0;
  if (vec && b0 + 32 <= flags) {
    const uint4* v4 = reinterpret_cast<const uint4*>(in_mask + b0);
    const uint4 a = __ldg(v4), b = __ldg(v4 + 1);
    const uint32_t v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) word |= nonzero4(v[k]) << (4 * k);
  } else {
    for (int i = 0; i < 32 && b0 + i < flags; ++i)
      word |= (uint32_t)(__ldg(in_mask + b0 + i) != 0) << i;
  }
  return word;
}

// Flags `bit` .. `bit` + 31 of the flattened in_mask as bits.
__device__ __forceinline__ uint32_t flag_bits(const uint8_t* in_mask,
                                              int64_t flags, int64_t bit,
                                              bool vec) {
  const uint32_t lo = flag_word(in_mask, flags, bit >> 5, vec);
  const int sh = (int)(bit & 31);
  if (sh == 0) return lo;
  return lo >> sh | flag_word(in_mask, flags, (bit >> 5) + 1, vec)
                        << (32 - sh);
}

// Rows a warp's tile holds.
constexpr int kRows = 16;
// Warps a block at most: 24 x 9.1 KB fill an SM at 21 x 379, and a lane
// holds two of its cut's columns in registers (85 registers a lane).
constexpr int kMaxWarps = 24;

// A tile's records transposed: column c's kRows values at words kColStride
// * c on, so a lane reads its cut's column with 16-byte loads and, with the
// stride an odd count of 16-byte chunks, lanes on columns c and c' hit the
// same banks only when c = c' mod 8 (or, on one column, read it once).
constexpr int kColStride = kRows + 4;

// The tests of one cut on the kRows rows of the transposed tile `tile`, into
// the output tile `out` (row r at out[r * n]); K is the cut's kind, so the
// test compiles to that kind's code alone.  For an IN cut, `w` is the
// first bit of the cut's flags in `in_mask`.  Every read (the columns, and
// an IN cut's flags) comes before any store: the compiler cannot move a
// shared-memory load past a shared-memory store, and a load after each
// row's store would leave each row waiting on its load.  Rows past `rows`
// are tested on stale values and not stored.
template <unsigned K, class Mask>
__device__ __forceinline__ void test_rows(unsigned meta, int32_t w,
                                          const int32_t* tile, uint8_t* out,
                                          int n, int rows, Mask in_mask,
                                          int bits) {
  meta = (meta & 0x3FFFFFFFu) | K << 30;  // the kind the lane's cut has
  const int4* ca = reinterpret_cast<const int4*>(
      tile + kColStride * (meta & 0xFFF));
  const int4* cb = reinterpret_cast<const int4*>(
      tile + kColStride * ((meta >> 12) & 0xFFF));
  int32_t va[kRows], vb[kRows];
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q) {
    const int4 a = ca[q];
    va[4 * q] = a.x, va[4 * q + 1] = a.y, va[4 * q + 2] = a.z,
    va[4 * q + 3] = a.w;
    const int4 b = K == KIND_ADV ? cb[q] : make_int4(0, 0, 0, 0);
    vb[4 * q] = b.x, vb[4 * q + 1] = b.y, vb[4 * q + 2] = b.z,
    vb[4 * q + 3] = b.w;
  }
  bool pass[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    pass[r] = packed_test(
        meta, w, va[r], [&] { return vb[r]; }, in_mask, bits);
  if (rows == kRows) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) out[r * n] = pass[r];
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < rows) out[r * n] = pass[r];
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    eval_cuts_shared(Eval e) {
  extern __shared__ __align__(16) unsigned char smem[];
  // [table: n_cuts x 8 B, to 16][IN flags: flag_stride words a cut, to
  // 16][per warp: a record tile as staged, the same transposed, an output
  // tile]
  const int d = e.d, n = e.n_cuts, fw = flag_stride(e.bits);
  int2* s_cuts = reinterpret_cast<int2*>(smem);
  uint32_t* s_flags = reinterpret_cast<uint32_t*>(smem + table_bytes(n));
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // multiples of 16
  const int rec_bytes = 4 * kRows * d, col_bytes = 4 * kColStride * d;
  const int out_bytes = kRows * n;
  unsigned char* mine = smem + table_bytes(n) + flag_bytes(n, e.bits) +
                        (size_t)warp * (rec_bytes + col_bytes + out_bytes);
  int32_t* staged = reinterpret_cast<int32_t*>(mine);
  int32_t* cols = reinterpret_cast<int32_t*>(mine + rec_bytes);
  uint8_t* o = mine + rec_bytes + col_bytes;

  const int64_t tiles = (e.m + kRows - 1) / kRows;
  const int64_t stride = (int64_t)gridDim.x * nwarps;
  const bool vec = (reinterpret_cast<uintptr_t>(e.records) & 15) == 0;
  int64_t t = (int64_t)blockIdx.x * nwarps + warp;
  // the first tile's copy and the table's copy go out together
  if (t < tiles) stage_tile<kRows>(staged, e.records, e.m, d, t, lane, vec);
  cp_async_commit();
  const int32_t* tab = reinterpret_cast<const int32_t*>(e.cuts);
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x)
    reinterpret_cast<int32_t*>(s_cuts)[i] = tab[i];
  const bool mvec = (reinterpret_cast<uintptr_t>(e.in_mask) & 15) == 0;
  const int64_t flags = (int64_t)n * e.bits;
  for (int i = threadIdx.x; i < n * fw; i += blockDim.x) {
    const int c = i / fw;
    s_flags[i] = flag_bits(e.in_mask, flags,
                           (int64_t)c * e.bits + 32 * (i - c * fw), mvec);
  }
  __syncthreads();  // the table and the flags have landed
  const BitMask bitmask{s_flags};

  for (; t < tiles; t += stride) {
    cp_async_wait_all();  // this tile's copies have landed (own lane's)
    __syncwarp();         // ... and every lane's
    // lane r < kRows moves row r into the columns, eight values at a time
    // (stride d: no bank conflict for an odd d); then the staging buffer
    // takes the next tile's copy, which overlaps this tile's evaluation
    if (lane < kRows) {
      for (int c0 = 0; c0 < d; c0 += 8) {
        int32_t v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c0 + j < d) v[j] = staged[lane * d + c0 + j];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c0 + j < d) cols[kColStride * (c0 + j) + lane] = v[j];
      }
    }
    __syncwarp();
    if (t + stride < tiles)
      stage_tile<kRows>(staged, e.records, e.m, d, t + stride, lane, vec);
    cp_async_commit();
    // the last tile's store has read the output tile
    if (lane == 0) bulk_wait_read();
    __syncwarp();

    // lane j tests cuts j, j + 32, ... on every row of the tile: a cut's
    // fields stay in registers, its kind's code runs alone, and a warp
    // stores 32 consecutive bytes a row
    const int rows = (int)min((int64_t)kRows, e.m - t * kRows);
    for (int c = lane; c < n; c += 32) {
      const int2 k = s_cuts[c];
      const unsigned meta = (unsigned)k.x, kind = meta >> 30;
      if (kind == KIND_RANGE)
        test_rows<KIND_RANGE>(meta, k.y, cols, o + c, n, rows, bitmask,
                              e.bits);
      else if (kind == KIND_IN)
        test_rows<KIND_IN>(meta, 32 * fw * c, cols, o + c, n, rows, bitmask,
                           e.bits);
      else
        test_rows<KIND_ADV>(meta, k.y, cols, o + c, n, rows, bitmask,
                            e.bits);
    }
    fence_async_shared();
    __syncwarp();  // the tile is assembled

    const unsigned bytes = (unsigned)rows * n;
    const unsigned whole = bytes & ~15u;
    uint8_t* dst = e.out + t * kRows * n;
    if (lane == 0 && whole) {
      bulk_store(dst, o, whole);
      bulk_commit();
    }
    // a ragged last tile's bytes past the last 16-byte chunk
    for (unsigned i = whole + lane; i < bytes; i += 32) dst[i] = o[i];
  }
  if (lane == 0) bulk_wait_all();  // shared memory outlives every store
}

__global__ void eval_cuts_global(Eval e) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       r < e.m; r += warps) {
    const int32_t* row = e.records + r * e.d;
    uint8_t* o = e.out + r * e.n_cuts;
    for (int c = lane; c < e.n_cuts; c += 32) {
      const int2 k = __ldg(e.cuts + c);
      o[c] =
          packed_cut((unsigned)k.x, k.y, row, ByteMask{e.in_mask}, e.bits);
    }
  }
}

}  // namespace

// The launch plan of a cut table, made once a shape
// (kernels/route_records.py::eval_cuts_plan): common.cuh::plan_shared over
// the packed table and its IN flags, and a warp's record tile, as staged
// and transposed, and output tile.  variant: 0 chooses by shape, 1 forces
// the shared kernel, 2 the global.
extern "C" int eval_cuts_plan(int n_cuts, int d, int bits, int variant,
                              int* plan) {
  return plan_shared((const void*)eval_cuts_shared,
                     table_bytes(n_cuts) + flag_bytes(n_cuts, bits),
                     4LL * (kRows + kColStride) * d + (long long)kRows * n_cuts,
                     kMinWarps, kMaxWarps, variant, plan);
}

// One batch, by the plan eval_cuts_plan made: no host query of the card.
// `out` is 16-byte aligned (a fresh allocation).  Returns
// cudaGetLastError().
extern "C" int eval_cuts_launch(const int32_t* records, int64_t m, int d,
                                const int32_t* cuts, int n_cuts,
                                const uint8_t* in_mask, int bits,
                                uint8_t* out, int variant, int warps,
                                int smem, int max_blocks, void* stream) {
  Eval e{records, m, d, reinterpret_cast<const int2*>(cuts), n_cuts,
         in_mask, bits, out};
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 1) {
    const int64_t tiles = (m + kRows - 1) / kRows;
    int64_t blocks = (tiles + warps - 1) / warps;
    if (blocks > max_blocks) blocks = max_blocks;
    eval_cuts_shared<<<(unsigned)blocks, warps * 32, (size_t)smem, st>>>(e);
  } else {
    const int threads = warps * 32;
    eval_cuts_global<<<grid_for(m * 32, threads), threads, 0, st>>>(e);
  }
  return (int)cudaGetLastError();
}
