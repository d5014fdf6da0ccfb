// Stripped variants of the streaming SpMV kernel B2, for measuring its item
// rate on Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of tools/exp_spmv_rate.py:
//   X1  _dma_only_kernel     (row reads, no accumulation)    -> gt_rate_gather_only
//   X2  _vpu_only_kernel     (accumulation, no row reads)    -> gt_rate_accumulate_only
//   X3  _fast_unroll_kernel  (B2 unrolled, raw sums)         -> gt_rate_unroll8
//
// Each variant runs the design B2 runs on the same stream.  On a stream with
// a sliced layout (a uniform seg-1 stream whose 16-byte slab fits, as B2's;
// e.g. blog) that is B2's column panel (spmv_panel in spmv.cu): a block per
// 16-byte column slab, the V table rows' slabs in shared memory, the stream's
// 16-bit slots fed through the TMA ring and walked in SELL-32-sigma order.
//   X1 is B2's panel with the arithmetic taken out: B2's reads and its 8
//      items in flight, a max in place of the add, no weight or scale
//      (sell_max_f32);
//   X2 is B2's panel with the panel taken out: the same launch, shared
//      memory, ring and walk, but each item adds row_w[row] * buf[t mod 16],
//      formed once per row in registers, and reads neither the panel nor
//      its slot (sell_buffer_sums_f32);
//   X3 is B2's panel with 16 items in flight and no row scale
//      (sell_raw_sums_f32).
// Hub rows are combined lane-strided there, so X2's and X3's hub-row sums
// differ from the row tiles' in the last bits (X1's max is exact).
// Elsewhere (e.g. R-MAT) they run row tiles: one block of 256 threads per
// (output row r, tile of 1,024 columns), 4 columns per thread, r's items
// taken from row_items[r] .. row_items[r+1].  Rows with no items are
// written as zeros.
//
// The TPU versions leave X1's and X2's outputs undefined, and on this card a
// load whose value is never used is removed by the compiler, so each
// variant here has an output that keeps all of its work live:
//   X1  out[r] = max over r's items t of table[slots[t]]          (exact)
//   X2  out[r] = sum over r's items t of wts[t] * buf[t mod 16]
//       buf is a resident [16, C] buffer held in registers; no table reads
//       (on the panel wts[t] is the row's folded weight row_w[r], the same
//       value in a uniform stream)
//   X3  out[r] = sum over r's items t of table[slots[t]]
//       raw, unweighted and unscaled, with 8 items' loads in flight per
//       thread in row tiles, where B2 keeps 4, and 16 a lane on the panel
// Sums are taken in item order with the _rn intrinsics.
//
// What they measure: set beside B2 on the same stream, X1 is B2's reads (the
// panel's copy-in and its shared-memory reads, or the row tiles' L2 reads)
// with a max per value, X2 is B2's per-item control and arithmetic with no
// reads, and X3 says whether more reads in flight move B2 (bank conflicts
// or L2 request rate bound it if not, latency if so).
//
// Every entry point launches on the given stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include "cols.cuh"
#include "panel.cuh"

namespace {

using gt::kCols;
using gt::kThreads;
using gt::kTile;
using gt::load_cols;
using gt::store_cols;

constexpr int kBuf = 16;   // rows of X2's resident buffer

template <int AHEAD, bool MAX>
__global__ void __launch_bounds__(kThreads)
rate_reads(const int32_t* __restrict__ slots, const int64_t* __restrict__ row_items,
           const float* __restrict__ table, float* __restrict__ out, int64_t c,
           int vec) {
  const int64_t r = blockIdx.x;
  const int64_t col0 = (int64_t)blockIdx.y * kTile + (int64_t)threadIdx.x * kCols;
  const int64_t beg = row_items[r];
  const int64_t end = row_items[r + 1];
  float acc[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) acc[e] = MAX ? -__int_as_float(0x7f800000) : 0.f;  // -inf
  for (int64_t t0 = beg; t0 < end; t0 += AHEAD) {
    const int n = (end - t0 < AHEAD) ? (int)(end - t0) : AHEAD;
    float x[AHEAD][kCols];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u)
      if (u < n)
        load_cols(table + (int64_t)slots[t0 + u] * c, col0, c, vec != 0, x[u]);
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (u < n) {
#pragma unroll
        for (int e = 0; e < kCols; ++e)
          acc[e] = MAX ? fmaxf(acc[e], x[u][e]) : __fadd_rn(acc[e], x[u][e]);
      }
    }
  }
  if (end == beg) {
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[e] = 0.f;
  }
  store_cols(out + r * c, col0, c, vec != 0, acc);
}

__global__ void __launch_bounds__(kThreads)
rate_accumulate(const float* __restrict__ wts, const int64_t* __restrict__ row_items,
                const float* __restrict__ buf, float* __restrict__ out, int64_t c,
                int vec) {
  const int64_t r = blockIdx.x;
  const int64_t col0 = (int64_t)blockIdx.y * kTile + (int64_t)threadIdx.x * kCols;
  const int64_t beg = row_items[r];
  const int64_t end = row_items[r + 1];
  float b[kBuf][kCols];
#pragma unroll
  for (int u = 0; u < kBuf; ++u) load_cols(buf + u * c, col0, c, vec != 0, b[u]);
  float acc[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) acc[e] = 0.f;
  // walk kBuf-aligned groups so that t mod kBuf is the unrolled index u and
  // the buffer stays in registers
  for (int64_t t0 = beg - beg % kBuf; t0 < end; t0 += kBuf) {
#pragma unroll
    for (int u = 0; u < kBuf; ++u) {
      const int64_t t = t0 + u;
      if (t >= beg && t < end) {
        const float w = wts[t];
#pragma unroll
        for (int e = 0; e < kCols; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(w, b[u][e]));
      }
    }
  }
  store_cols(out + r * c, col0, c, vec != 0, acc);
}

int check_shape(int64_t n_rows_out, int64_t c, int64_t* tiles) {
  *tiles = (c + kTile - 1) / kTile;
  if (n_rows_out > 0x7fffffffLL || *tiles > 65535) return (int)cudaErrorInvalidValue;
  return 0;
}

int vec_ok(const void* a, const void* b, int64_t c) {
  const uintptr_t align = sizeof(float) * kCols;
  return (c % kCols == 0) && ((uintptr_t)a % align == 0) && ((uintptr_t)b % align == 0);
}

template <int AHEAD, bool MAX>
int launch_reads(const int32_t* slots, const int64_t* row_items, const float* table,
                 float* out, int64_t n_rows_out, int64_t c, cudaStream_t stream) {
  if (n_rows_out <= 0 || c <= 0) return (int)cudaGetLastError();
  int64_t tiles;
  if (int rc = check_shape(n_rows_out, c, &tiles)) return rc;
  const dim3 grid((unsigned)n_rows_out, (unsigned)tiles);
  rate_reads<AHEAD, MAX><<<grid, kThreads, 0, stream>>>(
      slots, row_items, table, out, c, vec_ok(table, out, c));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// X1: out[r, :] = max over r's items of table[slots[t], :]; on the column
// panel over `sell` (n_rows_out = V + 1, table [>=V, C] contiguous) when it
// is not null, else row tiles with 4 loads in flight.
int gt_rate_gather_only(const int32_t* slots, const int64_t* row_items, const GtSell* sell,
                        const float* table, float* out, int64_t n_rows_out, int64_t c,
                        cudaStream_t stream) {
  if (sell != nullptr) return sell_max_f32(*sell, table, out, n_rows_out - 1, c, stream);
  return launch_reads<4, true>(slots, row_items, table, out, n_rows_out, c, stream);
}

// X2: out[r, :] = sum over r's items of wts[t] * buf[t mod 16, :]; buf [16, C]
// f32.  On the column panel over `sell` (its row_w the rows' folded weights,
// its lane_base set) when it is not null, else row tiles.
int gt_rate_accumulate_only(const float* wts, const int64_t* row_items, const GtSell* sell,
                            const float* buf, float* out, int64_t n_rows_out, int64_t c,
                            cudaStream_t stream) {
  if (sell != nullptr) return sell_buffer_sums_f32(*sell, buf, out, n_rows_out - 1, c, stream);
  if (n_rows_out <= 0 || c <= 0) return (int)cudaGetLastError();
  int64_t tiles;
  if (int rc = check_shape(n_rows_out, c, &tiles)) return rc;
  const dim3 grid((unsigned)n_rows_out, (unsigned)tiles);
  rate_accumulate<<<grid, kThreads, 0, stream>>>(wts, row_items, buf, out, c,
                                                 vec_ok(buf, out, c));
  return (int)cudaGetLastError();
}

// X3: out[r, :] = sum over r's items of table[slots[t], :]; on the column
// panel over `sell` (n_rows_out = V + 1, table [>=V, C] contiguous) when it
// is not null, else row tiles with 8 loads in flight.
int gt_rate_unroll8(const int32_t* slots, const int64_t* row_items, const GtSell* sell,
                    const float* table, float* out, int64_t n_rows_out, int64_t c,
                    cudaStream_t stream) {
  if (sell != nullptr) return sell_raw_sums_f32(*sell, table, out, n_rows_out - 1, c, stream);
  return launch_reads<8, false>(slots, row_items, table, out, n_rows_out, c, stream);
}

}  // extern "C"
