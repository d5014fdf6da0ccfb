// Streaming CSR x dense products for exact SimRank on Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of graphtpu/kernels/spmm.py:
//   B1  _spmv_kernel       (Kahan-compensated row sums, f32)   -> gt_spmv_kahan_f32
//   B2  _spmv_kernel_fast  (plain f32 row sums, f32/bf16 table) -> gt_spmv_fast
//
// What they compute: out[r, :] = sum over the items t of output row r of
//   sum_j w[t*K + j] * f(table[slots[t] + j, :])
// with f(x)[col] = (col == slots[t] + j) ? 1 : table_scale * x[col] when the
// SimRank scale-and-diagonal-pin is fused in (pin != 0), else f(x) = x.
// B1 multiplies by the folded weights and Kahan-sums; B2 multiplies by the
// raw weights (or not at all for a uniform K == 1 stream), sums plainly and
// scales the row once by scales[first item of the row].  Rows with no items
// are written as zeros.  row_items[r] .. row_items[r+1] are row r's items.
//
// What bounds them on this card: device-memory bandwidth.  Each item reads
// K table rows of C values (42 KB per f32 row at V = C = 10,496) at a
// data-dependent address and does one or two flops per value read; the
// table is hundreds of MB, far past the 50 MB L2.
//
// What the design does about it: one thread block per (output row, tile of
// 1024 columns), 256 threads with 4 consecutive columns each, so a warp
// reads 512 contiguous bytes of a row with 16-byte loads (8-byte loads of
// 4 bf16).  Each thread keeps kAhead items' loads in flight before it
// accumulates them, and every output tile is written once from registers:
// no shared state between blocks, no atomics, a deterministic result.  The
// TPU kernels' sequential grid, DMA ring and zone semaphores have no place
// here.  Hub rows make a block's work grow with degree; splitting long rows
// is later work.
//
// Rounding: every multiply and add in the item body uses the _rn
// intrinsics, which nvcc never contracts into an FMA, so the Kahan update
// (y = row - comp; t = sum + y; comp = (t - sum) - y; sum = t) and the
// transform-then-weight order match the reference exactly.  bf16 tables are
// converted to f32 on read, summed in f32 and rounded once on the store.
//
// Every entry point launches on the given stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include "cols.cuh"

namespace {

using gt::kCols;
using gt::kThreads;
using gt::kTile;
using gt::load_cols;
using gt::store_cols;

constexpr int kAhead = 4;                    // items loaded before summing

// One block per (output row blockIdx.x, column tile blockIdx.y).
template <typename T, int K, bool KAHAN>
__global__ void __launch_bounds__(kThreads)
spmv_rows(const int32_t* __restrict__ slots, const float* __restrict__ wts,
          const float* __restrict__ scales, const int64_t* __restrict__ row_items,
          const T* __restrict__ table, T* __restrict__ out, int64_t c, int pin,
          float table_scale, int mul, int vec) {
  const int64_t r = blockIdx.x;
  const int64_t col0 = (int64_t)blockIdx.y * kTile + (int64_t)threadIdx.x * kCols;
  const int64_t beg = row_items[r];
  const int64_t end = row_items[r + 1];
  const bool weigh = KAHAN || mul;

  float sum[kCols], comp[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) sum[e] = comp[e] = 0.f;

  for (int64_t t0 = beg; t0 < end; t0 += kAhead) {
    const int n = (end - t0 < kAhead) ? (int)(end - t0) : kAhead;
    int s[kAhead];
    float x[kAhead][K][kCols];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (u < n) {
        s[u] = slots[t0 + u];
#pragma unroll
        for (int j = 0; j < K; ++j)
          load_cols(table + (size_t)(s[u] + j) * (size_t)c, col0, c, vec != 0,
                    x[u][j]);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (u < n) {
        float row[kCols];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float w = weigh ? wts[(t0 + u) * K + j] : 1.f;
          const int64_t diag = (int64_t)s[u] + j;  // global column of the pin
#pragma unroll
          for (int e = 0; e < kCols; ++e) {
            float v = x[u][j][e];
            if (pin) v = (col0 + e == diag) ? 1.f : __fmul_rn(table_scale, v);
            if (weigh) v = __fmul_rn(v, w);
            row[e] = (j == 0) ? v : __fadd_rn(row[e], v);
          }
        }
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          if (KAHAN) {
            // keeps long power-law rows at ~eps instead of O(d) eps
            const float y = __fsub_rn(row[e], comp[e]);
            const float t = __fadd_rn(sum[e], y);
            comp[e] = __fsub_rn(__fsub_rn(t, sum[e]), y);
            sum[e] = t;
          } else {
            sum[e] = __fadd_rn(sum[e], row[e]);
          }
        }
      }
    }
  }
  if (!KAHAN) {
    const float scale = (end > beg) ? scales[beg] : 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) sum[e] = __fmul_rn(sum[e], scale);
  }
  store_cols(out + (size_t)r * (size_t)c, col0, c, vec != 0, sum);
}

template <typename T, bool KAHAN>
int launch(const int32_t* slots, const float* wts, const float* scales,
           const int64_t* row_items, const void* table, void* out,
           int64_t n_rows_out, int64_t c, int seg_k, int pin, float table_scale,
           int mul, cudaStream_t stream) {
  const int64_t tiles = (c + kTile - 1) / kTile;
  if (n_rows_out <= 0 || c <= 0) return (int)cudaGetLastError();
  if (n_rows_out > 0x7fffffffLL || tiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t align = sizeof(T) * kCols;
  const int vec = (c % kCols == 0) && ((uintptr_t)table % align == 0) &&
                  ((uintptr_t)out % align == 0);
  const dim3 grid((unsigned)n_rows_out, (unsigned)tiles);
  const T* tb = static_cast<const T*>(table);
  T* ob = static_cast<T*>(out);
  switch (seg_k) {
    case 1:
      spmv_rows<T, 1, KAHAN><<<grid, kThreads, 0, stream>>>(
          slots, wts, scales, row_items, tb, ob, c, pin, table_scale, mul, vec);
      break;
    case 2:
      spmv_rows<T, 2, KAHAN><<<grid, kThreads, 0, stream>>>(
          slots, wts, scales, row_items, tb, ob, c, pin, table_scale, mul, vec);
      break;
    case 4:
      spmv_rows<T, 4, KAHAN><<<grid, kThreads, 0, stream>>>(
          slots, wts, scales, row_items, tb, ob, c, pin, table_scale, mul, vec);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B1: out[V+1, C] f32 = Kahan row sums of folded-weight items.
int gt_spmv_kahan_f32(const int32_t* slots, const float* wts,
                      const int64_t* row_items, const float* table, float* out,
                      int64_t n_rows_out, int64_t c, int seg_k, int pin,
                      float table_scale, cudaStream_t stream) {
  return launch<float, true>(slots, wts, nullptr, row_items, table, out,
                             n_rows_out, c, seg_k, pin, table_scale, 1, stream);
}

// B2: out[V+1, C] in the table's dtype (f32, or bf16 when bf16 != 0) =
// plain f32 row sums of raw-weight items times the row's first-item scale.
int gt_spmv_fast(const int32_t* slots, const float* raw_wts, const float* scales,
                 const int64_t* row_items, const void* table, void* out,
                 int64_t n_rows_out, int64_t c, int seg_k, int pin,
                 float table_scale, int mul, int bf16, cudaStream_t stream) {
  if (bf16)
    return launch<__nv_bfloat16, false>(slots, raw_wts, scales, row_items, table,
                                        out, n_rows_out, c, seg_k, pin,
                                        table_scale, mul, stream);
  return launch<float, false>(slots, raw_wts, scales, row_items, table, out,
                              n_rows_out, c, seg_k, pin, table_scale, mul, stream);
}

const char* gt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
