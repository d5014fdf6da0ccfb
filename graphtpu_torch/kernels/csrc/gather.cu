// One level of the W-ary gather-reduction tree on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel B3 of graphtpu/kernels/spmm.py:
//   _gather_kernel (called from gather_rows_sum_pallas)  -> gt_gather_rows_sum
//
// What it computes, for each mini-row m < M and column col < C:
//   out[m, col] = sum_{j < W} w[m, j] * table[slots[m, j], col]
// with the sum taken in j order as acc = x0*w0, then acc = acc + xj*wj, each
// product rounded before the add (the _rn intrinsics, which nvcc never
// contracts into an FMA).  That is the order of gather_rows_sum_xla and of
// the Pallas kernel, so the f32 result is bit-equal to both.  Weight-0 pad
// slots (pointing at row 0) are read and added like every other slot.  The
// table is f32 or bf16 (widened on load), with a row stride `ld` so a
// column block of a wider table needs no copy; the output is f32 with its
// own row stride, so the last level can write straight into a column block
// of the caller's [V, C] result.
//
// What bounds it on this card: memory traffic.  Each mini-row reads W table
// rows of C values at data-dependent addresses (level 0 indexes the SimRank
// iterate by CSR column; deeper levels read the previous level's output
// nearly in order) and writes one row, one multiply and one add per value
// read.  At the blog shape (V = 10,496, W = 8) one product reads ~38 GB and
// writes ~4.7 GB.
//
// What the design does about it: one block of 256 threads covers a tile of
// 1,024 columns (4 consecutive columns per thread, 16-byte loads when the
// stride and offset allow) for kRows mini-rows, and each thread keeps up to
// kAhead = 8 slot rows' loads in flight before it accumulates them.  The
// grid's x dimension walks mini-rows and y walks column tiles, so the
// blocks of one tile are issued before the next tile's: a 1,024-column tile
// of a level-0 table (43 MB at V = 10,496) can stay in the 50 MB L2 while
// its mini-rows run.  The TPU kernel's DMA ring and semaphores have no
// place here.  No state crosses blocks and there are no atomics, so the
// result is deterministic.  Slot offsets (slot * ld) are 64-bit.
//
// The entry point launches on the given stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include "cols.cuh"

namespace {

using gt::kCols;
using gt::kThreads;
using gt::kTile;
using gt::load_cols;
using gt::store_cols;

constexpr int kRows = 8;    // mini-rows per block
constexpr int kAhead = 8;   // slot rows loaded before accumulating

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_rows(const int32_t* __restrict__ slots, const float* __restrict__ wts,
            const T* __restrict__ table, int64_t ld, float* __restrict__ out,
            int64_t ldo, int64_t m, int w, int64_t c, int vin, int vout) {
  const int64_t col0 = (int64_t)blockIdx.y * kTile + (int64_t)threadIdx.x * kCols;
  const int64_t r0 = (int64_t)blockIdx.x * kRows;
  for (int i = 0; i < kRows; ++i) {
    const int64_t r = r0 + i;
    if (r >= m) break;  // the same for every thread of the block
    const int32_t* sr = slots + r * w;
    const float* wr = wts + r * w;
    float acc[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[e] = 0.f;
    for (int j0 = 0; j0 < w; j0 += kAhead) {
      const int n = (w - j0 < kAhead) ? (w - j0) : kAhead;
      float x[kAhead][kCols];
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        if (u < n)
          load_cols(table + (int64_t)sr[j0 + u] * ld, col0, c, vin != 0, x[u]);
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (u < n) {
          const float wj = wr[j0 + u];
#pragma unroll
          for (int e = 0; e < kCols; ++e) {
            const float p = __fmul_rn(x[u][e], wj);
            acc[e] = (j0 + u == 0) ? p : __fadd_rn(acc[e], p);
          }
        }
      }
    }
    store_cols(out + r * ldo, col0, c, vout != 0, acc);
  }
}

template <typename T>
int launch(const int32_t* slots, const float* wts, const void* table, int64_t ld,
           float* out, int64_t ldo, int64_t m, int w, int64_t c,
           cudaStream_t stream) {
  if (m <= 0 || c <= 0) return (int)cudaGetLastError();
  if (w <= 0 || ld < c || ldo < c) return (int)cudaErrorInvalidValue;
  const int64_t tiles = (c + kTile - 1) / kTile;
  const int64_t groups = (m + kRows - 1) / kRows;
  if (groups > 0x7fffffffLL || tiles > 65535) return (int)cudaErrorInvalidValue;
  // vector access needs every row start and the ragged width on a
  // kCols-element boundary, and the base pointers aligned to the access
  const int vin = (ld % kCols == 0) && (c % kCols == 0) &&
                  ((uintptr_t)table % (sizeof(T) * kCols) == 0);
  const int vout = (ldo % kCols == 0) && (c % kCols == 0) &&
                   ((uintptr_t)out % (sizeof(float) * kCols) == 0);
  const dim3 grid((unsigned)groups, (unsigned)tiles);
  gather_rows<T><<<grid, kThreads, 0, stream>>>(
      slots, wts, static_cast<const T*>(table), ld, out, ldo, m, w, c, vin, vout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B3: out[m, :C] (f32, row stride ldo) = sum_j wts[m, j] * table[slots[m, j], :C]
// for m < M; slots and wts are [M, W] row-major; table rows have stride ld
// and are f32, or bf16 when bf16 != 0.
int gt_gather_rows_sum(const int32_t* slots, const float* wts, const void* table,
                       int64_t ld, float* out, int64_t ldo, int64_t m, int w,
                       int64_t c, int bf16, cudaStream_t stream) {
  if (bf16)
    return launch<__nv_bfloat16>(slots, wts, table, ld, out, ldo, m, w, c, stream);
  return launch<float>(slots, wts, table, ld, out, ldo, m, w, c, stream);
}

}  // extern "C"
