// Streaming CSR x dense products for exact SimRank on Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of graphtpu/kernels/spmm.py:
//   B1  _spmv_kernel       (spmm.py:391, Kahan-compensated row sums, f32)
//       -> gt_spmv_kahan_f32
//   B2  _spmv_kernel_fast  (spmm.py:542, plain f32 row sums, f32/bf16 table)
//       -> gt_spmv_fast
//
// What they compute: out[r, :] = sum over the items t of output row r of
//   sum_j w[t*K + j] * f(table[slots[t] + j, :])
// with f(x)[col] = (col == slots[t] + j) ? 1 : table_scale * x[col] when the
// SimRank scale-and-diagonal-pin is fused in (pin != 0), else f(x) = x.
// B1 multiplies by the folded weights and Kahan-sums; B2 multiplies by the
// raw weights (or not at all for a uniform K == 1 stream), sums plainly and
// scales the row once by its first item's scale.  Rows with no items are
// written as zeros; out has V+1 rows (row V takes the stream's pad items).
//
// Four designs, chosen on the host by the caller's stream
// (kernels/spmm.py:design_rule):
//
// The column panel (spmv_panel), for a uniform K == 1 stream whose V rows
// of 16 bytes fit one block's shared memory (V <= 11,448, kernels/spmm.py:
// sell_fits), passed with its sliced layout.  Block b owns a slab of 16
// bytes of every table row (4 f32 or 8 bf16 columns) and copies
// table[0:V, slab] into shared memory once, so every row an item reads is a
// shared-memory read, not an L2 request.  It walks the whole stream in the
// sliced order of kernels/spmm.py:build_sell_layout: lane l of a consumer
// warp owns one output row and walks that row's items in stream order, so
// B1's Kahan order, and its bits, are those of the row tiles.  Rows longer
// than the hub threshold are cut into pieces whose items a whole warp takes
// lane-strided; the lanes' sums are combined in a fixed lane order (TwoSum
// for B1), and a row's pieces in a fixed order at the end.  The stream is
// 16-bit slots only (a uniform stream's weight is one value per row), fed
// in 16 KB chunks by bulk copies (TMA) through a ring of three shared-
// memory stages, under full and consumed barriers (csrc/panel.cuh).  Each
// output row's slab segment is written once, with no atomics: the same bits
// on every run.  The rate probe (csrc/spmv_rate.cu) runs this kernel too:
// X1 takes a max in place of the add (sell_max_f32), X2 keeps the launch,
// ring and walk but reads no panel and no slot, adding each item's row
// weight times a buffer row instead (sell_buffer_sums_f32; it sizes no
// panel, so it runs over any sliced layout), and X3 sums unscaled with 16
// items in flight (sell_raw_sums_f32).
//
// The packed-lane panel (spmv_packed, entry gt_spmv_packed), for uniform
// K == 1 streams past the panel (V <= 16,384) whose rows of more than 128
// items hold at least a quarter of the items and whose 11,448 most-read
// table rows take at least 99.5% of the reads: R-MAT 14, 58% and 99.7%.  The
// column panel's sliced layout gives R-MAT's lanes 16 positions a chunk for
// a median row of 4 items (fill 0.44, 145 chunks) and a warp per hub piece;
// here (kernels/spmm.py:build_packed_layout) every row of at most 512
// items is one segment, its items in stream order (so B1's bits are the
// row tiles'), and a longer row is cut into pieces of 512 items, its hot
// items first, then its cold ones.  Segments sorted by length are dealt 32
// to a unit, and each warp walks its units back to back, the units of
// segments with a cold item apart from the rest, long and short units
// alternating: R-MAT fills 66 chunks at 0.972.  A unit is as long as its
// longest segment, so every lane of the warp flushes at the same position
// (a uniform branch, once a unit): its row's slab (B2 scaled by the row's
// scale) or its piece's partial sums, which the block joins at the end in
// piece order (TwoSum for B1), as the column panel joins its hub pieces.
// A group of UNR positions in which no unit ends runs the column panel's
// straight-line sums.  The panel holds the slab of the 11,448 most-read
// rows, listed in ascending order, so each stream position is a 16-bit
// entry: the row's panel index, or 0x4000 plus its table row for a cold
// row, which the warp reads from the table (its group waits: 207 of 2,112
// groups at R-MAT); the producer warp's lanes prefetch each chunk's cold
// rows into L2 as the chunk's bulk copy is issued.  The pin by entry: the
// panel indices of the hot rows whose diagonal lies in the slab are
// consecutive, so an item's entry is compared with the slab's entries only
// where it lies in their range, one subtract and compare an item.
//
// L2 column tiles (spmv_tiles, entry gt_spmv_tiles), for f32 products over
// the other seg-1 streams whose hub rows hold under a quarter of the items
// (the arxiv shape, V = 60,000, weighted streams): a warp per output row
// (or per piece of SELL_HUB items of a hub row) and 256-column tile, the
// blocks running tile by tile, so the rows a tile reads come from L2 while
// the row tiles below read a 1,024-column slice of every row (V x 4 KB:
// 159 MB at the arxiv shape) and go to HBM.  A row's items are summed in
// stream order with the row tiles' operations, so rows of at most
// SELL_HUB items get their bits; hub rows' pieces are joined in a fixed
// order (TwoSum for B1) by a second kernel.  What bounds it: a warp's
// chain of dependent loads (row offsets, slots, table rows) at 24 resident
// warps an SM (its launch bound: 3 blocks of 8), not HBM: 6.7-7.4 ms at
// the arxiv shape against 3.6 ms for its bytes (PERF.md).
//
// Row tiles (spmv_rows), for every other stream (seg-2/4, bf16 tables
// outside the panels, streams whose reads spread past the panel's rows):
// one block per (output row, 1,024-column tile, 2,048 for bf16 seg-1
// tables, whose threads read 8 columns in one 16-byte load), reading table
// rows from L2.  Where the panels or the L2 column tiles run, they were
// measured faster; a panel over int32 slots and per-item weights (seg-2,
// weighted), or with a slab narrower than 16 bytes or several panels, the
// sliced layout over hot rows (R-MAT), the L2 column tiles over seg-2,
// bf16 or R-MAT streams, 16-byte bf16 row tiles over seg-2 streams, and,
// for the packed layout, a per-lane flush at each row's end, 8-position
// chunks beside a 12,984-row panel, and cold slabs staged in the ring by
// the producer, were measured slower on an H100 (PERF.md) and are not
// built.
//
// What bounds the panel on this card: its walk and its shared-memory reads,
// not device memory.  At V = C = 10,496 with 658,180 items the function
// needs 0.89 GB of table, output and stream traffic (0.27 ms at 3.35 TB/s),
// but the blocks read 658,180 x 16 bytes of panel rows per slab: 27.6 GB of
// shared-memory reads in f32, 0.93 ms at the 128 bytes per clock that each
// of the 132 SMs serves without conflicts (random rows put about 2.5 lanes
// of each 8-lane phase of a 16-byte load on one bank group).  The rate
// probe splits B2's unpinned panel on an H100 80GB HBM3 (PERF.md): X2, the
// same launch, ring, walk and stores with each item's term in registers,
// takes 1.35 ms of B2's 3.07, so the panel's copy-in and reads take ~1.7;
// X1, a max in place of each add, takes as long as B2.  B1's pinned update
// issues ~30 instructions per (item, lane) besides.  bf16 slabs carry 8
// columns per 16-byte read: half the reads of f32.  The pin is a template
// argument, so unpinned products issue none of its work.
//
// What bounds the packed-lane panel at R-MAT (C = V): not device memory
// either (0.64-0.77 ms for its bytes and operations against 4.6-6.2 ms).
// Cutting one part at a time (bench/packed_split.py, PERF.md) gives, of
// B2's unpinned f32 4.6 ms, 1.36 ms to the panel and table reads, 0.39 to
// the flushes' scattered 16-byte stores, 0.25 to the cold reads' stalls
// and 0.21 to the copy-in; the walk without any read takes 3.2 ms, 1.6
// times blog's a chunk and slab.
//
// Rounding: every multiply and add in the item body uses the _rn
// intrinsics, which nvcc never contracts into an FMA, so the Kahan update
// (y = row - comp; t = sum + y; comp = (t - sum) - y; sum = t) and the
// transform-then-weight order match the reference exactly.  bf16 tables are
// converted to f32 on read, summed in f32 and rounded once on the store.
//
// Every entry point launches on the given stream, allocates nothing (the
// caller passes the layout and its scratch), does not synchronise, and
// returns cudaGetLastError() or the launch's own error.

#include <type_traits>

#include "cols.cuh"
#include "panel.cuh"

// The L2 column tiles' plan (kernels/spmm.py:TilePlan): rows of more than
// `hub` items are cut into pieces of `hub` items, in row order; the launch's
// scratch holds each piece's partial sums.
struct GtTiles {
  const int32_t* hub_rows;   // [n_hub], ascending
  const int32_t* hub_piece;  // [n_hub + 1]: hub row h sums pieces hub_piece[h] ..
  const int32_t* piece_row;  // [n_pieces]
  const int64_t* piece_beg;  // [n_pieces]: the piece's first stream item
  float* acc;                // n_pieces > 0: [(KAHAN ? 2 : 1) * n_pieces * C]
  int64_t n_hub;
  int64_t n_pieces;
  int64_t hub;               // items per piece (SELL_HUB)
};

// The packed-lane panel's layout (kernels/spmm.py:PackedLayout) and the
// launch's scratch.
struct GtPacked {
  const uint16_t* codes;     // [n_chunks * kChunk]: entry of each position (pads: 0)
  const int32_t* hot_rows;   // [n_hot], ascending: the panel's table rows
  const uint16_t* row_code;  // [V]: each table row's entry
  const int32_t* cold_beg;   // [n_chunks + 1]: chunk ch's cold rows are cold_rows[beg ..]
  const int32_t* cold_rows;  // the distinct cold rows each chunk reads
  const int32_t* lane_row;   // [units * 32]: output row, -2 - piece, or -1
  const int32_t* lane_cnt;   // [units * 32]
  const float* lane_w;       // [units * 32]: the row's folded weight (B1) or scale (B2)
  const int32_t* warp_units; // [kPanelWarps + 1]
  const int32_t* hub_rows;   // [n_hub]
  const int32_t* hub_piece;  // [n_hub + 1]
  const float* row_w;        // [V + 1]: each row's scale (B2's join)
  const int32_t* empty_rows; // [n_empty]
  float* hub_acc;            // n_pieces > 0: [(KAHAN ? 2 : 1) * n_pieces * C]
  int64_t n_chunks;
  int64_t n_hot;
  int64_t n_hub;
  int64_t n_pieces;
  int64_t n_empty;
};

namespace {

using gt::kCols;
using gt::kThreads;
using gt::load_cols;
using gt::store_cols;

constexpr int kAhead = 4;                    // items loaded before summing (row tiles)

// Row tiles: one block per (output row blockIdx.x, tile of kThreads * NC
// columns blockIdx.y), reading table rows from L2; a thread owns NC columns
// (4, or 8 bf16 columns in one 16-byte read).
template <typename T, int K, bool KAHAN, int NC>
__global__ void __launch_bounds__(kThreads)
spmv_rows(const int32_t* __restrict__ slots, const float* __restrict__ wts,
          const float* __restrict__ scales, const int64_t* __restrict__ row_items,
          const T* __restrict__ table, T* __restrict__ out, int64_t c, int pin,
          float table_scale, int mul, int vec) {
  constexpr int kCols = NC;  // the columns of this thread, in every loop below
  const int64_t r = blockIdx.x;
  const int64_t col0 = (int64_t)blockIdx.y * kThreads * NC + (int64_t)threadIdx.x * NC;
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

template <typename T, int K, bool KAHAN, int NC>
int launch_rows_nc(const int32_t* slots, const float* wts, const float* scales,
                   const int64_t* row_items, const void* table, void* out,
                   int64_t n_rows_out, int64_t c, int pin, float table_scale, int mul,
                   cudaStream_t stream) {
  const int64_t tiles = (c + kThreads * NC - 1) / (kThreads * NC);
  if (n_rows_out > 0x7fffffffLL || tiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t align = sizeof(T) * NC;
  const int vec = (c % NC == 0) && ((uintptr_t)table % align == 0) &&
                  ((uintptr_t)out % align == 0);
  const dim3 grid((unsigned)n_rows_out, (unsigned)tiles);
  spmv_rows<T, K, KAHAN, NC><<<grid, kThreads, 0, stream>>>(
      slots, wts, scales, row_items, static_cast<const T*>(table), static_cast<T*>(out), c,
      pin, table_scale, mul, vec);
  return (int)cudaGetLastError();
}

// bf16 tables of seg-1 streams read 8 columns a thread (one 16-byte load;
// the same sums, so the same bits): faster at the arxiv shape, slower over
// seg-2 streams (PERF.md), which read 4 as every other stream does
template <typename T, bool KAHAN>
int launch_rows(const int32_t* slots, const float* wts, const float* scales,
                const int64_t* row_items, const void* table, void* out,
                int64_t n_rows_out, int64_t c, int seg_k, int pin, float table_scale,
                int mul, cudaStream_t stream) {
  constexpr int NC = sizeof(T) == 2 ? gt::kCols16 : kCols;
  switch (seg_k) {
    case 1:
      return launch_rows_nc<T, 1, KAHAN, NC>(slots, wts, scales, row_items, table, out,
                                             n_rows_out, c, pin, table_scale, mul, stream);
    case 2:
      return launch_rows_nc<T, 2, KAHAN, kCols>(slots, wts, scales, row_items, table, out,
                                                n_rows_out, c, pin, table_scale, mul, stream);
    case 4:
      return launch_rows_nc<T, 4, KAHAN, kCols>(slots, wts, scales, row_items, table, out,
                                                n_rows_out, c, pin, table_scale, mul, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

using gt::kBarrierBytes;
using gt::kSlab;
using gt::kSmemMax;
using gt::from_f32;
using gt::mbar_arrive;
using gt::mbar_wait;
using gt::unpack;

constexpr int kWarps = gt::kPanelWarps;        // consumer warps (SELL_WARPS)
constexpr int kJb = 16;                        // positions per lane in a chunk (SELL_JB)
constexpr int kChunk = kWarps * 32 * kJb;      // positions per chunk (SELL_CHUNK)
constexpr uint32_t kChunkBytes = kChunk * 2;   // 16 KB of 16-bit slots
constexpr int kStages = 3;                     // ring stages (SELL_STAGES)
constexpr int kBlock = gt::kPanelBlock;        // + one producer warp

// out[row, col0 : col0 + SC] = x (columns >= c masked)
template <typename T>
__device__ __forceinline__ void store_slab(T* __restrict__ dst, int64_t col0, int64_t c,
                                           bool vec, const float (&x)[kSlab / sizeof(T)]) {
  constexpr int SC = kSlab / sizeof(T);
  T v[SC];
#pragma unroll
  for (int e = 0; e < SC; ++e) from_f32(x[e], v[e]);
  if (vec) {
    uint4 q;
    memcpy(&q, v, kSlab);
    *reinterpret_cast<uint4*>(dst) = q;
  } else {
#pragma unroll
    for (int e = 0; e < SC; ++e)
      if (col0 + e < c) dst[e] = v[e];
  }
}

// (s, cp) += (s2, c2) for Kahan pairs whose value is sum - comp: TwoSum
// gives the rounding error of s + s2 exactly, and it joins the compensation
__device__ __forceinline__ void kahan_merge(float& s, float& cp, float s2, float c2) {
  const float t = __fadd_rn(s, s2);
  const float bb = __fsub_rn(t, s);
  const float err = __fadd_rn(__fsub_rn(s, __fsub_rn(t, bb)), __fsub_rn(s2, bb));
  cp = __fsub_rn(__fadd_rn(cp, c2), err);
  s = t;
}

// What a lane does with each of its items: add the item's panel row (B1,
// B2, X3), take the max with it (X1), or add its row's weight times row
// t mod 16 of a [16, C] f32 buffer, t the item's stream index, reading
// neither the panel nor the slot (X2).  X2's products are the same in
// every chunk of a row, so a lane forms them once per row: an item then
// costs B2's unpinned arithmetic alone, a masked add per value.
enum class Op { kSum, kMax, kBuf };
constexpr int kBufRows = 16;                   // rows of X2's buffer (N_BUF)

// Hub rows of one slab: each row's piece partials in piece order (TwoSum
// for B1, a max for X1), then B2's row scale (SCALE); one consumer thread a
// row.
template <typename T, bool KAHAN, bool SCALE, Op OP, class Layout>
__device__ void hub_rows_out(const Layout& L, T* __restrict__ out, int64_t col0, int64_t c,
                             bool vec_here) {
  constexpr int SC = kSlab / sizeof(T);
  const size_t half = (size_t)L.n_pieces * (size_t)c;
  for (int64_t h = threadIdx.x; h < L.n_hub; h += kWarps * 32) {
    const int hrow = __ldg(L.hub_rows + h);
    const int q0 = __ldg(L.hub_piece + h), q1 = __ldg(L.hub_piece + h + 1);
    float sh[SC], ch_[SC];
    for (int q = q0; q < q1; ++q) {
      const float* part = L.hub_acc + (size_t)q * (size_t)c + col0;
#pragma unroll
      for (int e = 0; e < SC; ++e) {
        const float s2 = (col0 + e < c) ? part[e] : 0.f;
        const float c2 = (KAHAN && col0 + e < c) ? part[half + e] : 0.f;
        if (q == q0) {
          sh[e] = s2;
          ch_[e] = c2;
        } else if (KAHAN) {
          kahan_merge(sh[e], ch_[e], s2, c2);
        } else {
          sh[e] = OP == Op::kMax ? fmaxf(sh[e], s2) : __fadd_rn(sh[e], s2);
        }
      }
    }
    if (SCALE) {
      const float scale = __ldg(L.row_w + hrow);
#pragma unroll
      for (int e = 0; e < SC; ++e) sh[e] = __fmul_rn(sh[e], scale);
    }
    if (col0 < c) store_slab<T>(out + (size_t)hrow * (size_t)c + col0, col0, c, vec_here, sh);
  }
}

// The column panel over a uniform K == 1 stream: B1 weighs each item by its
// row's folded weight, B2 sums unweighted and scales the row at the end
// (SCALE), X3 sums unweighted and unscaled, X1 takes the max (OP).  UNR
// items' panel rows are read before they are summed.  X2 (Op::kBuf) reads
// `table` as its [16, C] buffer and keeps each lane's 16 weighted buffer
// rows in registers, so that its items touch no memory; UNR is then how
// many of them run between two checks that a lane of the warp still has
// one.
template <typename T, bool KAHAN, bool PIN, int UNR, bool SCALE, Op OP = Op::kSum>
__global__ void __launch_bounds__(kBlock, 1)
spmv_panel(const GtSell L, const T* __restrict__ table, T* __restrict__ out, int64_t v,
           int64_t c, float table_scale, int vec) {
  constexpr int SC = kSlab / sizeof(T);        // columns of the slab
  static_assert(kJb % UNR == 0, "a chunk's j-block splits into whole groups");
  static_assert(!(KAHAN && SCALE), "B1 folds the row scale into its weights");
  static_assert(OP == Op::kSum || !(KAHAN || PIN || SCALE),
                "X1 and X2 take no Kahan sums, pin or row scale");
  static_assert(OP != Op::kBuf || sizeof(T) == 4, "X2's buffer is f32");

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // stage holds a chunk
  uint64_t* consumed = full + kStages;                   // the consumer warps are done
  unsigned char* ring = smem + kBarrierBytes;
  unsigned char* panel = smem + kBarrierBytes + kStages * kChunkBytes;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t col0 = (int64_t)blockIdx.x * SC;
  const bool vec_here = vec && (col0 + SC <= c);

  gt::init_ring(full, consumed, kStages);
  if (warp == kWarps) {
    // producer: one thread feeds the ring
    if (lane == 0)
      gt::produce<kStages>(ring, reinterpret_cast<const unsigned char*>(L.slots), L.n_chunks,
                           kChunkBytes, kChunkBytes, full, consumed);
    return;
  }
  if constexpr (OP != Op::kBuf) {
    // the block's slab of every table row into the panel
    for (int r = threadIdx.x; r < v; r += kWarps * 32) {
      const T* src = table + (size_t)r * (size_t)c + col0;
      unsigned char* dst = panel + r * kSlab;
      if (vec_here) {
        gt::cp_async16(dst, src);
      } else if (col0 < c) {
        T tmp[SC];
#pragma unroll
        for (int e = 0; e < SC; ++e) {
          if (col0 + e < c) tmp[e] = src[e];
          else from_f32(0.f, tmp[e]);
        }
        memcpy(dst, tmp, kSlab);
      }
    }
    gt::cp_async_wait_all();
  }
  gt::consumers_sync();

  // chunks run super-slice by super-slice, j-block by j-block; this warp's
  // unit of the next super-slice is read one super-slice ahead
  float sum[SC], comp[SC];
  // X2: lane l holds buffer row l mod 16 (read once), and p[jj] the term of
  // item jj in every chunk of the lane's row
  float mine[SC], p[OP == Op::kBuf ? kJb : 1][SC];
  if constexpr (OP == Op::kBuf)
    gt::load_cols(table + (size_t)(lane % kBufRows) * (size_t)c, col0, c, vec_here, mine);
  int ss = 0, jb = 0, nch = __ldg(L.ss_chunks);
  int row = __ldg(L.lane_row + warp * 32 + lane);
  int cnt = __ldg(L.lane_cnt + warp * 32 + lane);
  int hub = __ldg(L.unit_hub + warp);
  float rw = row >= 0 ? __ldg(L.row_w + row) : 0.f;
  int nx = L.n_ss > 1 ? 1 : 0;
  int nx_row = __ldg(L.lane_row + (nx * kWarps + warp) * 32 + lane);
  int nx_cnt = __ldg(L.lane_cnt + (nx * kWarps + warp) * 32 + lane);
  int nx_hub = __ldg(L.unit_hub + nx * kWarps + warp);
  int nx_nch = __ldg(L.ss_chunks + nx);
  int s = 0;
  uint32_t round = 0;
  for (int64_t ch = 0; ch < L.n_chunks; ++ch) {
    if (jb == 0) {
#pragma unroll
      for (int e = 0; e < SC; ++e) {
        sum[e] = OP == Op::kMax ? -__int_as_float(0x7f800000) : 0.f;  // -inf for a max
        comp[e] = 0.f;
      }
      if constexpr (OP == Op::kBuf) {
        // item jj of this lane's j-block b is stream item base + step * (b *
        // kJb + jj), and kJb = kBufRows, so its buffer row depends on jj
        // alone; it comes from the lane that holds it (a load per lane
        // would touch 16 lines a warp)
        const int base = __ldg(L.lane_base + (ss * kWarps + warp) * 32 + lane);
        const int step = hub >= 0 ? 32 : 1;
#pragma unroll
        for (int jj = 0; jj < kJb; ++jj) {
#pragma unroll
          for (int e = 0; e < SC; ++e)
            p[jj][e] = __fmul_rn(
                rw, __shfl_sync(0xffffffffu, mine[e], (base + step * jj) % kBufRows));
        }
      }
    }
    mbar_wait(&full[s], round & 1);
    const int n = cnt - jb * kJb;  // this lane's items in the chunk (if > 0)
    if constexpr (OP == Op::kBuf) {
#pragma unroll
      for (int jj = 0; jj < kJb; ++jj) {
        if (jj % UNR == 0 && !__any_sync(0xffffffffu, jj < n)) break;
        const bool ok = jj < n;
#pragma unroll
        for (int e = 0; e < SC; ++e) sum[e] = ok ? __fadd_rn(sum[e], p[jj][e]) : sum[e];
      }
    } else {
      const uint16_t* sl =
          reinterpret_cast<const uint16_t*>(ring + s * kChunkBytes) + warp * 32 * kJb;
#pragma unroll 1
      for (int g = 0; g < kJb; g += UNR) {
        if (!__any_sync(0xffffffffu, g < n)) break;
        // every position of the chunk holds a slot (pads: 0), so the loads
        // need no branch; pads are masked out of the sums
        int slot[UNR];
        float x[UNR][SC];
#pragma unroll
        for (int q = 0; q < UNR; ++q) slot[q] = sl[(g + q) * 32 + lane];
#pragma unroll
        for (int q = 0; q < UNR; ++q)
          unpack<T>(*reinterpret_cast<const uint4*>(panel + slot[q] * kSlab), x[q]);
#pragma unroll
        for (int q = 0; q < UNR; ++q) {
          const bool ok = g + q < n;
          float val[SC];
#pragma unroll
          for (int e = 0; e < SC; ++e) val[e] = PIN ? __fmul_rn(table_scale, x[q][e]) : x[q][e];
          // the pin's column lies in this slab for few items
          const int diag = slot[q] - (int)col0;
          if (PIN && (unsigned)diag < (unsigned)SC) {
#pragma unroll
            for (int e = 0; e < SC; ++e)
              if (e == diag) val[e] = 1.f;
          }
#pragma unroll
          for (int e = 0; e < SC; ++e) {
            if (KAHAN) {
              // keeps long power-law rows at ~eps instead of O(d) eps
              const float y = __fsub_rn(__fmul_rn(val[e], rw), comp[e]);
              const float t = __fadd_rn(sum[e], y);
              const float cn = __fsub_rn(__fsub_rn(t, sum[e]), y);
              sum[e] = ok ? t : sum[e];
              comp[e] = ok ? cn : comp[e];
            } else if (OP == Op::kMax) {
              sum[e] = ok ? fmaxf(sum[e], val[e]) : sum[e];
            } else {
              sum[e] = ok ? __fadd_rn(sum[e], val[e]) : sum[e];
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&consumed[s]);
    if (++s == kStages) { s = 0; ++round; }

    if (jb < nch - 1) {
      ++jb;
      continue;
    }
    if (hub >= 0) {
      // warp per row: fold the lanes' sums in a fixed order, lane 0 keeps
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
#pragma unroll
        for (int e = 0; e < SC; ++e) {
          const float s2 = __shfl_down_sync(0xffffffffu, sum[e], off);
          if constexpr (KAHAN) {
            const float c2 = __shfl_down_sync(0xffffffffu, comp[e], off);
            if (lane < off) kahan_merge(sum[e], comp[e], s2, c2);
          } else if (lane < off) {
            sum[e] = OP == Op::kMax ? fmaxf(sum[e], s2) : __fadd_rn(sum[e], s2);
          }
        }
      }
      if (lane == 0) {
        float* h = L.hub_acc + (size_t)hub * (size_t)c + col0;
        const size_t half = (size_t)L.n_pieces * (size_t)c;
#pragma unroll
        for (int e = 0; e < SC; ++e) {
          if (col0 + e < c) {
            h[e] = sum[e];
            if (KAHAN) h[half + e] = comp[e];
          }
        }
      }
    } else if (row >= 0) {
      if (SCALE) {
#pragma unroll
        for (int e = 0; e < SC; ++e) sum[e] = __fmul_rn(sum[e], rw);
      }
      if (OP == Op::kMax && cnt == 0) {
        // a row with no items is 0, as the row tiles write it
#pragma unroll
        for (int e = 0; e < SC; ++e) sum[e] = 0.f;
      }
      if (col0 < c) store_slab<T>(out + (size_t)row * (size_t)c + col0, col0, c, vec_here, sum);
    }
    // on to the next super-slice
    ss = nx;
    jb = 0;
    row = nx_row;
    cnt = nx_cnt;
    hub = nx_hub;
    nch = nx_nch;
    rw = row >= 0 ? __ldg(L.row_w + row) : 0.f;
    nx = ss + 1 == L.n_ss ? 0 : ss + 1;
    nx_row = __ldg(L.lane_row + (nx * kWarps + warp) * 32 + lane);
    nx_cnt = __ldg(L.lane_cnt + (nx * kWarps + warp) * 32 + lane);
    nx_hub = __ldg(L.unit_hub + nx * kWarps + warp);
    nx_nch = __ldg(L.ss_chunks + nx);
  }
  gt::consumers_sync();
  hub_rows_out<T, KAHAN, SCALE, OP>(L, out, col0, c, vec_here);
}

template <typename T, bool KAHAN, bool PIN, int UNR, bool SCALE, Op OP = Op::kSum>
int launch_panel(const GtSell& L, const T* table, T* out, int64_t v, int64_t c,
                 float table_scale, cudaStream_t stream) {
  constexpr int SC = kSlab / sizeof(T);
  auto kernel = spmv_panel<T, KAHAN, PIN, UNR, SCALE, OP>;
  if (L.n_chunks <= 0 || L.n_ss <= 0 || (L.n_pieces > 0 && L.hub_acc == nullptr))
    return (int)cudaErrorInvalidValue;
  // X2 reads no panel, so it runs over a layout whose table does not fit one
  const int64_t panel = OP == Op::kBuf ? 0 : v * kSlab;
  const int64_t smem = kBarrierBytes + kStages * (int64_t)kChunkBytes + panel;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t slabs = (c + SC - 1) / SC;
  if (slabs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec = (c * (int64_t)sizeof(T)) % kSlab == 0 && (uintptr_t)table % kSlab == 0 &&
                  (uintptr_t)out % kSlab == 0;
  kernel<<<(unsigned)slabs, kBlock, (size_t)smem, stream>>>(L, table, out, v, c, table_scale,
                                                            vec);
  return (int)cudaGetLastError();
}

// the pin is a template argument: unpinned products issue none of its work;
// B1 keeps 8 items in flight, B2 8 at f32 and 4 at bf16 (8 columns each)
template <typename T, bool KAHAN>
int launch_panel_pin(const GtSell& L, const void* table, void* out, int64_t v, int64_t c,
                     int pin, float table_scale, cudaStream_t stream) {
  constexpr int UNR = sizeof(T) == 2 ? 4 : 8;
  const T* tb = static_cast<const T*>(table);
  T* ob = static_cast<T*>(out);
  if (pin) return launch_panel<T, KAHAN, true, UNR, !KAHAN>(L, tb, ob, v, c, table_scale, stream);
  return launch_panel<T, KAHAN, false, UNR, !KAHAN>(L, tb, ob, v, c, table_scale, stream);
}

// The packed-lane panel over a uniform K == 1 stream (kernels/spmm.py:
// PackedLayout).  The panel holds the slab of the layout's hot rows; a cold
// item reads its 16 bytes from the table (the warp's group waits for it),
// so the producer warp's lanes prefetch into L2 the slabs of each chunk's
// cold rows as the chunk's bulk copy is issued, a few chunks before the
// consumers reach them.  Each warp walks its units back to back, every lane
// flushing its segment at the unit's end: a row's slab (B2 scaled by the
// row's scale), or a piece's partial sums into hub_acc for hub_rows_out.
// B1 weighs each item by its lane's folded weight; UNR items' rows are
// read before they are summed.
constexpr int kPackCold = 0x4000;              // PACK_COLD: the entry holds a table row
constexpr int kPackRow = kPackCold - 1;        // the entry's panel index or table row
constexpr int kPackPrefetch = 256;             // cold rows of a chunk prefetched at most

// 16 bytes of table row r at col0 (columns >= c read as 0)
template <typename T>
__device__ __forceinline__ uint4 table_slab(const T* __restrict__ table, int r, int64_t col0,
                                            int64_t c, bool vec) {
  constexpr int SC = kSlab / sizeof(T);
  const T* src = table + (size_t)r * (size_t)c + col0;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(src));
  T tmp[SC];
#pragma unroll
  for (int e = 0; e < SC; ++e) {
    if (col0 + e < c) tmp[e] = src[e];
    else from_f32(0.f, tmp[e]);
  }
  uint4 q;
  memcpy(&q, tmp, kSlab);
  return q;
}

template <typename T, bool KAHAN, bool PIN, int UNR>
__global__ void __launch_bounds__(kBlock, 1)
spmv_packed(const GtPacked L, const T* __restrict__ table, T* __restrict__ out, int64_t v,
            int64_t c, float table_scale, int vec) {
  constexpr int SC = kSlab / sizeof(T);        // columns of the slab
  constexpr bool SCALE = !KAHAN;               // B2 scales each row at its flush
  static_assert(kJb % UNR == 0, "a chunk's j-block splits into whole groups");

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* consumed = full + kStages;
  unsigned char* ring = smem + kBarrierBytes;
  unsigned char* panel = ring + kStages * kChunkBytes;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t col0 = (int64_t)blockIdx.x * SC;
  const bool vec_here = vec && (col0 + SC <= c);

  gt::init_ring(full, consumed, kStages);
  if (warp == kWarps) {
    // producer: lane 0 copies each chunk into its stage once every consumer
    // warp is done with it; as it is issued, the lanes prefetch the chunk's
    // cold rows (read one chunk ahead: lane l holds rows l, l + 32, ...)
    constexpr int kPer = kPackPrefetch / 32;
    auto rows_of = [&](int64_t ch, int& n, int (&r)[kPer]) {
      const int beg = ch < L.n_chunks ? __ldg(L.cold_beg + ch) : 0;
      n = ch < L.n_chunks ? min(__ldg(L.cold_beg + ch + 1) - beg, kPackPrefetch) : 0;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int k = lane + 32 * i;
        r[i] = k < n ? __ldg(L.cold_rows + beg + k) : 0;
      }
    };
    int nx_cold, nx_rows[kPer];
    rows_of(0, nx_cold, nx_rows);
    int s = 0;
    uint32_t round = 0;
    for (int64_t ch = 0; ch < L.n_chunks; ++ch) {
      const int n_cold = nx_cold;
      int rows[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) rows[i] = nx_rows[i];
      rows_of(ch + 1, nx_cold, nx_rows);
      if (lane == 0) {
        if (round > 0) mbar_wait(&consumed[s], (round - 1) & 1);
        gt::mbar_expect_tx(&full[s], kChunkBytes);
        gt::bulk_copy(ring + s * kChunkBytes,
                      reinterpret_cast<const unsigned char*>(L.codes) + ch * (int64_t)kChunkBytes,
                      kChunkBytes, &full[s]);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int k = lane + 32 * i;
        if (k < n_cold)
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(table + (size_t)rows[i] * (size_t)c +
                                                         col0));
      }
      if (++s == kStages) { s = 0; ++round; }
    }
    return;
  }
  // the block's slab of every hot row into the panel, kCopyAhead row ids
  // read before their copies are issued
  constexpr int kCopyAhead = 8;
  for (int p0 = threadIdx.x; p0 < L.n_hot; p0 += kCopyAhead * kWarps * 32) {
    int r[kCopyAhead];
#pragma unroll
    for (int k = 0; k < kCopyAhead; ++k) {
      const int p = p0 + k * kWarps * 32;
      r[k] = p < L.n_hot ? __ldg(L.hot_rows + p) : 0;
    }
#pragma unroll
    for (int k = 0; k < kCopyAhead; ++k) {
      const int p = p0 + k * kWarps * 32;
      if (p >= L.n_hot) break;
      unsigned char* dst = panel + p * kSlab;
      if (vec_here) {
        gt::cp_async16(dst, table + (size_t)r[k] * (size_t)c + col0);
      } else {
        const uint4 q = table_slab<T>(table, r[k], col0, c, false);
        memcpy(dst, &q, kSlab);
      }
    }
  }
  // the pin: the entries of the table rows whose diagonal lies in this
  // slab (-1 past V); an item's entry is compared with them only where it
  // lies in their range [d_lo, d_lo + d_span]
  int dcode[SC];
  int d_lo = 0x7fffffff, d_hi = -1;
  if constexpr (PIN) {
#pragma unroll
    for (int e = 0; e < SC; ++e) {
      dcode[e] = col0 + e < v ? (int)__ldg(L.row_code + col0 + e) : -1;
      if (dcode[e] >= 0) {
        d_lo = min(d_lo, dcode[e]);
        d_hi = max(d_hi, dcode[e]);
      }
    }
  }
  const unsigned d_span = (unsigned)d_hi - (unsigned)d_lo;  // huge where none lies here
  gt::cp_async_wait_all();
  gt::consumers_sync();

  const int last = (int)L.n_hot - 1;              // the panel's last row
  const int ue = __ldg(L.warp_units + warp + 1);
  int u = __ldg(L.warp_units + warp);
  // this lane's segment in unit u (row, items, weight) and in unit u + 1
  int row = -1, cnt = 0, nx_row = -1, nx_cnt = 0;
  float w = 0.f, nx_w = 0.f;
  if (u < ue) {
    row = __ldg(L.lane_row + u * 32 + lane);
    cnt = __ldg(L.lane_cnt + u * 32 + lane);
    w = __ldg(L.lane_w + u * 32 + lane);
  }
  if (u + 1 < ue) {
    nx_row = __ldg(L.lane_row + (u + 1) * 32 + lane);
    nx_cnt = __ldg(L.lane_cnt + (u + 1) * 32 + lane);
    nx_w = __ldg(L.lane_w + (u + 1) * 32 + lane);
  }
  int len = __reduce_max_sync(0xffffffffu, cnt);  // the unit's positions
  int j = 0;                                       // this position's index in the unit
  float sum[SC], comp[SC];
#pragma unroll
  for (int e = 0; e < SC; ++e) sum[e] = comp[e] = 0.f;

  // the unit ends (at the same position in every lane): each lane flushes
  // its segment, then all take the next unit, whose successor is read now
  auto flush = [&]() {
    if (row >= 0) {
      if (SCALE) {
#pragma unroll
        for (int e = 0; e < SC; ++e) sum[e] = __fmul_rn(sum[e], w);
      }
      if (col0 < c)
        store_slab<T>(out + (size_t)row * (size_t)c + col0, col0, c, vec_here, sum);
    } else if (row < -1) {
      float* h = L.hub_acc + (size_t)(-2 - row) * (size_t)c + col0;
      const size_t half = (size_t)L.n_pieces * (size_t)c;
#pragma unroll
      for (int e = 0; e < SC; ++e) {
        if (col0 + e < c) {
          h[e] = sum[e];
          if (KAHAN) h[half + e] = comp[e];
        }
      }
    }
#pragma unroll
    for (int e = 0; e < SC; ++e) sum[e] = comp[e] = 0.f;
    ++u;
    row = nx_row;
    cnt = nx_cnt;
    w = nx_w;
    if (u + 1 < ue) {
      nx_row = __ldg(L.lane_row + (u + 1) * 32 + lane);
      nx_cnt = __ldg(L.lane_cnt + (u + 1) * 32 + lane);
      nx_w = __ldg(L.lane_w + (u + 1) * 32 + lane);
    }
    len = u < ue ? __reduce_max_sync(0xffffffffu, cnt) : 0;
    j = 0;
  };

  int s = 0;
  uint32_t round = 0;
  for (int64_t ch = 0; ch < L.n_chunks; ++ch) {
    mbar_wait(&full[s], round & 1);
    const uint16_t* sl =
        reinterpret_cast<const uint16_t*>(ring + s * kChunkBytes) + warp * 32 * kJb;
#pragma unroll 1
    for (int g = 0; g < kJb && u < ue; g += UNR) {
      int code[UNR];
      uint4 raw[UNR];
      int any = 0;
#pragma unroll
      for (int q = 0; q < UNR; ++q) {
        code[q] = sl[(g + q) * 32 + lane];
        any |= code[q];
      }
      // every entry reads the panel (a cold one its last row), all loads in
      // flight at once; the few cold ones are then read from the table
#pragma unroll
      for (int q = 0; q < UNR; ++q)
        raw[q] = *reinterpret_cast<const uint4*>(panel + min(code[q], last) * kSlab);
      if (__any_sync(0xffffffffu, any & kPackCold)) {
#pragma unroll
        for (int q = 0; q < UNR; ++q)
          if (code[q] & kPackCold)
            raw[q] = table_slab<T>(table, code[q] & kPackRow, col0, c, vec_here);
      }
      float x[UNR][SC];
#pragma unroll
      for (int q = 0; q < UNR; ++q) unpack<T>(raw[q], x[q]);

      // item q of the group into the sums (ok: the lane's segment has it)
      auto add = [&](int q, bool ok) {
        float val[SC];
#pragma unroll
        for (int e = 0; e < SC; ++e) val[e] = PIN ? __fmul_rn(table_scale, x[q][e]) : x[q][e];
        if (PIN && (unsigned)(code[q] - d_lo) <= d_span) {
#pragma unroll
          for (int e = 0; e < SC; ++e)
            if (code[q] == dcode[e]) val[e] = 1.f;
        }
#pragma unroll
        for (int e = 0; e < SC; ++e) {
          if (KAHAN) {
            const float y = __fsub_rn(__fmul_rn(val[e], w), comp[e]);
            const float t = __fadd_rn(sum[e], y);
            const float cn = __fsub_rn(__fsub_rn(t, sum[e]), y);
            sum[e] = ok ? t : sum[e];
            comp[e] = ok ? cn : comp[e];
          } else {
            sum[e] = ok ? __fadd_rn(sum[e], val[e]) : sum[e];
          }
        }
      };
      if (j + UNR <= len) {
        // no unit ends inside the group: the panel's straight-line sums
#pragma unroll
        for (int q = 0; q < UNR; ++q) add(q, j + q < cnt);
        j += UNR;
        if (j == len) flush();
      } else {
#pragma unroll
        for (int q = 0; q < UNR; ++q) {
          add(q, j < cnt);
          if (++j == len) flush();
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&consumed[s]);
    if (++s == kStages) { s = 0; ++round; }
  }
  gt::consumers_sync();
  hub_rows_out<T, KAHAN, SCALE, Op::kSum>(L, out, col0, c, vec_here);
  if (col0 < c) {
    const float zero[SC] = {};
    for (int64_t i = threadIdx.x; i < L.n_empty; i += kWarps * 32)
      store_slab<T>(out + (size_t)__ldg(L.empty_rows + i) * (size_t)c + col0, col0, c,
                    vec_here, zero);
  }
}

template <typename T, bool KAHAN>
int launch_packed(const GtPacked& L, const void* table, void* out, int64_t v, int64_t c,
                  int pin, float table_scale, cudaStream_t stream) {
  constexpr int SC = kSlab / sizeof(T);
  constexpr int UNR = sizeof(T) == 2 ? 4 : 8;  // as the column panel
  auto kernel = pin ? &spmv_packed<T, KAHAN, true, UNR> : &spmv_packed<T, KAHAN, false, UNR>;
  if (L.n_chunks <= 0 || L.n_hot <= 0 || L.n_hot > v || v > kPackCold ||
      (L.n_pieces > 0 && L.hub_acc == nullptr))
    return (int)cudaErrorInvalidValue;
  const int64_t smem = kBarrierBytes + kStages * (int64_t)kChunkBytes + L.n_hot * kSlab;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t slabs = (c + SC - 1) / SC;
  if (slabs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec = (c * (int64_t)sizeof(T)) % kSlab == 0 && (uintptr_t)table % kSlab == 0 &&
                  (uintptr_t)out % kSlab == 0;
  kernel<<<(unsigned)slabs, kBlock, (size_t)smem, stream>>>(
      L, static_cast<const T*>(table), static_cast<T*>(out), v, c, table_scale, vec);
  return (int)cudaGetLastError();
}

// L2 column tiles: a warp per (unit, tile of kTileCols f32 columns).  Units
// 0..V are the output rows (a hub row's unit does nothing), units V+1..
// the hub rows' pieces, whose (sum, compensation) partials go to P.acc for
// tiles_hub_merge.  Lane l owns the 16-byte vectors l and l + 32 of the
// tile, so each item's row is read as two coalesced 512-byte runs, and
// blocks run tile by tile (blockIdx.y), so the rows a tile reads come
// from L2.
constexpr int kTileWarps = 8;
constexpr int kTileCols = 256;
constexpr int kTileVecs = kTileCols / (32 * kCols);  // 16-byte vectors of a lane
constexpr int kTileLane = kTileVecs * kCols;         // columns of a lane
constexpr int kTileAhead = 4;                        // items loaded before summing

template <bool KAHAN>
__global__ void __launch_bounds__(kTileWarps * 32, 3)
spmv_tiles(const int32_t* __restrict__ slots, const float* __restrict__ wts,
           const float* __restrict__ scales, const int64_t* __restrict__ row_items,
           const GtTiles P, const float* __restrict__ table, float* __restrict__ out,
           int64_t v, int64_t c, int pin, float table_scale, int mul, int vec) {
  constexpr int F = kTileLane;
  const int lane = threadIdx.x % 32;
  const int64_t u = (int64_t)blockIdx.x * kTileWarps + threadIdx.x / 32;
  // vector k of this lane: columns col0 + 32 * kCols * k ..
  const int64_t col0 = (int64_t)blockIdx.y * kTileCols + (int64_t)lane * kCols;
  const bool weigh = KAHAN || mul;
  int64_t row, beg, end, piece = -1;
  if (u <= v) {
    row = u;
    beg = __ldg(row_items + u);
    end = __ldg(row_items + u + 1);
    if (end - beg > P.hub) return;             // its pieces take it
  } else if (u - (v + 1) < P.n_pieces) {
    piece = u - (v + 1);
    row = __ldg(P.piece_row + piece);
    beg = __ldg(P.piece_beg + piece);
    end = min(beg + P.hub, __ldg(row_items + row + 1));
  } else {
    return;
  }

  float sum[F], comp[F];
#pragma unroll
  for (int i = 0; i < F; ++i) sum[i] = comp[i] = 0.f;
  for (int64_t t0 = beg; t0 < end; t0 += kTileAhead) {
    const int n = (end - t0 < kTileAhead) ? (int)(end - t0) : kTileAhead;
    int s[kTileAhead];
    float w[kTileAhead], x[kTileAhead][F];
#pragma unroll
    for (int q = 0; q < kTileAhead; ++q) {
      if (q < n) {
        s[q] = __ldg(slots + t0 + q);
        w[q] = weigh ? __ldg(wts + t0 + q) : 1.f;
        const float* src = table + (size_t)s[q] * (size_t)c;
#pragma unroll
        for (int k = 0; k < kTileVecs; ++k)
          load_cols(src, col0 + 32 * kCols * k, c, vec != 0,
                    *reinterpret_cast<float(*)[kCols]>(&x[q][k * kCols]));
      }
    }
#pragma unroll
    for (int q = 0; q < kTileAhead; ++q) {
      if (q < n) {
#pragma unroll
        for (int i = 0; i < F; ++i) {
          float val = x[q][i];
          if (pin)
            val = (col0 + 32 * kCols * (i / kCols) + i % kCols == s[q])
                      ? 1.f : __fmul_rn(table_scale, val);
          if (weigh) val = __fmul_rn(val, w[q]);
          if (KAHAN) {
            // keeps long power-law rows at ~eps instead of O(d) eps
            const float y = __fsub_rn(val, comp[i]);
            const float t = __fadd_rn(sum[i], y);
            comp[i] = __fsub_rn(__fsub_rn(t, sum[i]), y);
            sum[i] = t;
          } else {
            sum[i] = __fadd_rn(sum[i], val);
          }
        }
      }
    }
  }
  if (piece >= 0) {
    float* acc = P.acc + (size_t)piece * (size_t)c;
    const size_t half = (size_t)P.n_pieces * (size_t)c;
#pragma unroll
    for (int i = 0; i < F; ++i) {
      const int64_t col = col0 + 32 * kCols * (i / kCols) + i % kCols;
      if (col < c) {
        acc[col] = sum[i];
        if (KAHAN) acc[half + col] = comp[i];
      }
    }
    return;
  }
  if (!KAHAN) {
    const float scale = (end > beg) ? __ldg(scales + beg) : 0.f;
#pragma unroll
    for (int i = 0; i < F; ++i) sum[i] = __fmul_rn(sum[i], scale);
  }
  float* dst = out + (size_t)row * (size_t)c;
#pragma unroll
  for (int k = 0; k < kTileVecs; ++k)
    store_cols(dst, col0 + 32 * kCols * k, c, vec != 0,
               *reinterpret_cast<const float(*)[kCols]>(&sum[k * kCols]));
}

// Each hub row's pieces joined in piece order (TwoSum for B1), B2's row
// scale applied, one thread per (hub row blockIdx.x, column).
template <bool KAHAN>
__global__ void __launch_bounds__(256)
tiles_hub_merge(const float* __restrict__ scales, const int64_t* __restrict__ row_items,
                const GtTiles P, float* __restrict__ out, int64_t c) {
  const int64_t col = (int64_t)blockIdx.y * 256 + threadIdx.x;
  if (col >= c) return;
  const int h = blockIdx.x;
  const int row = __ldg(P.hub_rows + h);
  const int q0 = __ldg(P.hub_piece + h), q1 = __ldg(P.hub_piece + h + 1);
  const size_t half = (size_t)P.n_pieces * (size_t)c;
  float s = P.acc[(size_t)q0 * c + col];
  float cp = KAHAN ? P.acc[half + (size_t)q0 * c + col] : 0.f;
  for (int q = q0 + 1; q < q1; ++q) {
    const float s2 = P.acc[(size_t)q * c + col];
    if (KAHAN) kahan_merge(s, cp, s2, P.acc[half + (size_t)q * c + col]);
    else s = __fadd_rn(s, s2);
  }
  if (!KAHAN) s = __fmul_rn(s, __ldg(scales + __ldg(row_items + row)));
  out[(size_t)row * (size_t)c + col] = s;
}

template <bool KAHAN>
int launch_tiles(const int32_t* slots, const float* wts, const float* scales,
                 const int64_t* row_items, const GtTiles& P, const float* table, float* out,
                 int64_t v, int64_t c, int pin, float table_scale, int mul,
                 cudaStream_t stream) {
  if (P.hub < 1 || (P.n_pieces > 0 && P.acc == nullptr) || (P.n_hub > 0) != (P.n_pieces > 0))
    return (int)cudaErrorInvalidValue;
  const int vec = c % kCols == 0 && (uintptr_t)table % kSlab == 0 && (uintptr_t)out % kSlab == 0;
  const int64_t tiles = (c + kTileCols - 1) / kTileCols;
  const int64_t blocks = (v + 1 + P.n_pieces + kTileWarps - 1) / kTileWarps;
  if (blocks > 0x7fffffffLL || tiles > 65535 || P.n_hub > 0x7fffffffLL ||
      (c + 255) / 256 > 65535)
    return (int)cudaErrorInvalidValue;
  spmv_tiles<KAHAN><<<dim3((unsigned)blocks, (unsigned)tiles), kTileWarps * 32, 0, stream>>>(
      slots, wts, scales, row_items, P, table, out, v, c, pin, table_scale, mul, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || P.n_hub == 0) return (int)e;
  tiles_hub_merge<KAHAN><<<dim3((unsigned)P.n_hub, (unsigned)((c + 255) / 256)), 256, 0,
                           stream>>>(scales, row_items, P, out, c);
  return (int)cudaGetLastError();
}

// the panel where the caller passes a layout (uniform seg-1 streams), else row tiles
template <typename T, bool KAHAN>
int launch(const int32_t* slots, const float* wts, const float* scales,
           const int64_t* row_items, const GtSell* sell, const void* table, void* out,
           int64_t v, int64_t c, int seg_k, int pin, float table_scale, int mul,
           cudaStream_t stream) {
  if (v < 0 || c <= 0) return (int)cudaGetLastError();
  if (sell == nullptr)
    return launch_rows<T, KAHAN>(slots, wts, scales, row_items, table, out, v + 1, c, seg_k,
                                 pin, table_scale, mul, stream);
  if (seg_k != 1 || mul) return (int)cudaErrorInvalidValue;
  return launch_panel_pin<T, KAHAN>(*sell, table, out, v, c, pin, table_scale, stream);
}

}  // namespace

// X1 on the panel: B2's reads, walk and 8 items in flight, a max for the add.
int sell_max_f32(const GtSell& L, const float* table, float* out, int64_t v, int64_t c,
                 cudaStream_t stream) {
  if (v < 0 || c <= 0) return (int)cudaGetLastError();
  return launch_panel<float, false, false, 8, false, Op::kMax>(L, table, out, v, c, 0.f, stream);
}

// X2 on the panel: B2's launch shape, shared memory, ring and walk; each item
// adds row_w[row] * buf[t mod 16] from registers.
int sell_buffer_sums_f32(const GtSell& L, const float* buf, float* out, int64_t v, int64_t c,
                         cudaStream_t stream) {
  if (v < 0 || c <= 0) return (int)cudaGetLastError();
  if (L.lane_base == nullptr) return (int)cudaErrorInvalidValue;
  return launch_panel<float, false, false, 4, false, Op::kBuf>(L, buf, out, v, c, 0.f, stream);
}

// X3 on the panel: B2 with twice its items in flight (16 at f32), no row scale.
int sell_raw_sums_f32(const GtSell& L, const float* table, float* out, int64_t v, int64_t c,
                      cudaStream_t stream) {
  if (v < 0 || c <= 0) return (int)cudaGetLastError();
  return launch_panel<float, false, false, 16, false>(L, table, out, v, c, 0.f, stream);
}

extern "C" {

// B1: out[V+1, C] f32 = Kahan row sums of folded-weight items; `sell` is the
// stream's sliced layout (the panel) or null (row tiles).
int gt_spmv_kahan_f32(const int32_t* slots, const float* wts, const int64_t* row_items,
                      const GtSell* sell, const float* table, float* out, int64_t v, int64_t c,
                      int seg_k, int pin, float table_scale, cudaStream_t stream) {
  return launch<float, true>(slots, wts, nullptr, row_items, sell, table, out, v, c, seg_k, pin,
                             table_scale, 0, stream);
}

// B2: out[V+1, C] in the table's dtype (f32, or bf16 when bf16 != 0) =
// plain f32 row sums of raw-weight items (unweighted when mul == 0) times
// the row's first-item scale; `sell` as for B1 (the panel takes mul == 0).
int gt_spmv_fast(const int32_t* slots, const float* raw_wts, const float* scales,
                 const int64_t* row_items, const GtSell* sell, const void* table, void* out,
                 int64_t v, int64_t c, int seg_k, int pin, float table_scale, int mul, int bf16,
                 cudaStream_t stream) {
  if (bf16)
    return launch<__nv_bfloat16, false>(slots, raw_wts, scales, row_items, sell, table, out, v,
                                        c, seg_k, pin, table_scale, mul, stream);
  return launch<float, false>(slots, raw_wts, scales, row_items, sell, table, out, v, c, seg_k,
                              pin, table_scale, mul, stream);
}

// B1 (kahan != 0, f32) or B2 (f32, or bf16 when bf16 != 0) over a uniform
// seg-1 stream as the packed-lane panel over its layout `packed`: the same
// output as gt_spmv_kahan_f32 and gt_spmv_fast.
int gt_spmv_packed(const GtPacked* packed, const void* table, void* out, int64_t v, int64_t c,
                   int kahan, int pin, float table_scale, int bf16, cudaStream_t stream) {
  if (v < 0 || c <= 0) return (int)cudaGetLastError();
  if (packed == nullptr || (kahan && bf16)) return (int)cudaErrorInvalidValue;
  if (kahan) return launch_packed<float, true>(*packed, table, out, v, c, pin, table_scale, stream);
  if (bf16)
    return launch_packed<__nv_bfloat16, false>(*packed, table, out, v, c, pin, table_scale,
                                               stream);
  return launch_packed<float, false>(*packed, table, out, v, c, pin, table_scale, stream);
}

// B1 (kahan != 0) or B2 over a seg-1 stream as L2 column tiles over `plan`,
// f32 table and output: the same output as the entry points above, from
// the same stream arguments.
int gt_spmv_tiles(const int32_t* slots, const float* wts, const float* scales,
                  const int64_t* row_items, const GtTiles* plan, const float* table, float* out,
                  int64_t v, int64_t c, int pin, float table_scale, int mul, int kahan,
                  cudaStream_t stream) {
  if (v < 0 || c <= 0) return (int)cudaGetLastError();
  if (plan == nullptr) return (int)cudaErrorInvalidValue;
  if (kahan)
    return launch_tiles<true>(slots, wts, nullptr, row_items, *plan, table, out, v, c, pin,
                              table_scale, 0, stream);
  return launch_tiles<false>(slots, wts, scales, row_items, *plan, table, out, v, c, pin,
                             table_scale, mul, stream);
}

const char* gt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
