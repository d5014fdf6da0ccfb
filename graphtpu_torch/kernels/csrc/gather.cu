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
// the Pallas kernel, so the f32 result is bit-equal to both.  The table is
// f32 or bf16 (widened on load), row-major with a row stride `ld` so a
// column block of a wider table needs no copy; the output is f32 with its
// own row stride, so the last level can write straight into a column block
// of the caller's [V, C] result.  Between two levels of one product an f32
// table may instead be slab-major, [ceil(C/4)][R][4] with R = ld rows a
// slab: the 16 bytes of columns 4s..4s+3 of row r at ((s * R) + r) * 4
// (tree_spmm's intermediate, which the panel below stores).
//
// What bounds it on this card: at level 0 of the blog-shaped tree (87,002
// mini-rows of W = 8 random slots over a 10,496-row table, a 4,096-column
// block) the function needs 1.60 GB (the table once, the [M, C] f32 output,
// the plan), 0.48 ms at 3.35 TB/s; but a design that reads each slot's row
// from L2 reads 11.4 GB of rows, ~66 times the table, and is held to the
// rate at which L2 serves 16-byte requests (~5.5 TB/s on an H100 SXM at
// 700 W; PERF.md).  Two designs behind one launch, chosen by the caller
// (kernels/spmm.py:tree_spmm):
//
// The column panel (gather_panel), where the caller passes the level's
// compact plan (kernels/spmm.py:build_gather_layout): W <= 8, one weight
// per mini-row (every unweighted level, every deeper level and the last
// one's 1/sum-w; weighted level 0 keeps the row tiles), and a 16-byte slab
// of the table's N rows that fits one block's shared memory beside the
// plan's ring (spmm.gather_fits: N <= 12,504 at W = 8; blog level 0 with
// N = 10,240, not R-MAT's 16,384 nor the deeper levels' 15,475 and more).
// Block b owns a slab of 16 bytes of every table row (4 f32 or 8 bf16
// columns) and copies table[0:N, slab] into shared memory once; then each
// lane of its 16 consumer warps takes one mini-row, reads its <= W slot
// rows from the panel and stores its 16 bytes (32 for bf16) of row m.
// No state crosses blocks and there are no atomics.  The plan is read,
// not the [M, W] int32 slots and f32 weights (64 bytes a mini-row, re-read
// by every one of the C/4 slab blocks): 16-bit slots in warp-transposed
// chunks of 512 mini-rows (a warp's 32 reads of one j hit 32 consecutive
// slots), a count of valid slots and one weight per mini-row, through a
// ring of three shared-memory stages fed by bulk copies (TMA) from a
// producer warp (csrc/panel.cuh).  A lane stops at its count: the trailing
// weight-0 pad slots are not read.  A skipped pad would add x * 0 = +-0,
// which leaves a finite sum unchanged (and +0 == -0), so the result equals
// the row tiles' and the plain version's; a table holding inf or NaN in
// row 0 would differ.
//
// The panel's output is slab-major, with ldo rows a slab: a block holds 16
// bytes of each row, and into a row-major output each lane would store 16
// bytes to its own row, 32 rows a warp; those stores set the pace (on an
// H100 at blog level 0: 3.43 ms a level storing rows against 1.26 ms
// storing slabs; PERF.md).  In a slab, a block's 512 mini-rows of a chunk
// are 8 KB of contiguous memory, and the next level's row tiles read it:
// a deeper level's mini-row sums 8 consecutive rows of the level before,
// which in a slab are 128 contiguous bytes.  So the panel runs a level
// below the last, never the last, which writes the caller's rows.
//
// Row tiles (gather_rows), for every other level: one block of 256
// threads covers a tile of 1,024 columns (4 consecutive columns per
// thread, 16-byte loads when the stride and offset allow) for kRows
// mini-rows, and each thread keeps up to kAhead = 8 slot rows' loads in
// flight before it accumulates them; weight-0 pad slots are read and added
// like every other slot.  The grid's x dimension walks mini-rows and y
// walks column tiles, so the blocks of one tile are issued before the next
// tile's: a 1,024-column tile of a level's table can stay in the 50 MB L2
// while its mini-rows run.  Deeper levels read each table row about once,
// nearly in order.  Slot offsets (slot * ld) are 64-bit.
//
// The entry point launches on the given stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() or the launch's own error.

#include "cols.cuh"
#include "panel.cuh"

// A level's compact plan (kernels/spmm.py:GatherLayout).  Chunk k holds
// mini-rows 512k .. 512k + 511; mini-row 512k + 32u + l is lane l of warp u.
// In a chunk: uint16 slots [16][W][32] (warp, j, lane), then the f32
// weight of each mini-row [512], then uint8 counts [512]; chunk_bytes(W)
// bytes in all.  Slots at j >= count are 0, and no lane reads them.
struct GtGather {
  const unsigned char* chunks;  // [n_chunks * chunk_bytes]
  int64_t n_chunks;
  int64_t n_table;              // table rows the panel holds (every slot is below)
};

namespace {

using gt::kCols;
using gt::kThreads;
using gt::kTile;
using gt::load_cols;
using gt::store_cols;

constexpr int kRows = 8;    // mini-rows per block (row tiles)
constexpr int kAhead = 8;   // slot rows loaded before accumulating (row tiles)

// the kCols columns [col, col + kCols) of row r of a row-major (stride ld)
// or slab-major (ld rows a slab) table, for load_cols / store_cols at
// offset 0 with c - col columns left
template <typename P>
__device__ __forceinline__ P* at(P* base, int64_t r, int64_t col, int64_t ld, bool slabs) {
  return slabs ? base + ((col / kCols) * ld + r) * kCols : base + r * ld + col;
}

// SLABS: the table is slab-major (a template argument, so row-major tables
// run the same code as without it)
template <typename T, bool SLABS>
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
          if (SLABS)
            load_cols(at(table, sr[j0 + u], col0, ld, true), 0, c - col0, vin != 0, x[u]);
          else
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
int launch_rows(const int32_t* slots, const float* wts, const void* table, int64_t ld,
                int in_slabs, float* out, int64_t ldo, int64_t m, int w, int64_t c,
                cudaStream_t stream) {
  const int64_t tiles = (c + kTile - 1) / kTile;
  const int64_t groups = (m + kRows - 1) / kRows;
  if (groups > 0x7fffffffLL || tiles > 65535) return (int)cudaErrorInvalidValue;
  // vector access needs every row start and the ragged width on a
  // kCols-element boundary, and the base pointers aligned to the access;
  // a slab-major table is 16-byte units throughout
  const int vin = ((ld % kCols == 0 && c % kCols == 0) || in_slabs) &&
                  ((uintptr_t)table % (sizeof(T) * kCols) == 0);
  const int vout = (ldo % kCols == 0) && (c % kCols == 0) &&
                   ((uintptr_t)out % (sizeof(float) * kCols) == 0);
  const dim3 grid((unsigned)groups, (unsigned)tiles);
  const T* tb = static_cast<const T*>(table);
  if constexpr (sizeof(T) == sizeof(float)) {  // slab-major tables are f32
    if (in_slabs) {
      gather_rows<T, true><<<grid, kThreads, 0, stream>>>(slots, wts, tb, ld, out, ldo, m, w,
                                                          c, vin, vout);
      return (int)cudaGetLastError();
    }
  }
  gather_rows<T, false><<<grid, kThreads, 0, stream>>>(slots, wts, tb, ld, out, ldo, m, w, c,
                                                       vin, vout);
  return (int)cudaGetLastError();
}

using gt::kBarrierBytes;
using gt::kSlab;
using gt::kSmemMax;
using gt::mbar_arrive;
using gt::mbar_wait;
using gt::unpack;

constexpr int kWarps = gt::kPanelWarps;
constexpr int kChunkRows = kWarps * 32;  // mini-rows per chunk (GATHER_CHUNK_ROWS)
constexpr int kMaxW = 8;                 // widest mini-row the panel takes
constexpr int kStages = 3;               // ring stages (GATHER_STAGES)

__host__ __device__ constexpr uint32_t chunk_bytes(int w) {
  return (uint32_t)kChunkRows * (2u * w + 4u + 1u);
}

// The column panel over a level's compact plan: lane l of warp u sums
// mini-row 512k + 32u + l of chunk k over its count of slots, in j order.
template <typename T>
__global__ void __launch_bounds__(gt::kPanelBlock, 1)
gather_panel(const GtGather L, int w, const T* __restrict__ table, int64_t ld, int in_slabs,
             float* __restrict__ out, int64_t ldo, int64_t m, int64_t c, int vin) {
  constexpr int SC = kSlab / sizeof(T);   // columns of the slab
  const uint32_t cb = chunk_bytes(w);

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // stage holds a chunk
  uint64_t* consumed = full + kStages;                   // the consumer warps are done
  unsigned char* ring = smem + kBarrierBytes;
  unsigned char* panel = ring + kStages * cb;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t col0 = (int64_t)blockIdx.x * SC;

  gt::init_ring(full, consumed, kStages);
  if (warp == kWarps) {
    // producer: one thread feeds the ring
    if (lane == 0) gt::produce<kStages>(ring, L.chunks, L.n_chunks, cb, cb, full, consumed);
    return;
  }

  // the block's slab of every table row into the panel
  const bool vin_here = vin && col0 + SC <= c;
  for (int64_t r = threadIdx.x; r < L.n_table; r += kWarps * 32) {
    const T* src = at(table, r, col0, ld, in_slabs != 0);
    unsigned char* dst = panel + r * kSlab;
    if (vin_here) {
      gt::cp_async16(dst, src);
    } else if (col0 < c) {
      T tmp[SC];
#pragma unroll
      for (int e = 0; e < SC; ++e) {
        if (col0 + e < c) tmp[e] = src[e];
        else gt::from_f32(0.f, tmp[e]);
      }
      memcpy(dst, tmp, kSlab);
    }
  }
  gt::cp_async_wait_all();
  gt::consumers_sync();

  int s = 0;
  uint32_t round = 0;
  for (int64_t ch = 0; ch < L.n_chunks; ++ch) {
    mbar_wait(&full[s], round & 1);
    // this lane's plan: slots, weight and count, out of the ring stage
    const unsigned char* base = ring + (size_t)s * cb;
    const uint16_t* sl = reinterpret_cast<const uint16_t*>(base) + warp * w * 32 + lane;
    const float wr = reinterpret_cast<const float*>(base + kChunkRows * 2 * w)[warp * 32 + lane];
    const int cnt = base[cb - kChunkRows + warp * 32 + lane];
    int slot[kMaxW];
#pragma unroll
    for (int j = 0; j < kMaxW; ++j) slot[j] = j < cnt ? sl[j * 32] : 0;
    // its slot rows out of the panel, all loads before the sum
    uint4 q[kMaxW];
#pragma unroll
    for (int j = 0; j < kMaxW; ++j)
      if (j < cnt) q[j] = *reinterpret_cast<const uint4*>(panel + slot[j] * kSlab);
    float acc[SC];
#pragma unroll
    for (int e = 0; e < SC; ++e) acc[e] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxW; ++j) {
      if (j < cnt) {
        float x[SC];
        unpack<T>(q[j], x);
#pragma unroll
        for (int e = 0; e < SC; ++e) {
          const float p = __fmul_rn(x[e], wr);
          acc[e] = (j == 0) ? p : __fadd_rn(acc[e], p);
        }
      }
    }
    // the stage is released only after the sums: arriving once the plan
    // was in registers let the producer overwrite it under slower lanes
    __syncwarp();
    if (lane == 0) mbar_arrive(&consumed[s]);
    if (++s == kStages) { s = 0; ++round; }

    const int64_t row = ch * kChunkRows + warp * 32 + lane;
    if (row < m && col0 < c) {
#pragma unroll
      for (int h = 0; h < SC; h += kCols) {
        const float a4[kCols] = {acc[h], acc[h + 1], acc[h + 2], acc[h + 3]};
        store_cols(at(out, row, col0 + h, ldo, true), 0, c - col0 - h, true, a4);
      }
    }
  }
}

template <typename T>
int launch_panel(const GtGather& L, int w, const void* table, int64_t ld, int in_slabs,
                 float* out, int64_t ldo, int64_t m, int64_t c, cudaStream_t stream) {
  constexpr int SC = kSlab / sizeof(T);
  auto kernel = gather_panel<T>;
  if (w > kMaxW || L.n_chunks <= 0 || L.n_table <= 0 || m > L.n_chunks * kChunkRows ||
      ldo < m || (uintptr_t)out % kSlab != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = kBarrierBytes + kStages * (int64_t)chunk_bytes(w) + L.n_table * kSlab;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t slabs = (c + SC - 1) / SC;
  if (slabs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // 16-byte copies need every row start (or slab) 16-byte aligned; the
  // slab-major output is 16-byte units throughout
  const int vin = (in_slabs || (ld * (int64_t)sizeof(T)) % kSlab == 0) &&
                  (uintptr_t)table % kSlab == 0;
  kernel<<<(unsigned)slabs, gt::kPanelBlock, (size_t)smem, stream>>>(
      L, w, static_cast<const T*>(table), ld, in_slabs, out, ldo, m, c, vin);
  return (int)cudaGetLastError();
}

// the panel (slab-major output) where the caller passes a compact plan,
// else row tiles (row-major output)
template <typename T>
int launch(const int32_t* slots, const float* wts, const void* table, int64_t ld, int in_slabs,
           float* out, int64_t ldo, int64_t m, int w, int64_t c, const GtGather* layout,
           cudaStream_t stream) {
  if (m <= 0 || c <= 0) return (int)cudaGetLastError();
  if (w <= 0 || (!in_slabs && ld < c) || (in_slabs && sizeof(T) != sizeof(float)))
    return (int)cudaErrorInvalidValue;
  if (layout != nullptr)
    return launch_panel<T>(*layout, w, table, ld, in_slabs, out, ldo, m, c, stream);
  if (ldo < c) return (int)cudaErrorInvalidValue;
  return launch_rows<T>(slots, wts, table, ld, in_slabs, out, ldo, m, w, c, stream);
}

}  // namespace

extern "C" {

// B3: out[m, :C] (f32) = sum_j wts[m, j] * table[slots[m, j], :C] for m < M;
// slots and wts are [M, W] row-major; the table is f32, or bf16 when
// bf16 != 0, row-major with row stride ld, or (f32, in_slabs) slab-major
// with ld rows a slab.  `layout` is the level's compact plan (the column
// panel; slots and wts are then not read, and out is slab-major with ldo
// >= M rows a slab) or null (row tiles; out is row-major with row stride
// ldo).
int gt_gather_rows_sum(const int32_t* slots, const float* wts, const void* table,
                       int64_t ld, int in_slabs, float* out, int64_t ldo, int64_t m, int w,
                       int64_t c, int bf16, const GtGather* layout, cudaStream_t stream) {
  if (bf16)
    return launch<__nv_bfloat16>(slots, wts, table, ld, in_slabs, out, ldo, m, w, c, layout,
                                 stream);
  return launch<float>(slots, wts, table, ld, in_slabs, out, ldo, m, w, c, layout, stream);
}

}  // extern "C"
