// A transpose of a row-major 2-D tensor into a new one, on Hopper (sm_90a).
//
// Replaces no TPU kernel.  graphtpu's exact SimRank leaves the transpose
// between an iteration's two products to XLA (graphtpu/simrank/exact.py:
// 154-169, where a Pallas transpose was tried and left out), so nothing in
// the JAX package stands behind this file.  It takes the place of
// `x.t().contiguous()` in simrank/exact.py:exact_simrank_spmm, which
// PyTorch runs as a strided copy that reads down columns: ~1 TB/s at
// V = 32,768 on an H100, 8.7 ms an iteration.
//
// What it computes: out[j, i] = in[i, j] for i < R, j < C, with `in`
// row-major [R, C] and `out` row-major [C, R]; elements of 4 bytes (f32)
// or 2 (bf16), moved as bits, so the result equals the plain version's.
//
// What bounds it on this card: bytes.  It reads R·C·e bytes and writes as
// many, each once: at R = C = 32,768 in f32 8.59 GB, 2.56 ms at 3.35 TB/s.
// A device-to-device copy of the same bytes is the yardstick of what the
// card reaches (chip_smoke.py times both; PERF.md).
//
// The design.  A block of 256 threads moves one square tile of S x S
// elements, S = 16 · (16 / e): 64 x 64 in f32 (16 KB), 128 x 128 in bf16
// (32 KB).  A tile row is 16 chunks of 16 bytes, and the tile's rows are
// 16 groups of V = 16 / e rows (4 in f32, 8 in bf16).  Thread t takes
// chunk c = t % 16 of the V rows of group g = t / 16:
//   1. V 16-byte loads, one from each of its rows (a warp reads two runs of
//      256 contiguous bytes a load), all issued before the first is used:
//      16 KB (f32) or 32 KB (bf16) in flight a block; the registers (38 a
//      thread in f32, 66 in bf16) let 6 or 3 blocks share an SM, ~96 KB;
//   2. a V x V transpose in registers (bf16 pairs joined by __byte_perm),
//      which turns the V input rows' chunk c into V rows of the transposed
//      tile, rows V·c .. V·c + V-1, each 16 bytes at chunk g;
//   3. V 16-byte stores of those into the shared tile, then one barrier;
//   4. V 16-byte reads of the transposed tile row by row and V 16-byte
//      stores to `out` (again two runs of 256 contiguous bytes a warp).
// Shared memory moves only 16-byte accesses, which a quarter-warp serves
// at once when its 8 chunks lie in 8 distinct groups of 4 banks.  A row of
// the shared tile is 256 bytes, so chunk k of row r is stored at chunk
// k ^ ((r / V) % 8) of that row: in step 3 the 8 threads of a quarter-warp
// write chunk g of rows V·c + j for 8 consecutive c, which the swizzle
// spreads over 8 bank groups, and in step 4 they read 8 consecutive chunks
// of one row, which an XOR with one value keeps distinct.  No padding, so
// every shared access stays 16-byte aligned.
//
// The order of the blocks is a raster over the tiles, row of tiles by row
// of tiles.  At V = 32,768 a row is 128 KB, a power of two, so the blocks
// in flight write 256 bytes at one offset of many rows of `out`: the risk
// of sending them all down a few memory channels (partition camping).  On
// an H100 it does not show: orders that walk 4 to 512 tile rows down
// before moving right, so that the blocks in flight cover a near-square
// patch, timed from 0.6% faster to 2.3% slower than the raster at V =
// 32,768, f32 and bf16 (PERF.md), so the kernel keeps the raster.
//
// Ragged edges: where R, C and both pointers are multiples of 16 bytes'
// worth, a 16-byte chunk lies wholly inside or wholly outside the tensor
// and is masked as a whole; otherwise the same kernel loads and stores
// element by element, each masked (the `vec` flag).  Offsets are 64-bit.
//
// The entry point launches on the given stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() or the launch's own error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunks = 16;  // 16-byte chunks in a tile row; row groups in a tile

template <int E>
struct TileShape {
  static constexpr int kVec = 16 / E;          // elements in a chunk, rows in a group
  static constexpr int kSide = kChunks * kVec;  // S: 64 (f32) or 128 (bf16)
};

// Word p of the transposed chunk j: the elements of column j in rows
// 2p, 2p + 1 (bf16) or row p (f32) of a thread's V x 16-byte block.
template <int E>
__device__ __forceinline__ unsigned transposed_word(const unsigned (&w)[16 / E][4], int j, int p);

template <>
__device__ __forceinline__ unsigned transposed_word<4>(const unsigned (&w)[4][4], int j, int p) {
  return w[p][j];
}

template <>
__device__ __forceinline__ unsigned transposed_word<2>(const unsigned (&w)[8][4], int j, int p) {
  // element j of a row is half (j & 1) of its word j / 2; the low half of
  // the result comes from row 2p, the high half from row 2p + 1
  return __byte_perm(w[2 * p][j >> 1], w[2 * p + 1][j >> 1], (j & 1) ? 0x7632 : 0x5410);
}

// The shared-tile chunk where chunk k of transposed row r is kept.
template <int E>
__device__ __forceinline__ int smem_chunk(int r, int k) {
  return r * kChunks + (k ^ ((r / TileShape<E>::kVec) & 7));
}

template <int E>
__device__ __forceinline__ unsigned get_elem(const unsigned (&w)[4], int e) {
  if constexpr (E == 4) return w[e];
  else return (w[e >> 1] >> (16 * (e & 1))) & 0xffffu;
}

template <int E>
__device__ __forceinline__ void set_elem(unsigned (&w)[4], int e, unsigned x) {
  if constexpr (E == 4) {
    w[e] = x;
  } else {
    const int s = 16 * (e & 1);
    w[e >> 1] = (w[e >> 1] & ~(0xffffu << s)) | (x << s);
  }
}

template <int E>
__device__ __forceinline__ unsigned load_elem(const unsigned char* p) {
  if constexpr (E == 4) return __ldg(reinterpret_cast<const unsigned*>(p));
  else return __ldg(reinterpret_cast<const unsigned short*>(p));
}

template <int E>
__device__ __forceinline__ void store_elem(unsigned char* p, unsigned x) {
  if constexpr (E == 4) {
    *reinterpret_cast<unsigned*>(p) = x;
  } else {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)x;
  }
}

template <int E>
__global__ void __launch_bounds__(kThreads)
transpose_tiles(const unsigned char* __restrict__ in, unsigned char* __restrict__ out,
                int64_t rows, int64_t cols, int64_t tile_cols, bool vec) {
  constexpr int V = TileShape<E>::kVec;
  constexpr int S = TileShape<E>::kSide;
  __shared__ uint4 tile[S * kChunks];

  const int64_t row0 = (blockIdx.x / tile_cols) * S;
  const int64_t col0 = (blockIdx.x % tile_cols) * S;

  const int t = threadIdx.x;
  const int c = t % kChunks;  // chunk of the input rows
  const int g = t / kChunks;  // group of V input rows

  // 1. V 16-byte chunks: rows row0 + V·g + k, columns col0 + V·c ..
  unsigned w[V][4];
  const int64_t col = col0 + (int64_t)V * c;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int64_t row = row0 + (int64_t)V * g + k;
    const unsigned char* src = in + (row * cols + col) * E;
    if (vec) {
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (row < rows && col < cols) q = __ldg(reinterpret_cast<const uint4*>(src));
      w[k][0] = q.x; w[k][1] = q.y; w[k][2] = q.z; w[k][3] = q.w;
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m) w[k][m] = 0u;
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (row < rows && col + e < cols) set_elem<E>(w[k], e, load_elem<E>(src + e * E));
    }
  }

  // 2-3. transposed row V·c + j of the tile holds chunk g
#pragma unroll
  for (int j = 0; j < V; ++j) {
    tile[smem_chunk<E>(V * c + j, g)] =
        make_uint4(transposed_word<E>(w, j, 0), transposed_word<E>(w, j, 1),
                   transposed_word<E>(w, j, 2), transposed_word<E>(w, j, 3));
  }
  __syncthreads();

  // 4. the tile's S rows, 16 chunks each, V chunks a thread
#pragma unroll
  for (int m = 0; m < V; ++m) {
    const int idx = t + kThreads * m;
    const int r = idx / kChunks;
    const int k = idx % kChunks;
    const int64_t orow = col0 + r;                   // a column of `in`
    const int64_t ocol = row0 + (int64_t)V * k;      // rows of `in`
    if (orow >= cols) continue;
    const uint4 q = tile[smem_chunk<E>(r, k)];
    unsigned char* dst = out + (orow * rows + ocol) * E;
    if (vec) {
      if (ocol < rows) *reinterpret_cast<uint4*>(dst) = q;
    } else {
      const unsigned ow[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (ocol + e < rows) store_elem<E>(dst + e * E, get_elem<E>(ow, e));
    }
  }
}

template <int E>
int launch(const void* in, void* out, int64_t rows, int64_t cols, cudaStream_t stream) {
  constexpr int V = TileShape<E>::kVec;
  constexpr int S = TileShape<E>::kSide;
  const int64_t tile_rows = (rows + S - 1) / S;
  const int64_t tile_cols = (cols + S - 1) / S;
  const int64_t blocks = tile_rows * tile_cols;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = rows % V == 0 && cols % V == 0 &&
                   reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  transpose_tiles<E><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const unsigned char*>(in), static_cast<unsigned char*>(out), rows, cols,
      tile_cols, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out [cols, rows] = in [rows, cols] transposed, both row-major, elements
// of `elem_bytes` (4 or 2) bytes.
int gt_transpose_2d(const void* in, void* out, int64_t rows, int64_t cols, int elem_bytes,
                    void* stream) {
  if (rows < 0 || cols < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) return launch<4>(in, out, rows, cols, s);
  if (elem_bytes == 2) return launch<2>(in, out, rows, cols, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
